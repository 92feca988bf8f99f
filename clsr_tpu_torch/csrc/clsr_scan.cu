// K2: the three-cell CLSR recurrence, forward and backward, CUDA C++ for
// sm_90a.
//
// Forward: replaces the TPU kernel clsr_tpu/ops/pallas_scan.py:_kernel
// (driven by _pallas_forward there).  All L steps of three recurrences over
// one history, with the input projections hoisted out by the caller (and
// the candidate biases folded into xc1/xc2):
//
//   interest-evolve GRU (carry h1, U wide, h1_0 = user_short)
//   Time4LSTM          (carries c, m, H wide; forget bias +1, time gates)
//   causal2 GRU        (carry h2, H wide)
//
// with masked carry-through x = mt·x_new + (1-mt)·x.  Outputs: mt·m_new per
// step [B, L, H], the final h1 [B, U] and h2 [B, H], and, when the caller
// asks for them, each step's input carry h1 | c | m | h2 [B, L, U+3H] for
// the backward.  The math is that of pallas_scan.py:69-108, line by line.
//
// Backward: replaces the VJP of the TPU kernel's custom_vjp
// (pallas_scan.py:243, jax.vjp of _scan_reference), in the shape of the
// JAX package's hand-written backward _bd_scan (clsr_tpu/ops/
// fused_clsr.py:114-141): from the saved carries it walks the steps in
// reverse, recomputes each step's forward, and carries the adjoint
// (dh1, dc, dm, dh2) back.  It writes the cotangents of xg1, xc1, xw, tn,
// tl, ot, xg2, xc2 and user_short, and each step's r1·h1 | r2·h2 (Zc), from
// which the caller's five weight products follow.
//
// What bounds both on an H100: neither bytes (the backward moves ~1,240
// floats a row and step, ~99 MB at B = 400, L = 50: 0.03 ms of HBM time)
// nor operations (~16,000 multiply-adds a row and step forward, twice
// that backward) but the L dependent steps: each step needs the whole
// carry of the one before.
//
// The forward is built for the least time per dependent step.  Its chain
// is, per step, two dependent K-term products in each GRU (the gates from
// h, then the candidate from r∘h) and one in the Time4LSTM (its four gates
// from m), each closed by exact expf/tanhf.  So:
// - the three cells run in blocks of their own (a grid of 3 x row groups):
//   they share nothing but the mask, so no cell waits on another's phase,
//   the Time4LSTM takes one block barrier a step (m double-buffered) and a
//   GRU two (r∘h, then h), and the grid is three times the row groups;
// - a block walks R rows (1 or 4; the wrapper picks the fewest that put
//   every row group on an SM of its own, so B = 400 is one wave of 300
//   blocks, three an SM at most by the launch bounds; R = 2 was never the
//   fastest at any B measured) and has 4 lanes per
//   unit j of its cell: lane q takes the terms k = q, q+4, ... of every
//   product of unit j, for all R rows.  Each weight sits in a register of
//   its lane (at most 4·ceil(K/4) a lane) and feeds R independent FMAs;
//   the carries sit in shared memory as [k][R], so one load gives entry k
//   of all R rows (a float4 at R = 4), conflict-free across the 4 lanes;
// - the widths are template arguments (max(U, H) padded to a multiple of
//   8, up to 64, with zero weights past the width), so the products
//   unroll; a product of K terms is K/4 dependent FMAs a lane, then two
//   __shfl_xor_sync rounds that leave lane q with the sums of its own row
//   (a reduce-scatter over the R rows), where the cell's nonlinearities
//   run once a row instead of once a lane;
// - each step's inputs (gate terms, time gates, the mask of all R rows)
//   are loaded one step ahead into registers, and the outputs and carries
//   are stored by the lane that owns the row, so no device-memory access
//   sits on the chain; a step that all R rows mask is skipped whole (the
//   carries still written).
// Not the tensor cores: the per-step products are [R, K] x [K, <= 4K] with
// R <= 4, so an m16 mma.sync tile would be mostly padding, and the 3xTF32
// split that the 1e-5 gate needs would add three dependent tensor-core
// latencies per k-step to the chain.
//
// The backward keeps the first design of this file: a block walks one row,
// the five recurrent matrices (3U^2 + 7H^2 floats, 64 KB at U = H = 40) and
// the carries in shared memory, a step in phases split by __syncthreads
// with one thread per output of the phase.  It pads the matrices' rows to
// an odd stride, so a thread per row reading one column (its transposed
// products dh[k] = Σ_o dga[o]·W[k][o]) hits 32 banks, as a thread per
// column does.  A masked step (mt == 0) changes no carry and writes zero
// outputs, so the block skips its arithmetic.
// (Blocks of two rows sharing the matrices, so that all 400 rows of a
// B = 400 batch fit the card's resident blocks at once, measured slower
// on mixed history lengths than one row a block with a few rows left to
// a second wave.)

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// The row stride of a matrix n wide in the backward's shared memory: odd
// (see above).  The helpers from here to the backward kernel are the
// backward's; the forward keeps its weights in registers.
template <bool ODD>
__host__ __device__ __forceinline__ int stride_(int n) {
  return ODD ? (n | 1) : n;
}

template <bool ODD>
__host__ __device__ __forceinline__ long long weight_floats(int U, int H) {
  return (long long)U * stride_<ODD>(2 * U) + (long long)U * stride_<ODD>(U) +
         (long long)H * stride_<ODD>(4 * H) +
         (long long)H * stride_<ODD>(2 * H) + (long long)H * stride_<ODD>(H);
}

// the backward's shared memory beside the matrices, in floats
__host__ __device__ __forceinline__ long long bwd_step_floats(int U, int H) {
  return 2LL * (U + 3 * H) + 3LL * (2 * U + 6 * H) + 3LL * (U + H);
}

// threads per row: one per gate output
__host__ __device__ __forceinline__ int row_threads(int U, int H) {
  return ((2 * U + 6 * H + 31) / 32) * 32;
}

// The five recurrent matrices in shared memory, [k][o] at k * s + o.
struct Weights {
  float *g1, *c1, *w4, *g2, *c2;
  int s_g1, s_c1, s_w4, s_g2, s_c2;
};

__device__ void copy_rows(float* dst, const float* __restrict__ src, int rows,
                          int cols, int s, int tid, int nt) {
  if (s == cols) {
    for (int i = tid; i < rows * cols; i += nt) dst[i] = src[i];
  } else {
    for (int i = tid; i < rows * cols; i += nt)
      dst[(i / cols) * s + i % cols] = src[i];
  }
}

template <bool ODD>
__device__ Weights load_weights(float* sm, const float* __restrict__ whg1,
                                const float* __restrict__ whc1,
                                const float* __restrict__ wh4,
                                const float* __restrict__ whg2,
                                const float* __restrict__ whc2, int U, int H,
                                int tid, int nt) {
  Weights w;
  w.s_g1 = stride_<ODD>(2 * U);
  w.s_c1 = stride_<ODD>(U);
  w.s_w4 = stride_<ODD>(4 * H);
  w.s_g2 = stride_<ODD>(2 * H);
  w.s_c2 = stride_<ODD>(H);
  w.g1 = sm;
  w.c1 = w.g1 + U * w.s_g1;
  w.w4 = w.c1 + U * w.s_c1;
  w.g2 = w.w4 + H * w.s_w4;
  w.c2 = w.g2 + H * w.s_g2;
  copy_rows(w.g1, whg1, U, 2 * U, w.s_g1, tid, nt);
  copy_rows(w.c1, whc1, U, U, w.s_c1, tid, nt);
  copy_rows(w.w4, wh4, H, 4 * H, w.s_w4, tid, nt);
  copy_rows(w.g2, whg2, H, 2 * H, w.s_g2, tid, nt);
  copy_rows(w.c2, whc2, H, H, w.s_c2, tid, nt);
  return w;
}

// The input term of gate output o in [0, 2U+6H) at step bl.
__device__ __forceinline__ float gate_input(int o,
                                            const float* __restrict__ xg1,
                                            const float* __restrict__ xw,
                                            const float* __restrict__ xg2,
                                            size_t bl, int U, int H) {
  if (o < 2 * U) return xg1[bl * 2 * U + o];
  if (o < 2 * U + 4 * H) return xw[bl * 4 * H + o - 2 * U];
  return xg2[bl * 2 * H + o - 2 * U - 4 * H];
}

// Gate output o from its input term and the carry (h1 | c | m | h2 at cy):
// sigmoid(r1, u1) | i, j, f, o raw | sigmoid(r2, u2).
__device__ __forceinline__ float gate(int o, float acc, const Weights& w,
                                      const float* cy, int U, int H) {
  if (o < 2 * U) {
    for (int k = 0; k < U; ++k) acc = fmaf(cy[k], w.g1[k * w.s_g1 + o], acc);
    return sigmoidf_(acc);
  }
  if (o < 2 * U + 4 * H) {
    const float* m = cy + U + H;
    const int oo = o - 2 * U;
    for (int k = 0; k < H; ++k) acc = fmaf(m[k], w.w4[k * w.s_w4 + oo], acc);
    return acc;
  }
  const float* h2 = cy + U + 2 * H;
  const int oo = o - 2 * U - 4 * H;
  for (int k = 0; k < H; ++k) acc = fmaf(h2[k], w.g2[k * w.s_g2 + oo], acc);
  return sigmoidf_(acc);
}

// GRU candidate o in [0, U+H) from its input term and zc = r1·h1 | r2·h2.
__device__ __forceinline__ float candidate(int o, float acc, const Weights& w,
                                           const float* zc, int U, int H) {
  if (o < U) {
    for (int k = 0; k < U; ++k) acc = fmaf(zc[k], w.c1[k * w.s_c1 + o], acc);
  } else {
    const int oo = o - U;
    for (int k = 0; k < H; ++k)
      acc = fmaf(zc[U + k], w.c2[k * w.s_c2 + oo], acc);
  }
  return tanhf(acc);
}

__device__ __forceinline__ void zero_(float* p, int n, int x, int nt) {
  for (int i = x; i < n; i += nt) p[i] = 0.f;
}

// One block walks one row back in time, a thread per gate output.  At
// most BWD_THREADS threads a block and at least two blocks an SM: that
// caps the registers at 48 a thread, so that shared memory, not
// registers, sets how many blocks an SM holds (three at U = H = 40).
constexpr int BWD_THREADS = 640;

__global__ void __launch_bounds__(BWD_THREADS, 2) clsr_scan_backward_kernel(
    const float* __restrict__ xg1, const float* __restrict__ xc1,
    const float* __restrict__ xw, const float* __restrict__ tn,
    const float* __restrict__ tl, const float* __restrict__ ot,
    const float* __restrict__ xg2, const float* __restrict__ xc2,
    const float* __restrict__ mask, const float* __restrict__ whg1,
    const float* __restrict__ whc1, const float* __restrict__ wh4,
    const float* __restrict__ whg2, const float* __restrict__ whc2,
    const float* __restrict__ carries, const float* __restrict__ d_h1f,
    const float* __restrict__ d_outs, const float* __restrict__ d_h2f,
    float* __restrict__ dxg1, float* __restrict__ dxc1,
    float* __restrict__ dxw, float* __restrict__ dtn,
    float* __restrict__ dtl, float* __restrict__ dot,
    float* __restrict__ dxg2, float* __restrict__ dxc2,
    float* __restrict__ dus, float* __restrict__ zc, int L, int U, int H) {
  extern __shared__ float sm[];
  const int GW = 2 * U + 6 * H, CW = U + 3 * H, ZW = U + H;
  const int x = threadIdx.x, T = blockDim.x;
  const Weights w =
      load_weights<true>(sm, whg1, whc1, wh4, whg2, whc2, U, H, x, T);
  float* s_cy = sm + weight_floats<true>(U, H);
  float* s_adj = s_cy + CW;    // [CW]: dh1 | dc | dm | dh2 after the step
  float* s_ga = s_adj + CW;    // [GW]: the gates, as the forward's s_ga
  float* s_zc = s_ga + GW;     // [ZW]: r1*h1 | r2*h2
  float* s_cand = s_zc + ZW;   // [ZW]: the GRU candidates
  float* s_dca = s_cand + ZW;  // [ZW]: adjoints of the candidates' pre-acts
  float* s_dga = s_dca + ZW;   // [GW]: adjoints of the gates' pre-acts
  float* s_part = s_dga + GW;  // [GW]: partial sums of dga·Wgᵀ

  const int b = blockIdx.x;
  if (x < CW)
    s_adj[x] = x < U ? d_h1f[(size_t)b * U + x]
               : x >= U + 2 * H ? d_h2f[(size_t)b * H + x - U - 2 * H] : 0.f;

  for (int l = L - 1; l >= 0; --l) {
    const size_t bl = (size_t)b * L + l;
    const float mt = mask[bl];
    const bool on = mt != 0.f;  // uniform over the block
    // phase 1: the step's carry, and every input a thread reads this step,
    // in one round of loads.  Thread U+j runs GRU2's candidate j and the
    // Time4LSTM's unit j.
    float xg = 0.f, xc = 0.f, vtn = 0.f, vtl = 0.f, vot = 0.f, vdo = 0.f;
    if (on) {
      if (x < CW) s_cy[x] = carries[bl * CW + x];
      if (x < GW) xg = gate_input(x, xg1, xw, xg2, bl, U, H);
      if (x < U) {
        xc = xc1[bl * U + x];
      } else if (x < ZW) {
        const size_t j = bl * H + x - U;
        xc = xc2[j];
        vtn = tn[j];
        vtl = tl[j];
        vot = ot[j];
        vdo = d_outs[j];
      }
    }
    __syncthreads();

    // phase A: the gates, and the reset products
    if (on && x < GW) {
      const float a = gate(x, xg, w, s_cy, U, H);
      s_ga[x] = a;
      if (x < U) {
        s_zc[x] = a * s_cy[x];
        zc[bl * ZW + x] = s_zc[x];
      } else if (x >= 2 * U + 4 * H && x < 2 * U + 5 * H) {
        const int j = x - 2 * U - 4 * H;
        s_zc[U + j] = a * s_cy[U + 2 * H + j];
        zc[bl * ZW + U + j] = s_zc[U + j];
      }
    }
    __syncthreads();

    // phase C: the GRU candidates
    if (on && x < ZW) s_cand[x] = candidate(x, xc, w, s_zc, U, H);
    __syncthreads();

    // phase D: the elementwise adjoints; each thread updates its own
    // entries of the adjoint carry
    if (on && x < U + 2 * H) {
      if (x < U || x >= ZW) {  // a GRU: its candidate and update gate
        const bool g1 = x < U;
        const int j = g1 ? x : x - ZW;
        const int hk = g1 ? j : U + 2 * H + j;          // carry entry
        const int gu = g1 ? U + j : 2 * U + 5 * H + j;  // update gate
        const int ci = g1 ? j : U + j;                  // candidate
        const float u = s_ga[gu], h = s_cy[hk], n = s_cand[ci];
        const float dh = s_adj[hk], dhn = mt * dh;
        const float dca = dhn * (1.f - u) * (1.f - n * n);
        const float dgu = dhn * (h - n) * u * (1.f - u);
        s_dca[ci] = dca;
        s_dga[gu] = dgu;
        if (g1) {
          dxc1[bl * U + j] = dca;
          dxg1[bl * 2 * U + U + j] = dgu;
        } else {
          dxc2[bl * H + j] = dca;
          dxg2[bl * 2 * H + H + j] = dgu;
        }
        s_adj[hk] = (1.f - mt) * dh + u * dhn;
      } else {  // the Time4LSTM
        const int j = x - U;
        const float* mat = s_ga + 2 * U;
        const float c = s_cy[U + j];
        const float sf = sigmoidf_(mat[2 * H + j] + 1.f), stl = sigmoidf_(vtl);
        const float si = sigmoidf_(mat[j]), stn = sigmoidf_(vtn);
        const float tj = tanhf(mat[H + j]);
        const float so = sigmoidf_(mat[3 * H + j] + vot);
        const float tc = tanhf(sf * stl * c + si * stn * tj);
        const float dcp = s_adj[U + j], dmp = s_adj[U + H + j];
        const float dmn = mt * (dmp + vdo);
        const float dcn = mt * dcp + dmn * so * (1.f - tc * tc);
        const float d4[4] = {dcn * stn * tj * si * (1.f - si),
                             dcn * si * stn * (1.f - tj * tj),
                             dcn * stl * c * sf * (1.f - sf),
                             dmn * tc * so * (1.f - so)};
        for (int q = 0; q < 4; ++q) {
          s_dga[2 * U + q * H + j] = d4[q];
          dxw[bl * 4 * H + q * H + j] = d4[q];
        }
        dtn[bl * H + j] = dcn * si * tj * stn * (1.f - stn);
        dtl[bl * H + j] = dcn * sf * c * stl * (1.f - stl);
        dot[bl * H + j] = d4[3];
        s_adj[U + j] = (1.f - mt) * dcp + dcn * sf * stl;
        s_adj[U + H + j] = (1.f - mt) * dmp;
      }
    }
    __syncthreads();

    // phase E: dZc = dca·Wcᵀ (a thread per row of Wc), then the reset gates
    if (on && x < ZW) {
      const bool g1 = x < U;
      const int j = g1 ? x : x - U;
      float dz = 0.f;
      if (g1) {
        for (int o = 0; o < U; ++o)
          dz = fmaf(s_dca[o], w.c1[j * w.s_c1 + o], dz);
      } else {
        for (int o = 0; o < H; ++o)
          dz = fmaf(s_dca[U + o], w.c2[j * w.s_c2 + o], dz);
      }
      const int hk = g1 ? j : U + 2 * H + j;
      const int gr = g1 ? j : 2 * U + 4 * H + j;
      const float r = s_ga[gr];
      const float dgr = dz * s_cy[hk] * r * (1.f - r);
      s_dga[gr] = dgr;
      if (g1) dxg1[bl * 2 * U + j] = dgr;
      else dxg2[bl * 2 * H + j] = dgr;
      s_adj[hk] += dz * r;
    }
    __syncthreads();

    // phase F: dh_prev += dga·Wgᵀ, in 2U + 6H partial sums of U or H terms:
    // row k of Whg1 in 2 chunks, of Wh4 in 4, of Whg2 in 2
    if (on && x < GW) {
      float acc = 0.f;
      if (x < 2 * U) {
        const int k = x % U, c0 = x - k;
        for (int q = 0; q < U; ++q)
          acc = fmaf(s_dga[c0 + q], w.g1[k * w.s_g1 + c0 + q], acc);
      } else if (x < 2 * U + 4 * H) {
        const int oo = x - 2 * U, k = oo % H, c0 = oo - k;
        for (int q = 0; q < H; ++q)
          acc = fmaf(s_dga[2 * U + c0 + q], w.w4[k * w.s_w4 + c0 + q], acc);
      } else {
        const int oo = x - 2 * U - 4 * H, k = oo % H, c0 = oo - k;
        for (int q = 0; q < H; ++q)
          acc = fmaf(s_dga[2 * U + 4 * H + c0 + q], w.g2[k * w.s_g2 + c0 + q],
                     acc);
      }
      s_part[x] = acc;
    }
    __syncthreads();

    // phase G: the partial sums into the adjoint carry (read from the next
    // step's phase D on, after two barriers)
    if (on && x < U + 2 * H) {
      if (x < U) {
        s_adj[x] += s_part[x] + s_part[U + x];
      } else if (x < ZW) {
        const float* p = s_part + 2 * U + x - U;
        s_adj[x + H] += (p[0] + p[H]) + (p[2 * H] + p[3 * H]);
      } else {
        const float* p = s_part + 2 * U + 4 * H + x - ZW;
        s_adj[x + H] += p[0] + p[H];
      }
    }
    if (!on) {  // a masked step: nothing flows through it
      zero_(dxg1 + bl * 2 * U, 2 * U, x, T);
      zero_(dxc1 + bl * U, U, x, T);
      zero_(dxw + bl * 4 * H, 4 * H, x, T);
      zero_(dtn + bl * H, H, x, T);
      zero_(dtl + bl * H, H, x, T);
      zero_(dot + bl * H, H, x, T);
      zero_(dxg2 + bl * 2 * H, 2 * H, x, T);
      zero_(dxc2 + bl * H, H, x, T);
      zero_(zc + bl * ZW, ZW, x, T);
    }
  }
  __syncthreads();
  if (x < U) dus[(size_t)b * U + x] = s_adj[x];
}

// ---- the forward ----

constexpr int kLanes = 4;        // lanes per unit, each a quarter of the terms
constexpr int kMaxWidth = 64;    // the widest U or H the forward takes
constexpr int kBlocksPerSM = 3;  // resident blocks an SM, by the launch bounds
constexpr unsigned kFull = 0xffffffffu;

struct ScanArgs {
  const float *xg1, *xc1, *xw, *tn, *tl, *ot, *xg2, *xc2, *mask, *ushort_;
  const float *whg1, *whc1, *wh4, *whg2, *whc2;
  float *outs, *h1f, *h2f, *carries;
  int B, L, U, H;
};

// The row of its block's R that lane q owns, and whether it stores for it:
// at R = 4 lane q owns row q; at R = 1 all four own row 0 (they hold the
// same values) and lane 0 stores.
template <int R>
__device__ __forceinline__ int owned_row(int q) {
  return R == 4 ? q : 0;
}
template <int R>
__device__ __forceinline__ bool stores(int q) {
  return R == 4 || q == 0;
}

// v[own] without indexing a register array by a run-time value
template <int R>
__device__ __forceinline__ float pick(const float (&v)[R], int own) {
  float x = v[0];
#pragma unroll
  for (int r = 1; r < R; ++r) x = own == r ? v[r] : x;
  return x;
}

// Entry k of all R rows of a carry laid out [k][R] in shared memory.
template <int R>
__device__ __forceinline__ void load_rows(const float* s, int k,
                                          float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 t = *reinterpret_cast<const float4*>(s + 4 * k);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = s[k];
  }
}

// Lane q's part of G products of unit j for R rows: the terms k = q + 4i,
// w[g][i] = W[q + 4i][column g of unit j].  (Two partial sums a product
// where R·G is small measured no faster, and one is simpler.)
template <int KQ, int R, int G>
__device__ __forceinline__ void partial_dots(const float* s, int q,
                                             const float (&w)[G][KQ],
                                             float (&acc)[R][G]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[r][g] = 0.f;
#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    float v[R];
    load_rows<R>(s, i * kLanes + q, v);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g) acc[r][g] = fmaf(v[r], w[g][i], acc[r][g]);
  }
}

// The four lanes' partial sums -> the G sums of the row lane q owns: two
// __shfl_xor_sync rounds, at R = 4 each halving the rows a lane keeps (a
// reduce-scatter), at R = 1 each summing across a pair (an all-reduce).
template <int R, int G>
__device__ __forceinline__ void reduce_lanes(const float (&acc)[R][G], int q,
                                             float (&out)[G]) {
  if constexpr (R == 4) {
    const bool hi = q & 2, lo = q & 1;
    float b[2][G];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float keep = hi ? acc[r + 2][g] : acc[r][g];
        const float send = hi ? acc[r][g] : acc[r + 2][g];
        b[r][g] = keep + __shfl_xor_sync(kFull, send, 2);
      }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float keep = lo ? b[1][g] : b[0][g];
      const float send = lo ? b[0][g] : b[1][g];
      out[g] = keep + __shfl_xor_sync(kFull, send, 1);
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float t = acc[0][g] + __shfl_xor_sync(kFull, acc[0][g], 2);
      out[g] = t + __shfl_xor_sync(kFull, t, 1);
    }
  }
}

// The mask of the block's R rows at step l (0 past the batch).
template <int R>
__device__ __forceinline__ void load_mask(const ScanArgs& a, int row0, int l,
                                          float (&mk)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    mk[r] = row0 + r < a.B ? a.mask[(size_t)(row0 + r) * a.L + l] : 0.f;
}

template <int R>
__device__ __forceinline__ bool any_valid(const float (&mk)[R]) {
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) any |= mk[r] != 0.f;
  return any;
}

// A GRU over K units (U for the interest-evolve one, H for causal2): gates
// [r | u] = sigmoid(xg + h·Wg), candidate tanh(xc + (r∘h)·Wc).  Its carry
// h starts from h0 (null: zeros) and fills columns off .. off+K of the
// carries; s_h and s_z are [KP][R] each.
template <int KP, int R>
__device__ void gru_cell(const ScanArgs& a, const float* __restrict__ xg,
                         const float* __restrict__ xc,
                         const float* __restrict__ h0,
                         const float* __restrict__ wg,
                         const float* __restrict__ wc,
                         float* __restrict__ hf, int K, int off, float* s_h,
                         float* s_z, int row0) {
  constexpr int KQ = KP / kLanes;
  const int j = threadIdx.x / kLanes, q = threadIdx.x % kLanes;
  const int own = owned_row<R>(q), b = row0 + own;
  const bool st = stores<R>(q), live = j < K && b < a.B;
  const int L = a.L, CW = a.U + 3 * a.H;
  float wgate[2][KQ], wcand[1][KQ];
#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    const int k = i * kLanes + q;
    const bool in = j < K && k < K;
    wgate[0][i] = in ? wg[k * 2 * K + j] : 0.f;
    wgate[1][i] = in ? wg[k * 2 * K + K + j] : 0.f;
    wcand[0][i] = in ? wc[k * K + j] : 0.f;
  }
  float h = live && h0 != nullptr ? h0[(size_t)b * K + j] : 0.f;
  if (st) s_h[j * R + own] = h;
  // step l's inputs: the gate terms, the candidate term and the mask
  float xr = 0.f, xu = 0.f, xn = 0.f, mk[R];
  auto load_step = [&](int l, float& r_, float& u_, float& n_, float (&m_)[R]) {
    load_mask<R>(a, row0, l, m_);
    if (live) {
      const size_t bl = (size_t)b * L + l;
      r_ = xg[bl * 2 * K + j];
      u_ = xg[bl * 2 * K + K + j];
      n_ = xc[bl * K + j];
    }
  };
  load_step(0, xr, xu, xn, mk);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    float xr1 = 0.f, xu1 = 0.f, xn1 = 0.f, mk1[R];
    if (l + 1 < L) load_step(l + 1, xr1, xu1, xn1, mk1);
    const size_t bl = (size_t)b * L + l;
    if (a.carries != nullptr && st && live) a.carries[bl * CW + off + j] = h;
    if (any_valid<R>(mk)) {
      float acc[R][2], g[2];
      partial_dots<KQ, R, 2>(s_h, q, wgate, acc);
      reduce_lanes<R, 2>(acc, q, g);
      const float rg = sigmoidf_(g[0] + xr), ug = sigmoidf_(g[1] + xu);
      if (st) s_z[j * R + own] = rg * h;
      __syncthreads();
      float acc2[R][1], n[1];
      partial_dots<KQ, R, 1>(s_z, q, wcand, acc2);
      reduce_lanes<R, 1>(acc2, q, n);
      const float cand = tanhf(n[0] + xn);
      const float mt = pick<R>(mk, own);
      h = mt * (ug * h + (1.f - ug) * cand) + (1.f - mt) * h;
      if (st) s_h[j * R + own] = h;
      __syncthreads();
    }
    xr = xr1, xu = xu1, xn = xn1;
#pragma unroll
    for (int r = 0; r < R; ++r) mk[r] = mk1[r];
  }
  if (st && live) hf[(size_t)b * K + j] = h;
}

// The Time4LSTM over H units: gates i, j, f, o = xw + m·Wh4 (o + ot),
// c' = sigmoid(f+1)·sigmoid(tl)·c + sigmoid(i)·sigmoid(tn)·tanh(j),
// m' = sigmoid(o)·tanh(c').  Writes outs = mt·m' and carry columns
// U .. U+2H; s_m is two [KP][R] buffers, one read and one written a step.
template <int KP, int R>
__device__ void lstm_cell(const ScanArgs& a, float* s_m, int row0) {
  constexpr int KQ = KP / kLanes;
  const int j = threadIdx.x / kLanes, q = threadIdx.x % kLanes;
  const int own = owned_row<R>(q), b = row0 + own;
  const int H = a.H, L = a.L, CW = a.U + 3 * H;
  const bool st = stores<R>(q), live = j < H && b < a.B;
  float w[4][KQ];
#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    const int k = i * kLanes + q;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      w[g][i] = j < H && k < H ? a.wh4[k * 4 * H + g * H + j] : 0.f;
  }
  float c = 0.f, m = 0.f;
  if (st) s_m[j * R + own] = 0.f;
  // step l's inputs: the four gate terms, tn, tl, ot and the mask
  float x[4] = {0.f, 0.f, 0.f, 0.f}, xtn = 0.f, xtl = 0.f, xot = 0.f, mk[R];
  auto load_step = [&](int l, float (&x_)[4], float& tn_, float& tl_,
                       float& ot_, float (&m_)[R]) {
    load_mask<R>(a, row0, l, m_);
    if (live) {
      const size_t bl = (size_t)b * L + l;
#pragma unroll
      for (int g = 0; g < 4; ++g) x_[g] = a.xw[bl * 4 * H + g * H + j];
      tn_ = a.tn[bl * H + j];
      tl_ = a.tl[bl * H + j];
      ot_ = a.ot[bl * H + j];
    }
  };
  load_step(0, x, xtn, xtl, xot, mk);
  __syncthreads();

  int cur = 0;
  for (int l = 0; l < L; ++l) {
    float x1[4] = {0.f, 0.f, 0.f, 0.f}, xtn1 = 0.f, xtl1 = 0.f, xot1 = 0.f,
          mk1[R];
    if (l + 1 < L) load_step(l + 1, x1, xtn1, xtl1, xot1, mk1);
    const size_t bl = (size_t)b * L + l;
    if (a.carries != nullptr && st && live) {
      a.carries[bl * CW + a.U + j] = c;
      a.carries[bl * CW + a.U + H + j] = m;
    }
    if (any_valid<R>(mk)) {
      float acc[R][4], g[4];
      partial_dots<KQ, R, 4>(s_m + cur * KP * R, q, w, acc);
      reduce_lanes<R, 4>(acc, q, g);
      const float gi = g[0] + x[0], gj = g[1] + x[1], gf = g[2] + x[2];
      const float go = (g[3] + x[3]) + xot;
      const float c_new = sigmoidf_(gf + 1.f) * sigmoidf_(xtl) * c +
                          sigmoidf_(gi) * sigmoidf_(xtn) * tanhf(gj);
      const float m_new = sigmoidf_(go) * tanhf(c_new);
      const float mt = pick<R>(mk, own);
      c = mt * c_new + (1.f - mt) * c;
      m = mt * m_new + (1.f - mt) * m;
      if (st && live) a.outs[bl * H + j] = mt * m_new;
      cur ^= 1;
      if (st) s_m[cur * KP * R + j * R + own] = m;
      __syncthreads();
    } else if (st && live) {
      a.outs[bl * H + j] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = x1[g];
    xtn = xtn1, xtl = xtl1, xot = xot1;
#pragma unroll
    for (int r = 0; r < R; ++r) mk[r] = mk1[r];
  }
}

// Block 3·i + cell walks rows R·i .. R·i+R-1 of one cell: 0 the
// interest-evolve GRU, 1 the Time4LSTM, 2 the causal2 GRU.
template <int KP, int R>
__global__ void __launch_bounds__(kLanes * KP, kBlocksPerSM)
    clsr_scan_kernel(const ScanArgs a) {
  __shared__ __align__(16) float sm[2 * KP * R];
  const int cell = blockIdx.x % 3, row0 = (blockIdx.x / 3) * R;
  if (cell == 0)
    gru_cell<KP, R>(a, a.xg1, a.xc1, a.ushort_, a.whg1, a.whc1, a.h1f, a.U,
                    0, sm, sm + KP * R, row0);
  else if (cell == 1)
    lstm_cell<KP, R>(a, sm, row0);
  else
    gru_cell<KP, R>(a, a.xg2, a.xc2, nullptr, a.whg2, a.whc2, a.h2f, a.H,
                    a.U + 2 * a.H, sm, sm + KP * R, row0);
}

template <int KP, int R>
int launch_forward(const ScanArgs& a, cudaStream_t stream) {
  const int groups = (a.B + R - 1) / R;
  clsr_scan_kernel<KP, R><<<3 * groups, kLanes * KP, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KP>
int forward_rows(const ScanArgs& a, int rows, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_forward<KP, 1>(a, stream);
    case 4: return launch_forward<KP, 4>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory the backward needs, in bytes.
extern "C" long long clsr_scan_backward_smem_bytes(int U, int H) {
  return (weight_floats<true>(U, H) + bwd_step_floats(U, H)) *
         (long long)sizeof(float);
}

// The forward over `rows` rows a block (1 or 4); every U and H from 1
// to kMaxWidth.  The arguments before `rows` are those of the first
// forward kernel, in the same order.
extern "C" int clsr_scan_forward(
    const float* xg1, const float* xc1, const float* xw, const float* tn,
    const float* tl, const float* ot, const float* xg2, const float* xc2,
    const float* mask, const float* ushort_, const float* whg1,
    const float* whc1, const float* wh4, const float* whg2,
    const float* whc2, float* outs, float* h1f, float* h2f, float* carries,
    int B, int L, int U, int H, int rows, void* stream) {
  if (B < 0 || L < 1 || U < 1 || H < 1 || U > kMaxWidth || H > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const ScanArgs a{xg1,  xc1,  xw,   tn,   tl,   ot,   xg2,  xc2, mask,
                   ushort_, whg1, whc1, wh4, whg2, whc2, outs, h1f, h2f,
                   carries, B, L, U, H};
  const auto s = static_cast<cudaStream_t>(stream);
  switch ((max(U, H) + 7) / 8 * 8) {   // the width padded to a multiple of 8
    case 8: return forward_rows<8>(a, rows, s);
    case 16: return forward_rows<16>(a, rows, s);
    case 24: return forward_rows<24>(a, rows, s);
    case 32: return forward_rows<32>(a, rows, s);
    case 40: return forward_rows<40>(a, rows, s);
    case 48: return forward_rows<48>(a, rows, s);
    case 56: return forward_rows<56>(a, rows, s);
    default: return forward_rows<64>(a, rows, s);
  }
}

extern "C" int clsr_scan_backward(
    const float* xg1, const float* xc1, const float* xw, const float* tn,
    const float* tl, const float* ot, const float* xg2, const float* xc2,
    const float* mask, const float* whg1, const float* whc1,
    const float* wh4, const float* whg2, const float* whc2,
    const float* carries, const float* d_h1f, const float* d_outs,
    const float* d_h2f, float* dxg1, float* dxc1, float* dxw, float* dtn,
    float* dtl, float* dot, float* dxg2, float* dxc2, float* dus, float* zc,
    int B, int L, int U, int H, void* stream) {
  const int T = row_threads(U, H);
  if (T > BWD_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)clsr_scan_backward_smem_bytes(U, H);
  cudaError_t err = cudaFuncSetAttribute(
      clsr_scan_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  clsr_scan_backward_kernel<<<B, T, smem, static_cast<cudaStream_t>(stream)>>>(
      xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask, whg1, whc1, wh4, whg2, whc2,
      carries, d_h1f, d_outs, d_h2f, dxg1, dxc1, dxw, dtn, dtl, dot, dxg2,
      dxc2, dus, zc, L, U, H);
  return (int)cudaGetLastError();
}

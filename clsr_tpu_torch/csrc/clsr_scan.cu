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
// nor operations (~32,000 multiply-adds a row and step) but the L
// dependent steps: each step needs the whole carry of the one before.  The
// design keeps that chain on chip: a block walks one row, the five
// recurrent matrices (3U^2 + 7H^2 floats, 64 KB at U = H = 40) and the
// carries stay in shared memory, and a step is a few phases split by
// __syncthreads with one thread per output of the phase.  The backward
// pads the matrices' rows to an odd stride, so a thread per row reading
// one column (its transposed products dh[k] = Σ_o dga[o]·W[k][o]) hits 32
// banks, as a thread per column does.  A masked step (mt == 0) changes no
// carry and writes zero outputs, so the block skips its arithmetic; a
// block whose row is short ends early and frees its SM for the next.
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

// The row stride of a matrix n wide in shared memory: odd for the backward
// (see above).  The forward reads along rows only, and on the H100 odd
// strides took it to more registers and more time, so it keeps the plain
// layout.
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

__global__ void clsr_scan_kernel(
    const float* __restrict__ xg1, const float* __restrict__ xc1,
    const float* __restrict__ xw, const float* __restrict__ tn,
    const float* __restrict__ tl, const float* __restrict__ ot,
    const float* __restrict__ xg2, const float* __restrict__ xc2,
    const float* __restrict__ mask, const float* __restrict__ ushort_,
    const float* __restrict__ whg1, const float* __restrict__ whc1,
    const float* __restrict__ wh4, const float* __restrict__ whg2,
    const float* __restrict__ whc2, float* __restrict__ outs,
    float* __restrict__ h1f, float* __restrict__ h2f,
    float* __restrict__ carries, int L, int U, int H) {
  extern __shared__ float sm[];
  const int GW = 2 * U + 6 * H;      // gate outputs per step
  const int CW = U + 3 * H;          // carry width
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const Weights w =
      load_weights<false>(sm, whg1, whc1, wh4, whg2, whc2, U, H, tid, nt);
  float* s_cy = sm + weight_floats<false>(U, H);  // [CW]: h1 | c | m | h2
  float* s_ga = s_cy + CW;           // [GW]: sig(r1,u1) | i,j,f,o | sig(r2,u2)
  float* s_zc = s_ga + GW;           // [U+H]: r1*h1 | r2*h2
  float* s_h1 = s_cy;
  float* s_c = s_cy + U;
  float* s_m = s_c + H;
  float* s_h2 = s_m + H;

  for (int i = tid; i < U; i += nt) s_h1[i] = ushort_[(size_t)b * U + i];
  for (int i = tid; i < H; i += nt) {
    s_c[i] = 0.f;
    s_m[i] = 0.f;
    s_h2[i] = 0.f;
  }
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const size_t bl = (size_t)b * L + l;
    if (carries != nullptr)
      for (int i = tid; i < CW; i += nt) carries[bl * CW + i] = s_cy[i];
    const float mt = mask[bl];
    if (mt == 0.f) {   // uniform over the block: carry through, output 0
      for (int j = tid; j < H; j += nt) outs[bl * H + j] = 0.f;
      continue;
    }

    // phase A: the three cells' carry-gate mat-vecs
    for (int o = tid; o < GW; o += nt)
      s_ga[o] = gate(o, gate_input(o, xg1, xw, xg2, bl, U, H), w, s_cy, U, H);
    __syncthreads();

    // phase B: Time4LSTM cell, GRU reset products
    for (int j = tid; j < U; j += nt) s_zc[j] = s_ga[j] * s_h1[j];
    for (int j = tid; j < H; j += nt) {
      const float* mat = s_ga + 2 * U;
      const float gi = mat[j], gj = mat[H + j], gf = mat[2 * H + j];
      const float go = mat[3 * H + j] + ot[bl * H + j];
      const float c = s_c[j];
      const float c_new = sigmoidf_(gf + 1.f) * sigmoidf_(tl[bl * H + j]) * c +
                          sigmoidf_(gi) * sigmoidf_(tn[bl * H + j]) * tanhf(gj);
      const float m_new = sigmoidf_(go) * tanhf(c_new);
      s_c[j] = mt * c_new + (1.f - mt) * c;
      s_m[j] = mt * m_new + (1.f - mt) * s_m[j];
      outs[bl * H + j] = mt * m_new;
      s_zc[U + j] = s_ga[2 * U + 4 * H + j] * s_h2[j];
    }
    __syncthreads();

    // phase C: GRU candidates and carry updates
    for (int o = tid; o < U + H; o += nt) {
      if (o < U) {
        const float cand = candidate(o, xc1[bl * U + o], w, s_zc, U, H);
        const float u = s_ga[U + o];
        const float h = s_h1[o];
        s_h1[o] = mt * (u * h + (1.f - u) * cand) + (1.f - mt) * h;
      } else {
        const int oo = o - U;
        const float cand = candidate(o, xc2[bl * H + oo], w, s_zc, U, H);
        const float u = s_ga[2 * U + 4 * H + H + oo];
        const float h = s_h2[oo];
        s_h2[oo] = mt * (u * h + (1.f - u) * cand) + (1.f - mt) * h;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < U; i += nt) h1f[(size_t)b * U + i] = s_h1[i];
  for (int i = tid; i < H; i += nt) h2f[(size_t)b * H + i] = s_h2[i];
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

}  // namespace

// Shared memory the forward needs, in bytes (the wrapper checks the limit).
extern "C" long long clsr_scan_smem_bytes(int U, int H) {
  const long long floats = weight_floats<false>(U, H) + (U + 3LL * H) +
                           (2LL * U + 6LL * H) + (U + H);
  return floats * (long long)sizeof(float);
}

// Shared memory the backward needs, in bytes.
extern "C" long long clsr_scan_backward_smem_bytes(int U, int H) {
  return (weight_floats<true>(U, H) + bwd_step_floats(U, H)) *
         (long long)sizeof(float);
}

extern "C" int clsr_scan_forward(
    const float* xg1, const float* xc1, const float* xw, const float* tn,
    const float* tl, const float* ot, const float* xg2, const float* xc2,
    const float* mask, const float* ushort_, const float* whg1,
    const float* whc1, const float* wh4, const float* whg2,
    const float* whc2, float* outs, float* h1f, float* h2f, float* carries,
    int B, int L, int U, int H, void* stream) {
  const int threads = row_threads(U, H);
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)clsr_scan_smem_bytes(U, H);
  cudaError_t err = cudaFuncSetAttribute(
      clsr_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  clsr_scan_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask, ushort_, whg1, whc1, wh4,
      whg2, whc2, outs, h1f, h2f, carries, L, U, H);
  return (int)cudaGetLastError();
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

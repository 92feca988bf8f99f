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
// (pallas_scan.py:243 _bwd, jax.vjp of _scan_reference), in the shape of
// the JAX package's hand-written backward _bd_scan (clsr_tpu/ops/
// fused_clsr.py:114-159): from the saved carries it walks the steps in
// reverse and carries the adjoint (dh1, dc, dm, dh2) back.  It writes the
// cotangents of xg1, xc1, xw, tn, tl, ot, xg2, xc2 and user_short, and each
// step's r1·h1 | r2·h2 (Zc), from which the caller's five weight products
// follow (plain large products, as JAX leaves them to XLA).
//
// What bounds both on an H100: neither bytes (the backward moves ~1,240
// floats a row and step, ~99 MB at B = 400, L = 50: 0.03 ms of HBM time)
// nor operations (~16,000 multiply-adds a row and step forward, twice
// that backward) but the L dependent steps: each step needs the whole
// carry (forward) or adjoint (backward) of the one before.
//
// Both directions are built for the least time per dependent step:
// - the three cells run in blocks of their own (a grid of 3 x row
//   groups): they share nothing but the mask (the backward's cotangents
//   d_h1f, d_outs and d_h2f each reach one cell), so no cell waits on
//   another's phase;
// - a block walks R rows (1 or 4; the wrappers pick the fewest that make
//   the grid one wave of three blocks an SM, the launch bounds' count, so
//   B = 400 and 500 run 300 and 375 blocks at once; R = 2 was never the
//   fastest forward at any B measured) and has 4 lanes per unit j of its
//   cell: lane q takes the terms k = q, q+4, ... of every product of unit
//   j, for all R rows.  Each weight sits in a register of its lane and
//   feeds R independent FMAs; the vectors sit in shared memory as [k][R],
//   so one load gives entry k of all R rows (a float4 at R = 4),
//   conflict-free across the 4 lanes;
// - the widths are template arguments (max(U, H) padded to a multiple of
//   8, up to 64, with zero weights past the width), so the products
//   unroll; a product of K terms is K/4 dependent FMAs a lane, then two
//   __shfl_xor_sync rounds that leave lane q with the sums of its own row
//   (a reduce-scatter over the R rows), where the cell's elementwise math
//   runs once a row instead of once a lane;
// - each step's inputs are loaded into registers steps ahead, and the
//   outputs are stored by the lane that owns the row, so no device-memory
//   access sits on the chain; a step that all R rows mask is skipped whole
//   (its outputs still written).
// The forward's chain is, per step, two dependent K-term products in each
// GRU (the gates from h, then the candidate from r∘h) and one in the
// Time4LSTM (its four gates from m), each closed by exact expf/tanhf: a
// GRU takes two block barriers a step, the Time4LSTM one (m
// double-buffered).
//
// The backward keeps only the adjoint on the chain.  A GRU's step is the
// elementwise adjoint of its candidate and update gate, then dz = dca·Wcᵀ
// (K terms) and the reset gate's adjoint, then dh += [dgr | dgu]·Wgᵀ (2K
// terms; the dgu half is summed beside dz); the Time4LSTM's is the
// elementwise adjoint, then dm += d4·W4ᵀ (4H terms as four K-term sums).
// The transposed matrices sit in registers as the forward's do (lane q of
// unit j holds row j's terms q, q+4, ...), and no transcendental is left
// on the chain: step l-1's gates, candidates and LSTM activations, which
// depend only on carries[:, l-1] and the inputs, are recomputed during
// step l, beside its adjoint, with the forward's own products and order.
// Their weights sit in shared memory, each thread's in slots of its own
// (3K² floats a GRU, 4H² the Time4LSTM), so their reads cost issue slots,
// not latency on the chain.  The carries enter shared memory two steps
// ahead (double-buffered by the step's parity), the other inputs reach
// registers one step ahead.  A GRU takes two block barriers a step, the
// Time4LSTM one (its adjoints double-buffered).  The walk starts at the
// last step any of the block's rows holds (the steps after it pass the
// adjoint through unchanged: their outputs are zeroed up front), and a
// masked (row, step) inside writes zeros and passes its adjoint through.
// Every sum runs in a fixed order (no atomics), so a call's bits repeat.
// Measured on an H100 (chip_smoke.py phase 7), a reverse step takes
// ~2.9 us at B = 400 and 500 and at L = 250 alike, twice the forward's.
//
// Not the tensor cores, in either direction: the per-step products are
// [R, K] x [K, <= 4K] with R <= 4, so an m16 mma.sync tile would be mostly
// padding, and the 3xTF32 split that the gates need would add three
// dependent tensor-core latencies per k-step to the chain.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---- the forward ----

constexpr int kLanes = 4;        // lanes per unit, each a quarter of the terms
constexpr int kMaxWidth = 64;    // the widest U or H the kernels take
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

// ---- the backward ----

struct BwdArgs {
  const float *xg1, *xc1, *xw, *tn, *tl, *ot, *xg2, *xc2, *mask;
  const float *whg1, *whc1, *wh4, *whg2, *whc2;
  const float *carries, *d_h1f, *d_outs, *d_h2f;
  float *dxg1, *dxc1, *dxw, *dtn, *dtl, *dot, *dxg2, *dxc2, *dus, *zc;
  int B, L, U, H;
};

// The mask of the block's R rows at step l (0 past the batch or before
// step 0), kept raw until the step that tests it, as the forward keeps it.
template <int R>
__device__ __forceinline__ void step_mask(const BwdArgs& a, int row0, int l,
                                          float (&mk)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    mk[r] = l >= 0 && row0 + r < a.B ? a.mask[(size_t)(row0 + r) * a.L + l]
                                     : 0.f;
}

// The last step at which any of the block's R rows is valid, -1 if none.
template <int R>
__device__ int last_valid_step(const BwdArgs& a, int row0) {
  __shared__ int s_last[32];
  int last = -1;
  for (int l = threadIdx.x; l < a.L; l += blockDim.x)
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (row0 + r < a.B && a.mask[(size_t)(row0 + r) * a.L + l] != 0.f)
        last = l;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(kFull, last, o));
  if (threadIdx.x % 32 == 0) s_last[threadIdx.x / 32] = last;
  __syncthreads();
  for (int w = 0; w < (int)blockDim.x / 32; ++w) last = max(last, s_last[w]);
  return last;
}

// Zero columns off .. off+w of steps top .. L-1 of the block's rows in a
// [B, L, W] output, with all the block's threads.
template <int R>
__device__ void zero_tail(float* __restrict__ p, const BwdArgs& a, int row0,
                          int top, int W, int off, int w) {
  const int n = (a.L - top) * w;
  for (int r = 0; r < R && row0 + r < a.B; ++r)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      p[((size_t)(row0 + r) * a.L + top + i / w) * W + off + i % w] = 0.f;
}

template <int R, int G>
__device__ __forceinline__ void zero_acc(float (&acc)[R][G]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[r][g] = 0.f;
}

// acc[r] += lane q's terms of one transposed product for R rows: the
// vector s ([k][R]) at k = q + 4i times w[i], the weights in registers.
template <int KQ, int R>
__device__ __forceinline__ void add_dot(const float* s, int q,
                                        const float (&w)[KQ],
                                        float (&acc)[R][1]) {
#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    float v[R];
    load_rows<R>(s, i * kLanes + q, v);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = fmaf(v[r], w[i], acc[r][0]);
  }
}

template <int G>
__device__ __forceinline__ void load_vec(const float* p, float (&w)[G]) {
  if constexpr (G == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
  } else if constexpr (G == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    w[0] = t.x, w[1] = t.y;
  } else {
    w[0] = p[0];
  }
}

// partial_dots with the weights in this thread's slots of shared memory:
// w[g][i] at sw[i·T·G + g], T the block's threads (the recompute).
template <int KQ, int R, int G>
__device__ __forceinline__ void shared_dots(const float* s, int q,
                                            const float* sw,
                                            float (&acc)[R][G]) {
  constexpr int T = kLanes * kLanes * KQ;
  zero_acc<R, G>(acc);
#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    float v[R], w[G];
    load_rows<R>(s, i * kLanes + q, v);
    load_vec<G>(sw + i * T * G, w);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g) acc[r][g] = fmaf(v[r], w[g], acc[r][g]);
  }
}

// The backward of a GRU over K units (see gru_cell): from step top down
// to 0, with the adjoint dh of the lane's (row, unit) in a register,
// starting from dhf.  Writes dxg, dxc, columns zoff .. zoff+K of zc and,
// if dh0 is not null, the adjoint of h0.  Shared memory: the forward's
// weights in each thread's slots (3·KP² floats), then s_h (two [KP][R]:
// the carries of steps being recomputed, by parity), s_z (r∘h of the
// step recomputed), s_dca, s_dgu, s_dgr (the step's adjoints).
template <int KP, int R>
__device__ void gru_cell_bwd(const BwdArgs& a, const float* __restrict__ xg,
                             const float* __restrict__ xc,
                             const float* __restrict__ wg,
                             const float* __restrict__ wc,
                             const float* __restrict__ dhf,
                             float* __restrict__ dxg,
                             float* __restrict__ dxc,
                             float* __restrict__ dh0, int K, int off,
                             int zoff, float* sm, int row0, int top) {
  constexpr int KQ = KP / kLanes, T = kLanes * KP, S = KP * R;
  const int t = threadIdx.x, j = t / kLanes, q = t % kLanes;
  const int own = owned_row<R>(q), b = row0 + own, me = j * R + own;
  const bool st = stores<R>(q), live = j < K && b < a.B;
  const int L = a.L, CW = a.U + 3 * a.H, ZW = a.U + a.H;
  float* s_wg = sm;                  // [KQ][T][2]: Wg[k][j], Wg[k][K+j]
  float* s_wc = s_wg + 2 * KQ * T;   // [KQ][T]: Wc[k][j]
  float* s_h = s_wc + KQ * T;
  float* s_z = s_h + 2 * S;
  float* s_dca = s_z + S;
  float* s_dgu = s_dca + S;
  float* s_dgr = s_dgu + S;
  // the transposed matrices: row j, terms o = q + 4i
  float wct[KQ], wgt[2][KQ];
#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    const int k = i * kLanes + q;
    const bool in = j < K && k < K;
    wct[i] = in ? wc[j * K + k] : 0.f;
    wgt[0][i] = in ? wg[j * 2 * K + k] : 0.f;
    wgt[1][i] = in ? wg[j * 2 * K + K + k] : 0.f;
    s_wg[(i * T + t) * 2] = in ? wg[k * 2 * K + j] : 0.f;
    s_wg[(i * T + t) * 2 + 1] = in ? wg[k * 2 * K + K + j] : 0.f;
    s_wc[i * T + t] = in ? wc[k * K + j] : 0.f;
  }
  zero_tail<R>(dxg, a, row0, top, 2 * K, 0, 2 * K);
  zero_tail<R>(dxc, a, row0, top, K, 0, K);
  zero_tail<R>(a.zc, a, row0, top, ZW, zoff, K);
  // step s's gate and candidate terms and mask (needed from step s+1 on)
  // and its carry h (stored during step s+2)
  auto load_terms = [&](int s, float& xr_, float& xu_, float& xn_,
                        float (&mk_)[R]) {
    step_mask<R>(a, row0, s, mk_);
    xr_ = xu_ = xn_ = 0.f;
    if (live && s >= 0) {
      const size_t bl = (size_t)b * L + s;
      xr_ = xg[bl * 2 * K + j];
      xu_ = xg[bl * 2 * K + K + j];
      xn_ = xc[bl * K + j];
    }
  };
  auto load_h = [&](int s) {
    return live && s >= 0 ? a.carries[((size_t)b * L + s) * CW + off + j]
                          : 0.f;
  };
  float xr1, xu1, xn1, mk1[R];
  load_terms(top - 1, xr1, xu1, xn1, mk1);
  float h2 = load_h(top - 2);
  if (st) s_h[((top - 1) & 1) * S + me] = load_h(top - 1);
  float dh = live && dhf != nullptr ? dhf[(size_t)b * K + j] : 0.f;
  // step l's gates, candidate, carry and mask, recomputed during step l+1
  float r = 0.f, u = 0.f, n = 0.f, h = 0.f, mt = 0.f;
  bool act = false;
  __syncthreads();

  for (int l = top; l >= 0; --l) {
    float xr2, xu2, xn2, mk2[R];
    load_terms(l - 2, xr2, xu2, xn2, mk2);
    const float h3 = load_h(l - 3);
    const bool rec = any_valid<R>(mk1);  // step l-1 to recompute
    const float mt1 = pick<R>(mk1, own);
    const size_t bl = (size_t)b * L + l;
    const bool out = st && live && l < top;  // this lane writes step l
    if (!act && !rec) {  // no valid row at step l nor at l-1
      if (out) {
        dxg[bl * 2 * K + j] = 0.f;
        dxg[bl * 2 * K + K + j] = 0.f;
        dxc[bl * K + j] = 0.f;
      }
      if (st && live && l >= 1) a.zc[(bl - 1) * ZW + zoff + j] = 0.f;
      if (st) s_h[((l - 2) & 1) * S + me] = h2;
      __syncthreads();
    } else {
      // The adjoint and the recompute run in one basic block a phase (in
      // branches of their own they measured the same).  A step without a
      // valid row (act false) runs as masked rows do: mt = 0, zero
      // outputs, dh passed through.
      // 1: step l's candidate and update-gate adjoints; step l-1's gate
      // products
      const bool on = mt != 0.f;
      const float dhn = mt * dh;
      const float dca = dhn * (1.f - u) * (1.f - n * n);
      const float dgu = dhn * (h - n) * u * (1.f - u);
      if (st) {
        s_dca[me] = dca;
        s_dgu[me] = dgu;
      }
      if (out) {
        dxc[bl * K + j] = on ? dca : 0.f;
        dxg[bl * 2 * K + K + j] = on ? dgu : 0.f;
      }
      float gacc[R][2];
      shared_dots<KQ, R, 2>(s_h + ((l - 1) & 1) * S, q, s_wg + 2 * t, gacc);
      __syncthreads();
      // 2: dz = dca·Wcᵀ and the reset gate's adjoint, the dgu half of
      // dh's product; step l-1's gates and r∘h
      float zacc[R][1], hacc[R][1], dz[1], g[2];
      zero_acc<R, 1>(zacc);
      zero_acc<R, 1>(hacc);
      add_dot<KQ, R>(s_dca, q, wct, zacc);
      add_dot<KQ, R>(s_dgu, q, wgt[1], hacc);
      reduce_lanes<R, 1>(zacc, q, dz);
      reduce_lanes<R, 2>(gacc, q, g);
      const float dgr = dz[0] * h * r * (1.f - r);
      if (st) s_dgr[me] = dgr;
      if (out) dxg[bl * 2 * K + j] = on ? dgr : 0.f;
      dh = (1.f - mt) * dh + u * dhn + dz[0] * r;
      r = sigmoidf_(g[0] + xr1);
      u = sigmoidf_(g[1] + xu1);
      h = s_h[((l - 1) & 1) * S + me];
      const float z = r * h;
      if (st) s_z[me] = z;
      if (st && live && l >= 1)
        a.zc[(bl - 1) * ZW + zoff + j] = mt1 != 0.f ? z : 0.f;
      if (st) s_h[((l - 2) & 1) * S + me] = h2;
      __syncthreads();
      // 3: the dgr half of dh's product; step l-1's candidate
      float red[1], cacc[R][1], c[1];
      add_dot<KQ, R>(s_dgr, q, wgt[0], hacc);
      shared_dots<KQ, R, 1>(s_z, q, s_wc + t, cacc);
      reduce_lanes<R, 1>(hacc, q, red);
      reduce_lanes<R, 1>(cacc, q, c);
      dh += red[0];
      n = tanhf(c[0] + xn1);
    }
    act = rec, mt = mt1;
    xr1 = xr2, xu1 = xu2, xn1 = xn2, h2 = h3;
#pragma unroll
    for (int r = 0; r < R; ++r) mk1[r] = mk2[r];
  }
  if (dh0 != nullptr && st && live) dh0[(size_t)b * K + j] = dh;
}

// The Time4LSTM's backward over H units (see lstm_cell), the adjoints dc
// and dm of the lane's (row, unit) in registers, starting from zero, and
// d_outs added to dm at each step.  Writes dxw, dtn, dtl and dot.  Shared
// memory: the forward's weights in each thread's slots (4·KP² floats),
// then s_m (two [KP][R]: the carries m of steps being recomputed, by
// parity) and two [4][KP][R] (the gates' adjoints, by parity).
template <int KP, int R>
__device__ void lstm_cell_bwd(const BwdArgs& a, float* sm, int row0,
                              int top) {
  constexpr int KQ = KP / kLanes, T = kLanes * KP, S = KP * R;
  const int t = threadIdx.x, j = t / kLanes, q = t % kLanes;
  const int own = owned_row<R>(q), b = row0 + own, me = j * R + own;
  const int H = a.H, L = a.L, CW = a.U + 3 * H;
  const bool st = stores<R>(q), live = j < H && b < a.B;
  float* s_w4 = sm;                 // [KQ][T][4]: W4[k][g·H + j]
  float* s_m = s_w4 + 4 * KQ * T;
  float* s_d4 = s_m + 2 * S;
  float w4t[4][KQ];
#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    const int k = i * kLanes + q;
    const bool in = j < H && k < H;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      w4t[g][i] = in ? a.wh4[j * 4 * H + g * H + k] : 0.f;
      s_w4[(i * T + t) * 4 + g] = in ? a.wh4[k * 4 * H + g * H + j] : 0.f;
    }
  }
  zero_tail<R>(a.dxw, a, row0, top, 4 * H, 0, 4 * H);
  zero_tail<R>(a.dtn, a, row0, top, H, 0, H);
  zero_tail<R>(a.dtl, a, row0, top, H, 0, H);
  zero_tail<R>(a.dot, a, row0, top, H, 0, H);
  // step s's terms (needed from step s+1 on): the four gate terms, tn,
  // tl, ot, the carry c, d_outs and the mask; and its carry m (stored
  // during step s+2)
  struct Terms {
    float x[4], tn, tl, ot, c, dout, mk[R];
  };
  auto load_terms = [&](int s, Terms& v) {
    step_mask<R>(a, row0, s, v.mk);
    v.x[0] = v.x[1] = v.x[2] = v.x[3] = 0.f;
    v.tn = v.tl = v.ot = v.c = v.dout = 0.f;
    if (live && s >= 0) {
      const size_t bl = (size_t)b * L + s;
#pragma unroll
      for (int g = 0; g < 4; ++g) v.x[g] = a.xw[bl * 4 * H + g * H + j];
      v.tn = a.tn[bl * H + j];
      v.tl = a.tl[bl * H + j];
      v.ot = a.ot[bl * H + j];
      v.c = a.carries[bl * CW + a.U + j];
      v.dout = a.d_outs[bl * H + j];
    }
  };
  auto load_m = [&](int s) {
    return live && s >= 0
               ? a.carries[((size_t)b * L + s) * CW + a.U + H + j]
               : 0.f;
  };
  Terms in1;
  load_terms(top - 1, in1);
  float m2 = load_m(top - 2);
  if (st) s_m[((top - 1) & 1) * S + me] = load_m(top - 1);
  float dc = 0.f, dm = 0.f;
  // step l's activations, carry c, d_outs and mask, recomputed during
  // step l+1
  float si = 0.f, stn = 0.f, tj = 0.f, sf = 0.f, stl = 0.f, so = 0.f;
  float tc = 0.f, c = 0.f, dout = 0.f, mt = 0.f;
  bool act = false;
  __syncthreads();

  for (int l = top; l >= 0; --l) {
    Terms in2;
    load_terms(l - 2, in2);
    const float m3 = load_m(l - 3);
    const bool rec = any_valid<R>(in1.mk);  // step l-1 to recompute
    const size_t bl = (size_t)b * L + l;
    const bool out = st && live && l < top;  // this lane writes step l
    float* d4s = s_d4 + (l & 1) * 4 * S;
    if (!act && !rec) {  // no valid row at step l nor at l-1
      if (out) {
#pragma unroll
        for (int g = 0; g < 4; ++g) a.dxw[bl * 4 * H + g * H + j] = 0.f;
        a.dtn[bl * H + j] = 0.f;
        a.dtl[bl * H + j] = 0.f;
        a.dot[bl * H + j] = 0.f;
      }
      // the one barrier a step the double buffers rest on: without it a
      // warp could write d4s[l & 1] while another still reads it for
      // step l+2 (the condition is the block's, so every thread waits)
      __syncthreads();
    } else {
      // as in gru_cell_bwd: one basic block a phase, and a step without a
      // valid row runs as masked rows do
      // A: step l's adjoints of the gates, the time gates and c
      const bool on = mt != 0.f;
      const float dmn = mt * (dm + dout);
      const float dcn = mt * dc + dmn * so * (1.f - tc * tc);
      const float d4[4] = {dcn * stn * tj * si * (1.f - si),
                           dcn * si * stn * (1.f - tj * tj),
                           dcn * stl * c * sf * (1.f - sf),
                           dmn * tc * so * (1.f - so)};
      if (st) {
#pragma unroll
        for (int g = 0; g < 4; ++g) d4s[g * S + me] = d4[g];
      }
      if (out) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          a.dxw[bl * 4 * H + g * H + j] = on ? d4[g] : 0.f;
        a.dtn[bl * H + j] = on ? dcn * si * tj * stn * (1.f - stn) : 0.f;
        a.dtl[bl * H + j] = on ? dcn * sf * c * stl * (1.f - stl) : 0.f;
        a.dot[bl * H + j] = on ? d4[3] : 0.f;
      }
      dc = (1.f - mt) * dc + dcn * sf * stl;
      dm = (1.f - mt) * dm;
      __syncthreads();
      // B: dm += d4·W4ᵀ, four K-term sums; step l-1's gates and
      // activations
      float acc[4][R][1], sum[R][1], red[1], gacc[R][4], g4[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        zero_acc<R, 1>(acc[g]);
        add_dot<KQ, R>(d4s + g * S, q, w4t[g], acc[g]);
      }
      shared_dots<KQ, R, 4>(s_m + ((l - 1) & 1) * S, q, s_w4 + 4 * t, gacc);
#pragma unroll
      for (int r = 0; r < R; ++r)
        sum[r][0] = (acc[0][r][0] + acc[1][r][0]) +
                    (acc[2][r][0] + acc[3][r][0]);
      reduce_lanes<R, 1>(sum, q, red);
      reduce_lanes<R, 4>(gacc, q, g4);
      dm += red[0];
      const float gi = g4[0] + in1.x[0], gj = g4[1] + in1.x[1];
      const float gf = g4[2] + in1.x[2], go = (g4[3] + in1.x[3]) + in1.ot;
      sf = sigmoidf_(gf + 1.f);
      stl = sigmoidf_(in1.tl);
      si = sigmoidf_(gi);
      stn = sigmoidf_(in1.tn);
      tj = tanhf(gj);
      so = sigmoidf_(go);
      c = in1.c;
      tc = tanhf(sf * stl * c + si * stn * tj);
    }
    dout = in1.dout, mt = pick<R>(in1.mk, own);
    if (st) s_m[((l - 2) & 1) * S + me] = m2;
    act = rec, m2 = m3;
    in1 = in2;
  }
}

// Floats of dynamic shared memory a backward block takes: the Time4LSTM's
// layout, the larger of the cells'.
template <int KP, int R>
constexpr size_t backward_smem_floats() {
  return 4 * KP * KP + 10 * KP * R;
}

// Block 3·i + cell walks rows R·i .. R·i+R-1 of one cell back in time, as
// clsr_scan_kernel walks them forward.
template <int KP, int R>
__global__ void __launch_bounds__(kLanes * KP, kBlocksPerSM)
    clsr_scan_backward_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int cell = blockIdx.x % 3, row0 = (blockIdx.x / 3) * R;
  const int top = last_valid_step<R>(a, row0) + 1;
  if (cell == 0)
    gru_cell_bwd<KP, R>(a, a.xg1, a.xc1, a.whg1, a.whc1, a.d_h1f, a.dxg1,
                        a.dxc1, a.dus, a.U, 0, 0, smem, row0, top);
  else if (cell == 1)
    lstm_cell_bwd<KP, R>(a, smem, row0, top);
  else
    gru_cell_bwd<KP, R>(a, a.xg2, a.xc2, a.whg2, a.whc2, a.d_h2f, a.dxg2,
                        a.dxc2, nullptr, a.H, a.U + 2 * a.H, a.U, smem, row0,
                        top);
}

template <int KP, int R>
int launch_backward(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = backward_smem_floats<KP, R>() * sizeof(float);
  if constexpr (smem > 48 * 1024) {
    // past 48 KB a kernel must be let use more, once on each device
    static std::atomic<unsigned long long> raised{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(raised.load() & bit)) {
      err = cudaFuncSetAttribute(clsr_scan_backward_kernel<KP, R>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      raised.fetch_or(bit);
    }
  }
  const int groups = (a.B + R - 1) / R;
  clsr_scan_backward_kernel<KP, R>
      <<<3 * groups, kLanes * KP, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KP>
int backward_rows(const BwdArgs& a, int rows, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_backward<KP, 1>(a, stream);
    case 4: return launch_backward<KP, 4>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

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

// The backward over `rows` rows a block (1 or 4), the same widths as the
// forward.  The arguments before `rows` are those of the first backward
// kernel, in the same order.
extern "C" int clsr_scan_backward(
    const float* xg1, const float* xc1, const float* xw, const float* tn,
    const float* tl, const float* ot, const float* xg2, const float* xc2,
    const float* mask, const float* whg1, const float* whc1,
    const float* wh4, const float* whg2, const float* whc2,
    const float* carries, const float* d_h1f, const float* d_outs,
    const float* d_h2f, float* dxg1, float* dxc1, float* dxw, float* dtn,
    float* dtl, float* dot, float* dxg2, float* dxc2, float* dus, float* zc,
    int B, int L, int U, int H, int rows, void* stream) {
  if (B < 0 || L < 1 || U < 1 || H < 1 || U > kMaxWidth || H > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const BwdArgs a{xg1,  xc1,  xw,   tn,   tl,   ot,    xg2,    xc2,  mask,
                  whg1, whc1, wh4,  whg2, whc2, carries, d_h1f, d_outs,
                  d_h2f, dxg1, dxc1, dxw, dtn,  dtl,   dot,   dxg2, dxc2,
                  dus,  zc,   B,    L,    U,    H};
  const auto s = static_cast<cudaStream_t>(stream);
  switch ((max(U, H) + 7) / 8 * 8) {
    case 8: return backward_rows<8>(a, rows, s);
    case 16: return backward_rows<16>(a, rows, s);
    case 24: return backward_rows<24>(a, rows, s);
    case 32: return backward_rows<32>(a, rows, s);
    case 40: return backward_rows<40>(a, rows, s);
    case 48: return backward_rows<48>(a, rows, s);
    case 56: return backward_rows<56>(a, rows, s);
    default: return backward_rows<64>(a, rows, s);
  }
}

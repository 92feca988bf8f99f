// K1: fused eval-mode grouped target-attention scorer, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel clsr_tpu/ops/pallas_attention.py:147
// _scorer_kernel (driven by fused_eval_attention there).  For every query
// (b, g) and history position l it computes
//
//   x0 = kp[l]·Wk_eff + q[g]·Wq_eff + (kp[l]∘q[g])·Wm     (split first layer)
//   y0 = relu(a0·x0 + c0)                                 (bias + BN folded)
//   y1 = relu(a1·(y0·W1) + c1)
//   logit = y1·w2                            (b2 cancels in the softmax)
//
// then a masked (-2^32+1) softmax over l and the weighted sum of the raw
// keys, out[b, g] = sum_l softmax(logit)_l · keys[b, l]  ([B, G, DK], f32).
//
// What bounds it on an H100: the arithmetic.  Per (b, valid l, g) row it
// does D·H0 + H0·H1 multiply-adds (9,600 at the clsr.yaml widths) on inputs
// of a few MB, far above the card's ops-per-byte line.  In f32 FMAs the
// bound is the 67 TFLOP/s FP32 rate; this kernel runs the two products on
// the tensor cores instead (495 TFLOP/s in TF32), three products each.
//
// Design (after the TPU kernel's shape, not its grid): the scorer is two
// matrix products over a tile of (query, position) rows, as the Pallas
// kernel computes it over its Lb·Gb rows.
//  - Rows, not candidates.  A warp owns one query q = b·G + g at a time
//    and, per chunk of kLC history positions, the rows (q, l) of the valid
//    positions only, compacted by ballots: masked positions do no MLP work
//    (their logit is the mask constant, whose softmax weight is exactly 0
//    once any position is valid).  An all-masked query gets uniform weights
//    over the real L, as the plain path does.  The warp runs the rows as
//    pairs of 16-row m-tiles that share every weight fragment it loads
//    (one m-tile for a last 16 rows or fewer).  Warps share nothing but
//    the weights, so after the block stages them no barrier is taken: a
//    warp's latencies (the keys and kp loads, its softmax) hide behind
//    the other warps' products.
//  - Tensor cores.  x0 - q·Wq_eff = [kp∘q | kp]·[Wm; Wk_eff] (K = 2D) and
//    y0·W1 (K = H0) run as mma.sync m16n8k8 in TF32 with the 3xTF32 split:
//    each f32 operand is a TF32 high part plus a remainder, and
//    lo·hi + hi·lo + hi·hi keeps the products at about f32 accuracy (one
//    TF32 pass keeps ~3 digits).  Within each k-step the K index is
//    permuted (k = t -> feature 8 ks + 2t, k = t + 4 -> 8 ks + 2t + 1), as
//    the weights are staged, so each A operand pair is one float2 load and
//    the first product's accumulator fragment is the second one's A: y0
//    never leaves registers.
//  - Epilogues in registers.  q·Wq_eff is computed once per query, in
//    f32 from Wq_eff in shared memory, and folded into the layer-0 shift
//    (cq = a0·tq + c0); the affine + relu epilogues run on the
//    accumulator fragments; the logit is a dot with w2 over each thread's
//    columns, summed across the row's four owners by shuffles.  The
//    softmax is online across chunks.
//  - Shared memory: [Wm; Wk_eff] and W1 in mma fragment order, already
//    split into TF32 high parts and remainders (one 16-byte load per
//    fragment, no conversions and no bank conflicts in the loop), and
//    Wq_eff, staged once per block; ~168 KB at D = 80, one block of 12
//    warps an SM.  The grid is persistent: as many blocks as fit at once,
//    each warp walking queries warp_id, + n_warps, ...; with fewer queries
//    than resident warps a block sets fewer of its warps on queries and
//    more blocks run, so the queries spread over the SMs.  The
//    shared-memory attribute and that block count are set up once per
//    device and process.

#include <cuda_runtime.h>
#include <math.h>
#include <algorithm>
#include <mutex>

#include "tf32_mma.cuh"

namespace {

using clsr::SplitA;
using clsr::mma3;
using clsr::split_a;
using clsr::stage_fragment;

constexpr int kWarps = 12;
constexpr int kThreads = 32 * kWarps;
constexpr int kLC = 64;                       // history positions a chunk
constexpr int kMaxDevices = 64;

template <int D, int H0, int H1, int DK>
struct Layout {
  static constexpr int KS0 = D / 8;           // k-steps of each half of x0
  static constexpr int N0 = H0 / 8;           // n-tiles of x0
  static constexpr int KS1 = H0 / 8;          // k-steps of x1
  static constexpr int N1 = H1 / 8;           // n-tiles of x1
  // offsets in floats; a fragment is (b0 hi, b1 hi, b0 lo, b1 lo)
  static constexpr int wb0 = 0;                     // [2 KS0][N0][32][4]
  static constexpr int wb1 = wb0 + 4 * D * H0;      // [KS1][N1][32][4]
  static constexpr int a0 = wb1 + 2 * H0 * H1;      // [H0]
  static constexpr int a1 = a0 + H0;                // [H1]
  static constexpr int c1 = a1 + H1;                // [H1]
  static constexpr int w2 = c1 + H1;                // [H1]
  static constexpr int wq = w2 + H1;                // [D][H0]
  static constexpr int warp0 = wq + D * H0;         // per warp, below
  static constexpr int qs = 0;                      // [D]
  static constexpr int cq = qs + D;                 // [H0]
  static constexpr int logit = cq + H0;             // [kLC]
  static constexpr int rows = logit + kLC;          // int [kLC]
  static constexpr int per_warp = rows + kLC;
  static constexpr int total = warp0 + kWarps * per_warp;
  static_assert(D % 8 == 0 && H0 % 8 == 0 && H1 % 8 == 0 && DK <= 64,
                "widths must be multiples of the 8-wide mma tiles");
  static_assert(a0 % 4 == 0 && warp0 % 2 == 0 && per_warp % 2 == 0,
                "fragments are 16-byte loads, q rows 8-byte loads");
};

// The logits of the 16·MT rows r0.. of the warp's chunk into its logit
// buffer; rows past n_rows repeat the last row and are not written.  The
// MT m-tiles share every weight fragment the warp loads.
template <int D, int H0, int H1, int DK, int MT>
__device__ __forceinline__ void mlp_tile(const float* sm, float* ws,
                                         const float* kpb, int r0,
                                         int n_rows, int lane) {
  using Lay = Layout<D, H0, H1, DK>;
  const int* rows = reinterpret_cast<const int*>(ws + Lay::rows);
  const int g = lane >> 2, t = lane & 3;
  const float2* kpA[MT];
  const float2* kpB[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int ra = min(r0 + 16 * m + g, n_rows - 1);
    const int rb = min(r0 + 16 * m + g + 8, n_rows - 1);
    kpA[m] = reinterpret_cast<const float2*>(kpb + rows[ra] * D) + t;
    kpB[m] = reinterpret_cast<const float2*>(kpb + rows[rb] * D) + t;
  }
  const float2* qv = reinterpret_cast<const float2*>(ws + Lay::qs) + t;
  const float4* wb0 = reinterpret_cast<const float4*>(sm + Lay::wb0) + lane;
  const float4* wb1 = reinterpret_cast<const float4*>(sm + Lay::wb1) + lane;

  // x0 - q·Wq_eff = [kp∘q | kp]·[Wm; Wk_eff]
  float acc[MT][Lay::N0][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < Lay::N0; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
  float2 nA[MT], nB[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    nA[m] = __ldg(kpA[m]);
    nB[m] = __ldg(kpB[m]);
  }
#pragma unroll 1
  for (int ks = 0; ks < Lay::KS0; ++ks) {
    const float2 qq = qv[4 * ks];
    SplitA sq[MT], sk[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float2 ka = nA[m], kb = nB[m];
      if (ks + 1 < Lay::KS0) {   // the next k-step's kp, in flight meanwhile
        nA[m] = __ldg(kpA[m] + 4 * (ks + 1));
        nB[m] = __ldg(kpB[m] + 4 * (ks + 1));
      }
      const float pk[4] = {ka.x, kb.x, ka.y, kb.y};
      const float pq[4] = {ka.x * qq.x, kb.x * qq.x, ka.y * qq.y,
                           kb.y * qq.y};
      sq[m] = split_a(pq);
      sk[m] = split_a(pk);
    }
#pragma unroll
    for (int n = 0; n < Lay::N0; ++n) {
      const float4 b = wb0[(ks * Lay::N0 + n) * 32];
#pragma unroll
      for (int m = 0; m < MT; ++m) mma3(acc[m][n], sq[m], b);
    }
#pragma unroll
    for (int n = 0; n < Lay::N0; ++n) {
      const float4 b = wb0[((Lay::KS0 + ks) * Lay::N0 + n) * 32];
#pragma unroll
      for (int m = 0; m < MT; ++m) mma3(acc[m][n], sk[m], b);
    }
  }
  // y0 = relu(a0·x0 + c0), with q·Wq_eff inside cq, laid out as the A
  // fragments of the second product
  const float* cq = ws + Lay::cq;
#pragma unroll
  for (int n = 0; n < Lay::N0; ++n) {
    const int h = 8 * n + 2 * t;
    const float s0 = sm[Lay::a0 + h], s1 = sm[Lay::a0 + h + 1];
    const float c0 = cq[h], c1 = cq[h + 1];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float y00 = fmaxf(fmaf(s0, acc[m][n][0], c0), 0.f);
      const float y01 = fmaxf(fmaf(s1, acc[m][n][1], c1), 0.f);
      const float y10 = fmaxf(fmaf(s0, acc[m][n][2], c0), 0.f);
      const float y11 = fmaxf(fmaf(s1, acc[m][n][3], c1), 0.f);
      acc[m][n][0] = y00;   // row g,   k = t
      acc[m][n][1] = y10;   // row g+8, k = t
      acc[m][n][2] = y01;   // row g,   k = t+4
      acc[m][n][3] = y11;   // row g+8, k = t+4
    }
  }
  float acc1[MT][Lay::N1][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < Lay::N1; ++n)
      acc1[m][n][0] = acc1[m][n][1] = acc1[m][n][2] = acc1[m][n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Lay::KS1; ++ks) {
    SplitA sy[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) sy[m] = split_a(acc[m][ks]);
#pragma unroll
    for (int n = 0; n < Lay::N1; ++n) {
      const float4 b = wb1[(ks * Lay::N1 + n) * 32];
#pragma unroll
      for (int m = 0; m < MT; ++m) mma3(acc1[m][n], sy[m], b);
    }
  }
  // logit = relu(a1·x1 + c1)·w2, summed over the row's four owners
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float lA = 0.f, lB = 0.f;
#pragma unroll
    for (int n = 0; n < Lay::N1; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int h = 8 * n + 2 * t + j;
        const float s = sm[Lay::a1 + h], c = sm[Lay::c1 + h];
        const float w = sm[Lay::w2 + h];
        lA = fmaf(w, fmaxf(fmaf(s, acc1[m][n][j], c), 0.f), lA);
        lB = fmaf(w, fmaxf(fmaf(s, acc1[m][n][2 + j], c), 0.f), lB);
      }
    }
    lA += __shfl_xor_sync(0xffffffffu, lA, 1);
    lB += __shfl_xor_sync(0xffffffffu, lB, 1);
    lA += __shfl_xor_sync(0xffffffffu, lA, 2);
    lB += __shfl_xor_sync(0xffffffffu, lB, 2);
    const int ra = r0 + 16 * m + g;
    if (t == 0) {
      if (ra < n_rows) ws[Lay::logit + ra] = lA;
      if (ra + 8 < n_rows) ws[Lay::logit + ra + 8] = lB;
    }
  }
}

template <int D, int H0, int H1, int DK>
__global__ void __launch_bounds__(kThreads, 1)
eval_scorer_kernel(const float* __restrict__ keys,
                   const float* __restrict__ kp,
                   const float* __restrict__ q,
                   const float* __restrict__ mask,
                   const float* __restrict__ wk,
                   const float* __restrict__ wq,
                   const float* __restrict__ wm,
                   const float* __restrict__ a0,
                   const float* __restrict__ c0,
                   const float* __restrict__ w1,
                   const float* __restrict__ a1,
                   const float* __restrict__ c1,
                   const float* __restrict__ w2,
                   float* __restrict__ out, int B, int L, int G,
                   int wpb) {
  using Lay = Layout<D, H0, H1, DK>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ws = sm + Lay::warp0 + warp * Lay::per_warp;
  int* rows = reinterpret_cast<int*>(ws + Lay::rows);

  // ---- weights in mma fragment order, once per block ------------------
  // fragment (ks, n, lane = 4g + t): rows 8 ks + 2t and 8 ks + 2t + 1 of
  // column 8 n + g; the first product's K runs over [Wm; Wk_eff]
#pragma unroll 4
  for (int e = tid; e < 2 * Lay::KS0 * Lay::N0 * 32; e += kThreads) {
    const int ln = e & 31, n = (e >> 5) % Lay::N0, ks = (e >> 5) / Lay::N0;
    stage_fragment(sm + Lay::wb0 + 4 * e, ks < Lay::KS0 ? wm : wk,
                   8 * (ks % Lay::KS0) + 2 * (ln & 3), 8 * n + (ln >> 2), H0);
  }
#pragma unroll 4
  for (int e = tid; e < Lay::KS1 * Lay::N1 * 32; e += kThreads) {
    const int ln = e & 31, n = (e >> 5) % Lay::N1, ks = (e >> 5) / Lay::N1;
    stage_fragment(sm + Lay::wb1 + 4 * e, w1, 8 * ks + 2 * (ln & 3),
                   8 * n + (ln >> 2), H1);
  }
  for (int i = tid; i < D * H0; i += kThreads) sm[Lay::wq + i] = wq[i];
  for (int i = tid; i < H0; i += kThreads) sm[Lay::a0 + i] = a0[i];
  for (int i = tid; i < H1; i += kThreads) {
    sm[Lay::a1 + i] = a1[i];
    sm[Lay::c1 + i] = c1[i];
    sm[Lay::w2 + i] = w2[i];
  }
  __syncthreads();   // the only block barrier: warps share nothing else

  // the first wpb warps of a block take queries (fewer than kWarps when
  // there are few queries, so that they spread over more SMs)
  const int n_q = B * G;
  for (int qi = warp < wpb ? blockIdx.x * wpb + warp : n_q; qi < n_q;
       qi += gridDim.x * wpb) {
    const int b = qi / G;
    for (int d = lane; d < D; d += 32) ws[Lay::qs + d] = q[(size_t)qi * D + d];
    __syncwarp();
    // cq = a0·(q·Wq_eff) + c0: each lane owns channels lane + 32j
    constexpr int kHC = (H0 + 31) / 32;
    float s[kHC] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = ws[Lay::qs + d];
#pragma unroll
      for (int j = 0; j < kHC; ++j)
        s[j] = fmaf(qd, sm[Lay::wq + d * H0 + min(lane + 32 * j, H0 - 1)], s[j]);
    }
#pragma unroll
    for (int j = 0; j < kHC; ++j) {
      const int h = lane + 32 * j;
      if (h < H0) ws[Lay::cq + h] = fmaf(sm[Lay::a0 + h], s[j], __ldg(c0 + h));
    }
    __syncwarp();

    float m_run = -INFINITY, s_run = 0.f, acc_lo = 0.f, acc_hi = 0.f;
    for (int l0 = 0; l0 < L; l0 += kLC) {
      const int n = min(kLC, L - l0);
      // the chunk's valid positions, compacted
      bool v[kLC / 32];
#pragma unroll
      for (int j = 0; j < kLC / 32; ++j) {
        const int lc = 32 * j + lane;
        v[j] = lc < n && mask[(size_t)b * L + l0 + lc] > 0.f;
      }
      int n_rows = 0;
#pragma unroll
      for (int j = 0; j < kLC / 32; ++j) {
        const unsigned bal = __ballot_sync(0xffffffffu, v[j]);
        if (v[j]) rows[n_rows + __popc(bal & ((1u << lane) - 1u))] = 32 * j + lane;
        n_rows += __popc(bal);
      }
      __syncwarp();
      if (n_rows == 0) continue;
      const float* kpb = kp + ((size_t)b * L + l0) * D;
      for (int r0 = 0; r0 < n_rows; r0 += 32) {
        if (n_rows - r0 > 16)
          mlp_tile<D, H0, H1, DK, 2>(sm, ws, kpb, r0, n_rows, lane);
        else
          mlp_tile<D, H0, H1, DK, 1>(sm, ws, kpb, r0, n_rows, lane);
      }
      __syncwarp();
      // online softmax over the chunk's rows and the weighted keys
      float cmax = -INFINITY;
      for (int r = lane; r < n_rows; r += 32)
        cmax = fmaxf(cmax, ws[Lay::logit + r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
      const float m_new = fmaxf(m_run, cmax);
      const float rescale = expf(m_run - m_new);
      s_run *= rescale;
      acc_lo *= rescale;
      acc_hi *= rescale;
      const float* kb = keys + ((size_t)b * L + l0) * DK;
#pragma unroll 8
      for (int r = 0; r < n_rows; ++r) {
        const float p = expf(ws[Lay::logit + r] - m_new);
        const float* kl = kb + rows[r] * DK;
        s_run += p;
        if (lane < DK) acc_lo = fmaf(p, kl[lane], acc_lo);
        if (lane + 32 < DK) acc_hi = fmaf(p, kl[lane + 32], acc_hi);
      }
      m_run = m_new;
      __syncwarp();   // rows and logits are rewritten by the next chunk
    }
    if (s_run == 0.f) {   // all positions masked: uniform weights over L
      const float* kb = keys + (size_t)b * L * DK;
      for (int l = 0; l < L; ++l) {
        if (lane < DK) acc_lo += kb[l * DK + lane];
        if (lane + 32 < DK) acc_hi += kb[l * DK + lane + 32];
      }
      s_run = (float)L;
    }
    const float inv = 1.f / s_run;
    float* o = out + (size_t)qi * DK;
    if (lane < DK) o[lane] = acc_lo * inv;
    if (lane + 32 < DK) o[lane + 32] = acc_hi * inv;
    __syncwarp();   // q and cq are rewritten by the next query
  }
}

// Once per device: the shared-memory opt-in and the persistent grid size
// (resident blocks an SM x SMs).
struct Setup {
  std::once_flag once;
  cudaError_t err = cudaSuccess;
  int max_blocks = 0;
};

template <int D, int H0, int H1, int DK>
int launch(const float* keys, const float* kp, const float* q,
           const float* mask, const float* wk, const float* wq,
           const float* wm, const float* a0, const float* c0,
           const float* w1, const float* a1, const float* c1,
           const float* w2, float* out, int B, int L, int G,
           cudaStream_t stream) {
  auto kern = eval_scorer_kernel<D, H0, H1, DK>;
  constexpr size_t smem = sizeof(float) * Layout<D, H0, H1, DK>::total;
  static Setup setup[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Setup& s = setup[dev];
  std::call_once(s.once, [&] {
    int per_sm = 0, sms = 0;
    s.err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (s.err == cudaSuccess)
      s.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                            kThreads, smem);
    if (s.err == cudaSuccess)
      s.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    s.max_blocks = per_sm * sms;
    if (s.err == cudaSuccess && s.max_blocks == 0)
      s.err = cudaErrorInvalidConfiguration;
  });
  if (s.err != cudaSuccess) return (int)s.err;
  // warps a block sets on queries: all kWarps once the queries fill
  // every resident block, fewer (and more blocks) below that
  const int n_q = B * G;
  const int per_block =
      std::min(kWarps, (n_q + s.max_blocks - 1) / s.max_blocks);
  const int grid = std::min(s.max_blocks, (n_q + per_block - 1) / per_block);
  kern<<<grid, kThreads, smem, stream>>>(keys, kp, q, mask, wk, wq, wm, a0,
                                         c0, w1, a1, c1, w2, out, B, L, G,
                                         per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// Widths compiled in: (D, DK, H0, H1) = (80, 40, 80, 40), the clsr.yaml
// short-term scorer, and (40, 40, 80, 40), its long-term scorer (which
// takes this kernel in train mode, at G = 1).  Any other returns
// cudaErrorInvalidValue.
extern "C" int clsr_eval_scorer(const float* keys, const float* kp,
                                const float* q, const float* mask,
                                const float* wk, const float* wq,
                                const float* wm, const float* a0,
                                const float* c0, const float* w1,
                                const float* a1, const float* c1,
                                const float* w2, float* out, int B, int L,
                                int G, int D, int DK, int H0, int H1,
                                void* stream) {
  if (D == 80 && DK == 40 && H0 == 80 && H1 == 40)
    return launch<80, 80, 40, 40>(keys, kp, q, mask, wk, wq, wm, a0, c0, w1,
                                  a1, c1, w2, out, B, L, G,
                                  static_cast<cudaStream_t>(stream));
  if (D == 40 && DK == 40 && H0 == 80 && H1 == 40)
    return launch<40, 80, 40, 40>(keys, kp, q, mask, wk, wq, wm, a0, c0, w1,
                                  a1, c1, w2, out, B, L, G,
                                  static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}

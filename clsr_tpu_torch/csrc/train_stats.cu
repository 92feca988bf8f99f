// K3a + K3b: batch statistics of the train-mode target-attention scorer,
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernels clsr_tpu/ops/pallas_attention.py:_stats0_kernel
// (K3a) and :_stats1_kernel (K3b), both driven by _stats_call there.  For
// every (b, l, g) row of the [B, L, G] extent (every history position,
// masked or not; rows past the real L or B never count):
//
//   x0 = kp[b,l]·Wk_eff + q[b,g]·Wq_eff + (kp[b,l]∘q[b,g])·Wm   (biasless)
//   K3a: per-channel Σx0 and Σx0²                          ([H0] each)
//   K3b: y0 = relu(a0·x0 + c0), x1 = y0·W1 (biasless), Σx1 and Σx1² ([H1])
//
// where (a0, c0) is the BN affine that K3a's statistics fold into.  Both
// feed the two-pass train-mode scorer (ops/fused_train_attention.py); the
// [B, L, G, H] activations never reach device memory.
//
// What bounds it on an H100: the arithmetic.  Per row, D·H0 (+ H0·H1 for
// K3b) multiply-adds on inputs of a few MB: at the clsr.yaml train shape
// (B = 400, L = 50, G = 5, D = 80) about 1.6 GFLOP (K3a) and 2.2 GFLOP
// (K3b) against ~7 MB, far above the card's ops-per-byte line.  In f32
// FMAs the bound is the 67 TFLOP/s FP32 rate; this kernel runs both
// products on the tensor cores instead (495 TFLOP/s in TF32), three
// products each.
//
// Design (after K1, csrc/eval_scorer.cu, not the TPU grid):
//  - Rows on the tensor cores.  A warp owns one query q = b·G + g at a
//    time and runs its L rows (q, l) as 16-row m-tiles, two of which share
//    every weight fragment the warp loads.  x0 - q·Wq_eff =
//    [kp∘q | kp]·[Wm; Wk_eff] (K = 2D) and, for K3b, y0·W1 (K = H0) are
//    mma.sync m16n8k8 in TF32 with the 3xTF32 split (tf32_mma.cuh); one
//    TF32 pass would keep ~3 digits, and the variances E[x²] - E[x]² would
//    lose more.  Each k-step's three products go into a zeroed fragment
//    that f32 adds fold into the accumulators (mma3_add): the tensor
//    cores' accumulation is biased toward zero, so a batch mean over a
//    few rows missed its gate by up to 3.3x without it.  K is permuted
//    within each k-step, so the first product's accumulators are the
//    second one's A fragments: y0 never leaves registers.
//  - q·Wq_eff once per query, in f32 from Wq_eff in shared memory: added
//    to the accumulators (K3a) or folded into the layer-0 shift
//    cq = a0·(q·Wq_eff) + c0 (K3b).  Shared memory does not grow with G.
//  - Sums without barriers.  Each thread adds the C-fragment values it
//    owns (two columns of each n-tile, rows g and g + 8) into Σ and Σ²
//    registers across all of its tiles.  Rows past L (the last m-tile's
//    padding, read as position L - 1) are left out: for K3b a padding
//    row would add relu(c0)·W1 ≠ 0.  After its last query a warp reduces
//    each column's 8 row owners by shuffles, the block's warps meet in
//    shared memory in a fixed order, each block writes one partial, and
//    the last block to finish (an integer ticket, no float atomics) sums
//    the partials in block order into [2, H] and resets the ticket.  So
//    one launch per call, and the same bits on every call.
//  - Persistent grid.  A block stages [Wm; Wk_eff] and W1 in fragment
//    order, already split into TF32 high parts and remainders, plus
//    Wq_eff and a0, once; then no block barrier until the sums meet.
//    With fewer queries than resident warps a block sets fewer warps on
//    them and more blocks run.  The shared-memory attribute and the block
//    count are set once per device and process.

#include <cuda_runtime.h>
#include <algorithm>
#include <mutex>

#include "tf32_mma.cuh"

namespace {

using clsr::SplitA;
using clsr::mma3_add;
using clsr::split_a;
using clsr::stage_fragment;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;

template <int D, int H0, int H1, int PASS>
struct Layout {
  static constexpr int KS0 = D / 8;           // k-steps of each half of x0
  static constexpr int N0 = H0 / 8;           // n-tiles of x0
  static constexpr int KS1 = H0 / 8;          // k-steps of x1
  static constexpr int N1 = H1 / 8;           // n-tiles of x1
  static constexpr int H = PASS ? H1 : H0;    // channels summed
  static constexpr int NS = PASS ? N1 : N0;   // their n-tiles
  // offsets in floats; a fragment is (b0 hi, b1 hi, b0 lo, b1 lo)
  static constexpr int wb0 = 0;                              // [2 KS0][N0][32][4]
  static constexpr int wb1 = wb0 + 4 * D * H0;               // [KS1][N1][32][4]
  static constexpr int a0 = wb1 + (PASS ? 2 * H0 * H1 : 0);  // [H0]
  static constexpr int wq = a0 + (PASS ? H0 : 0);            // [D][H0]
  static constexpr int red = wq + D * H0;                    // [kWarps][2 H]
  static constexpr int warp0 = red + kWarps * 2 * H;         // per warp, below
  static constexpr int qs = 0;                               // [D]
  static constexpr int shift = qs + D;                       // [H0]
  static constexpr int per_warp = shift + H0;
  static constexpr int total = warp0 + kWarps * per_warp;
  static_assert(D % 8 == 0 && H0 % 8 == 0 && H1 % 8 == 0,
                "widths must be multiples of the 8-wide mma tiles");
  static_assert(wb1 % 4 == 0 && warp0 % 2 == 0 && per_warp % 2 == 0 &&
                    shift % 2 == 0,
                "fragments are 16-byte loads, q rows and shifts 8-byte loads");
};

// Adds rows r0 .. r0 + 16·MT - 1 of the warp's query (positions of its
// batch row; those >= L are read as position L - 1 and not summed) to the
// thread's column sums.  The MT m-tiles share every weight fragment the
// warp loads.
template <int D, int H0, int H1, int PASS, int MT>
__device__ __forceinline__ void stats_tile(
    const float* sm, const float* ws, const float* kpb, int r0, int L,
    int lane, float (&sum)[Layout<D, H0, H1, PASS>::NS][2],
    float (&sq)[Layout<D, H0, H1, PASS>::NS][2]) {
  using Lay = Layout<D, H0, H1, PASS>;
  const int g = lane >> 2, t = lane & 3;
  const float2* kpA[MT];
  const float2* kpB[MT];
  bool vA[MT], vB[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int ra = r0 + 16 * m + g, rb = ra + 8;
    vA[m] = ra < L;
    vB[m] = rb < L;
    kpA[m] = reinterpret_cast<const float2*>(kpb + (size_t)min(ra, L - 1) * D) + t;
    kpB[m] = reinterpret_cast<const float2*>(kpb + (size_t)min(rb, L - 1) * D) + t;
  }
  const float2* qv = reinterpret_cast<const float2*>(ws + Lay::qs) + t;
  const float4* wb0 = reinterpret_cast<const float4*>(sm + Lay::wb0) + lane;

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
    SplitA sq_[MT], sk[MT];
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
      sq_[m] = split_a(pq);
      sk[m] = split_a(pk);
    }
#pragma unroll
    for (int n = 0; n < Lay::N0; ++n) {
      const float4 b = wb0[(ks * Lay::N0 + n) * 32];
#pragma unroll
      for (int m = 0; m < MT; ++m) mma3_add(acc[m][n], sq_[m], b);
    }
#pragma unroll
    for (int n = 0; n < Lay::N0; ++n) {
      const float4 b = wb0[((Lay::KS0 + ks) * Lay::N0 + n) * 32];
#pragma unroll
      for (int m = 0; m < MT; ++m) mma3_add(acc[m][n], sk[m], b);
    }
  }
  const float* shift = ws + Lay::shift;
  if constexpr (PASS == 0) {
    // x0 = acc + q·Wq_eff, summed over the real rows
#pragma unroll
    for (int n = 0; n < Lay::N0; ++n) {
      const float2 s = *reinterpret_cast<const float2*>(shift + 8 * n + 2 * t);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float x00 = acc[m][n][0] + s.x, x01 = acc[m][n][1] + s.y;
        const float x10 = acc[m][n][2] + s.x, x11 = acc[m][n][3] + s.y;
        if (vA[m]) {
          sum[n][0] += x00;
          sum[n][1] += x01;
          sq[n][0] = fmaf(x00, x00, sq[n][0]);
          sq[n][1] = fmaf(x01, x01, sq[n][1]);
        }
        if (vB[m]) {
          sum[n][0] += x10;
          sum[n][1] += x11;
          sq[n][0] = fmaf(x10, x10, sq[n][0]);
          sq[n][1] = fmaf(x11, x11, sq[n][1]);
        }
      }
    }
  } else {
    // y0 = relu(a0·x0 + c0), with q·Wq_eff inside the shift, laid out as
    // the A fragments of the second product
#pragma unroll
    for (int n = 0; n < Lay::N0; ++n) {
      const int h = 8 * n + 2 * t;
      const float s0 = sm[Lay::a0 + h], s1 = sm[Lay::a0 + h + 1];
      const float c0 = shift[h], c1 = shift[h + 1];
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
    const float4* wb1 = reinterpret_cast<const float4*>(sm + Lay::wb1) + lane;
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
        for (int m = 0; m < MT; ++m) mma3_add(acc1[m][n], sy[m], b);
      }
    }
    // x1, summed over the real rows
#pragma unroll
    for (int n = 0; n < Lay::N1; ++n) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (vA[m]) {
          sum[n][0] += acc1[m][n][0];
          sum[n][1] += acc1[m][n][1];
          sq[n][0] = fmaf(acc1[m][n][0], acc1[m][n][0], sq[n][0]);
          sq[n][1] = fmaf(acc1[m][n][1], acc1[m][n][1], sq[n][1]);
        }
        if (vB[m]) {
          sum[n][0] += acc1[m][n][2];
          sum[n][1] += acc1[m][n][3];
          sq[n][0] = fmaf(acc1[m][n][2], acc1[m][n][2], sq[n][0]);
          sq[n][1] = fmaf(acc1[m][n][3], acc1[m][n][3], sq[n][1]);
        }
      }
    }
  }
}

template <int D, int H0, int H1, int PASS>
__global__ void __launch_bounds__(kThreads, 1)
train_stats_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                   const float* __restrict__ wk, const float* __restrict__ wq,
                   const float* __restrict__ wm, const float* __restrict__ a0,
                   const float* __restrict__ c0, const float* __restrict__ w1,
                   float* __restrict__ partials, unsigned* __restrict__ ticket,
                   float* __restrict__ out, int B, int L, int G, int wpb) {
  using Lay = Layout<D, H0, H1, PASS>;
  constexpr int H = Lay::H;
  extern __shared__ float4 smem4[];
  __shared__ bool last_block;
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ws = sm + Lay::warp0 + warp * Lay::per_warp;

  // ---- weights in mma fragment order, once per block ------------------
  // fragment (ks, n, lane = 4g + t): rows 8 ks + 2t and 8 ks + 2t + 1 of
  // column 8 n + g; the first product's K runs over [Wm; Wk_eff]
#pragma unroll 4
  for (int e = tid; e < 2 * Lay::KS0 * Lay::N0 * 32; e += kThreads) {
    const int ln = e & 31, n = (e >> 5) % Lay::N0, ks = (e >> 5) / Lay::N0;
    stage_fragment(sm + Lay::wb0 + 4 * e, ks < Lay::KS0 ? wm : wk,
                   8 * (ks % Lay::KS0) + 2 * (ln & 3), 8 * n + (ln >> 2), H0);
  }
  if constexpr (PASS == 1) {
#pragma unroll 4
    for (int e = tid; e < Lay::KS1 * Lay::N1 * 32; e += kThreads) {
      const int ln = e & 31, n = (e >> 5) % Lay::N1, ks = (e >> 5) / Lay::N1;
      stage_fragment(sm + Lay::wb1 + 4 * e, w1, 8 * ks + 2 * (ln & 3),
                     8 * n + (ln >> 2), H1);
    }
    for (int i = tid; i < H0; i += kThreads) sm[Lay::a0 + i] = a0[i];
  }
  for (int i = tid; i < D * H0; i += kThreads) sm[Lay::wq + i] = wq[i];
  __syncthreads();   // warps share nothing else until the sums meet

  float sum[Lay::NS][2], sq[Lay::NS][2];
#pragma unroll
  for (int n = 0; n < Lay::NS; ++n)
    sum[n][0] = sum[n][1] = sq[n][0] = sq[n][1] = 0.f;

  // the first wpb warps of a block take queries (fewer than kWarps when
  // there are few queries, so that they spread over more SMs)
  const int n_q = B * G;
  for (int qi = warp < wpb ? blockIdx.x * wpb + warp : n_q; qi < n_q;
       qi += gridDim.x * wpb) {
    const int b = qi / G;
    for (int d = lane; d < D; d += 32) ws[Lay::qs + d] = q[(size_t)qi * D + d];
    __syncwarp();
    // the shift: q·Wq_eff (K3a) or a0·(q·Wq_eff) + c0 (K3b); each lane
    // owns channels lane + 32j
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
      if (h < H0) {
        if constexpr (PASS == 1)
          ws[Lay::shift + h] = fmaf(sm[Lay::a0 + h], s[j], __ldg(c0 + h));
        else
          ws[Lay::shift + h] = s[j];
      }
    }
    __syncwarp();
    const float* kpb = kp + (size_t)b * L * D;
    for (int r0 = 0; r0 < L; r0 += 32) {
      if (L - r0 > 16)
        stats_tile<D, H0, H1, PASS, 2>(sm, ws, kpb, r0, L, lane, sum, sq);
      else
        stats_tile<D, H0, H1, PASS, 1>(sm, ws, kpb, r0, L, lane, sum, sq);
    }
    __syncwarp();   // q and the shift are rewritten by the next query
  }

  // ---- each column's 8 row owners meet (lanes t, t + 4, ..., t + 28) ---
#pragma unroll
  for (int n = 0; n < Lay::NS; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sum[n][j] += __shfl_xor_sync(0xffffffffu, sum[n][j], o);
        sq[n][j] += __shfl_xor_sync(0xffffffffu, sq[n][j], o);
      }
  float* red = sm + Lay::red + warp * 2 * H;
  if (lane < 4) {
#pragma unroll
    for (int n = 0; n < Lay::NS; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red[8 * n + 2 * lane + j] = sum[n][j];
        red[H + 8 * n + 2 * lane + j] = sq[n][j];
      }
  }
  __syncthreads();
  // one partial per block, its warps summed in order
  for (int i = tid; i < 2 * H; i += kThreads) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += sm[Lay::red + w * 2 * H + i];
    partials[(size_t)blockIdx.x * 2 * H + i] = v;
  }
  // the last block to finish sums the partials in block order
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int i = tid; i < 2 * H; i += kThreads) {
    float v = 0.f;
    for (int p = 0; p < (int)gridDim.x; ++p)
      v += __ldcg(partials + (size_t)p * 2 * H + i);
    out[i] = v;
  }
  if (tid == 0) *ticket = 0u;   // ready for the next launch
}

// Once per device and kernel: the shared-memory opt-in and the
// persistent grid size (resident blocks an SM x SMs).
struct Setup {
  std::once_flag once;
  cudaError_t err = cudaSuccess;
  int max_blocks = 0;
};

template <int D, int PASS>
cudaError_t setup(int* max_blocks) {
  auto kern = train_stats_kernel<D, 80, 40, PASS>;
  constexpr size_t smem = sizeof(float) * Layout<D, 80, 40, PASS>::total;
  static Setup setups[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Setup& s = setups[dev];
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
  *max_blocks = s.max_blocks;
  return s.err;
}

template <int D, int PASS>
int launch(const float* q, const float* kp, const float* wk,
           const float* wq, const float* wm, const float* a0,
           const float* c0, const float* w1, float* partials,
           unsigned* ticket, float* out, int B, int L, int G,
           cudaStream_t stream) {
  int max_blocks = 0;
  cudaError_t err = setup<D, PASS>(&max_blocks);
  if (err != cudaSuccess) return (int)err;
  // warps a block sets on queries: all kWarps once the queries fill
  // every resident block, fewer (and more blocks) below that
  const int n_q = B * G;
  const int per_block =
      std::min(kWarps, (n_q + max_blocks - 1) / max_blocks);
  const int grid = std::min(max_blocks, (n_q + per_block - 1) / per_block);
  constexpr size_t smem = sizeof(float) * Layout<D, 80, 40, PASS>::total;
  train_stats_kernel<D, 80, 40, PASS><<<grid, kThreads, smem, stream>>>(
      q, kp, wk, wq, wm, a0, c0, w1, partials, ticket, out, B, L, G,
      per_block);
  return (int)cudaGetLastError();
}

template <int PASS>
int dispatch(const float* q, const float* kp, const float* wk,
             const float* wq, const float* wm, const float* a0,
             const float* c0, const float* w1, float* partials,
             unsigned* ticket, float* out, int B, int L, int G, int D,
             int H0, int H1, void* stream) {
  if (B <= 0 || L <= 0 || G <= 0 || H0 != 80 || H1 != 40)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 80)
    return launch<80, PASS>(q, kp, wk, wq, wm, a0, c0, w1, partials, ticket,
                            out, B, L, G, s);
  if (D == 40)
    return launch<40, PASS>(q, kp, wk, wq, wm, a0, c0, w1, partials, ticket,
                            out, B, L, G, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Blocks of the persistent grid on the current device (the rows of the
// [blocks, 2, H] partials workspace a launch needs), after the once-per-
// device setup; -cudaError_t on failure, -1 for widths not compiled in.
extern "C" int clsr_train_stats_max_blocks(int D, int pass) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 80) err = pass ? setup<80, 1>(&blocks) : setup<80, 0>(&blocks);
  if (D == 40) err = pass ? setup<40, 1>(&blocks) : setup<40, 0>(&blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Widths compiled in: D in {40, 80}, H0 = 80, H1 = 40 (the clsr.yaml
// scorers); any B, L and G.  `out` gets [sum; sum of squares] ([2, H]);
// `partials` holds clsr_train_stats_max_blocks rows of 2H floats and
// `ticket` one zeroed unsigned that each launch leaves at zero again, so
// launches that share them must be ordered (one stream).  Any other
// width returns cudaErrorInvalidValue.
extern "C" int clsr_train_stats0(const float* q, const float* kp,
                                 const float* wk, const float* wq,
                                 const float* wm, float* partials,
                                 unsigned* ticket, float* out, int B, int L,
                                 int G, int D, int H0, void* stream) {
  return dispatch<0>(q, kp, wk, wq, wm, nullptr, nullptr, nullptr, partials,
                     ticket, out, B, L, G, D, H0, 40, stream);
}

extern "C" int clsr_train_stats1(const float* q, const float* kp,
                                 const float* wk, const float* wq,
                                 const float* wm, const float* a0,
                                 const float* c0, const float* w1,
                                 float* partials, unsigned* ticket,
                                 float* out, int B, int L, int G, int D,
                                 int H0, int H1, void* stream) {
  return dispatch<1>(q, kp, wk, wq, wm, a0, c0, w1, partials, ticket, out,
                     B, L, G, D, H0, H1, stream);
}

// K1: fused eval-mode grouped target-attention scorer, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel clsr_tpu/ops/pallas_attention.py:_scorer_kernel
// (driven by fused_eval_attention there).  For one batch row b and a tile
// of candidates g it computes, for every history position l:
//
//   x0 = kp[l]·Wk_eff + q[g]·Wq_eff + (kp[l]∘q[g])·Wm     (split first layer)
//   y0 = relu(a0·x0 + c0)                                 (bias + eval BN)
//   y1 = relu(a1·(y0·W1) + c1)
//   logit = y1·w2                            (b2 cancels in the softmax)
//
// then a masked (-2^32+1) softmax over l and the weighted sum of the raw
// keys, out[b, g] = sum_l softmax(logit)_l · keys[b, l]  ([B, G, DK], f32).
//
// What bounds it on an H100: the arithmetic.  Per (b, valid l, g) it does
// D·H0 + H0·H1 multiply-adds (9,600 at the clsr.yaml widths) on inputs of
// a few MB, far above the card's FP32 ops-per-byte line.  No tensor cores:
// the math is f32 FMA, so the bound is the 67 TFLOP/s FP32 rate.
//
// Design (not the TPU grid): on the TPU, L was the sequential third grid
// axis carrying the softmax state in VMEM scratch.  Hopper blocks run in no
// order, so one block owns (row b, tile of 64 candidates) and loops over L
// itself with an online softmax; nothing carries between blocks.  The loop
// covers the real L only (no block padding), so an all-masked row gives
// uniform weights over L, as the plain path does.  Masked positions skip
// the MLP (their logit is the mask constant either way).  Two threads share
// one candidate, each holding half of the H0 first-layer channels in
// registers; the layer-1 partial sums meet through one shuffle.  Wm, W1 and
// the folded affines sit in shared memory (read as broadcasts), the history
// is staged in chunks of kLC positions, and kp·Wk_eff is computed once per
// chunk for the whole block.  About 86 KB of dynamic shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kMaskValue = -4294967295.0f;  // -(2^32)+1, clsr.py:375
constexpr int kThreads = 128;                 // 2 threads per candidate
constexpr int kGT = kThreads / 2;             // candidates per block
constexpr int kQStride = kGT + 1;             // q tile row stride (no conflicts)
constexpr int kLC = 32;                       // history positions per chunk

template <int D, int H0, int H1, int DK>
struct Layout {
  static constexpr int wm = 0;                      // [D][H0]
  static constexpr int w1 = wm + D * H0;            // [H0][H1]
  static constexpr int a0 = w1 + H0 * H1;           // [H0]
  static constexpr int c0 = a0 + H0;                // [H0]
  static constexpr int a1 = c0 + H0;                // [H1]
  static constexpr int c1 = a1 + H1;                // [H1]
  static constexpr int w2 = c1 + H1;                // [H1]
  static constexpr int q = w2 + H1;                 // [D][kQStride]
  static constexpr int kp = q + D * kQStride;       // [kLC][D]
  static constexpr int tk = kp + kLC * D;           // [kLC][H0]
  static constexpr int keys = tk + kLC * H0;        // [kLC][DK]
  static constexpr int mask = keys + kLC * DK;      // [kLC]
  static constexpr int total = mask + kLC;
  static_assert(D % 4 == 0 && H0 % 8 == 0 && H1 % 4 == 0 && DK % 2 == 0,
                "float4 rows need D, H0/2 and H1 to be multiples of 4");
  static_assert(q % 4 == 0 && kp % 4 == 0 && tk % 4 == 0,
                "float4-read regions must be 16-byte aligned");
};

template <int D, int H0, int H1, int DK>
__global__ void __launch_bounds__(kThreads)
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
                   float* __restrict__ out, int L, int G) {
  using Lay = Layout<D, H0, H1, DK>;
  constexpr int HH = H0 / 2;    // first-layer channels per thread
  constexpr int DKH = DK / 2;   // output channels per thread
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);

  const int b = blockIdx.x;
  const int g0 = blockIdx.y * kGT;
  const int tid = threadIdx.x;
  const int gl = tid >> 1;
  const int half = tid & 1;
  const int g = g0 + gl;

  // ---- weights and this tile's queries into shared memory -------------
  for (int i = tid; i < D * H0; i += kThreads) sm[Lay::wm + i] = wm[i];
  for (int i = tid; i < H0 * H1; i += kThreads) sm[Lay::w1 + i] = w1[i];
  for (int i = tid; i < H0; i += kThreads) {
    sm[Lay::a0 + i] = a0[i];
    sm[Lay::c0 + i] = c0[i];
  }
  for (int i = tid; i < H1; i += kThreads) {
    sm[Lay::a1 + i] = a1[i];
    sm[Lay::c1 + i] = c1[i];
    sm[Lay::w2 + i] = w2[i];
  }
  const float* qb = q + (size_t)b * G * D;
  for (int i = tid; i < kGT * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sm[Lay::q + d * kQStride + r] = (g0 + r < G) ? qb[(size_t)(g0 + r) * D + d]
                                                 : 0.f;
  }
  __syncthreads();

  // q·Wq_eff for this thread's half of the channels, kept in registers
  float tq[HH];
#pragma unroll
  for (int j = 0; j < HH; ++j) tq[j] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float qv = sm[Lay::q + d * kQStride + gl];
    const float* wrow = wq + d * H0 + half * HH;
#pragma unroll
    for (int j = 0; j < HH; ++j) tq[j] = fmaf(qv, __ldg(wrow + j), tq[j]);
  }

  float m_run = -INFINITY, s_run = 0.f;
  float acc[DKH];
#pragma unroll
  for (int i = 0; i < DKH; ++i) acc[i] = 0.f;

  const float* kpb = kp + (size_t)b * L * D;
  const float* keysb = keys + (size_t)b * L * DK;
  const float* maskb = mask + (size_t)b * L;

  for (int l0 = 0; l0 < L; l0 += kLC) {
    const int n = min(kLC, L - l0);
    __syncthreads();   // the previous chunk is no longer read
    for (int i = tid; i < n * D; i += kThreads) sm[Lay::kp + i] = kpb[(size_t)l0 * D + i];
    for (int i = tid; i < n * DK; i += kThreads)
      sm[Lay::keys + i] = keysb[(size_t)l0 * DK + i];
    for (int i = tid; i < n; i += kThreads) sm[Lay::mask + i] = maskb[l0 + i];
    __syncthreads();
    // kp·Wk_eff for the valid positions of the chunk, shared by the block
    for (int i = tid; i < n * H0; i += kThreads) {
      const int l = i / H0, h = i % H0;
      if (sm[Lay::mask + l] > 0.f) {
        float s = 0.f;
        for (int d = 0; d < D; ++d)
          s = fmaf(sm[Lay::kp + l * D + d], __ldg(wk + d * H0 + h), s);
        sm[Lay::tk + i] = s;
      }
    }
    __syncthreads();

    for (int l = 0; l < n; ++l) {
      float logit = kMaskValue;
      if (sm[Lay::mask + l] > 0.f) {   // uniform over the block
        float x[HH];
        const float* tkl = sm + Lay::tk + l * H0 + half * HH;
#pragma unroll
        for (int j = 0; j < HH; ++j) x[j] = tq[j] + tkl[j];
        const float* kpl = sm + Lay::kp + l * D;
        for (int d = 0; d < D; ++d) {
          const float v = sm[Lay::q + d * kQStride + gl] * kpl[d];
          const float4* wrow =
              reinterpret_cast<const float4*>(sm + Lay::wm + d * H0 + half * HH);
#pragma unroll
          for (int j4 = 0; j4 < HH / 4; ++j4) {
            const float4 w = wrow[j4];
            x[4 * j4 + 0] = fmaf(v, w.x, x[4 * j4 + 0]);
            x[4 * j4 + 1] = fmaf(v, w.y, x[4 * j4 + 1]);
            x[4 * j4 + 2] = fmaf(v, w.z, x[4 * j4 + 2]);
            x[4 * j4 + 3] = fmaf(v, w.w, x[4 * j4 + 3]);
          }
        }
        float s1[H1];
#pragma unroll
        for (int k = 0; k < H1; ++k) s1[k] = 0.f;
#pragma unroll
        for (int j = 0; j < HH; ++j) {
          const int h = half * HH + j;
          const float y0 = fmaxf(fmaf(sm[Lay::a0 + h], x[j], sm[Lay::c0 + h]), 0.f);
          const float4* wrow = reinterpret_cast<const float4*>(sm + Lay::w1 + h * H1);
#pragma unroll
          for (int k4 = 0; k4 < H1 / 4; ++k4) {
            const float4 w = wrow[k4];
            s1[4 * k4 + 0] = fmaf(y0, w.x, s1[4 * k4 + 0]);
            s1[4 * k4 + 1] = fmaf(y0, w.y, s1[4 * k4 + 1]);
            s1[4 * k4 + 2] = fmaf(y0, w.z, s1[4 * k4 + 2]);
            s1[4 * k4 + 3] = fmaf(y0, w.w, s1[4 * k4 + 3]);
          }
        }
        logit = 0.f;
#pragma unroll
        for (int k = 0; k < H1; ++k) {
          const float s = s1[k] + __shfl_xor_sync(0xffffffffu, s1[k], 1);
          logit = fmaf(sm[Lay::w2 + k],
                       fmaxf(fmaf(sm[Lay::a1 + k], s, sm[Lay::c1 + k]), 0.f), logit);
        }
      }
      // online softmax over l
      const float m_new = fmaxf(m_run, logit);
      const float rescale = expf(m_run - m_new);
      const float p = expf(logit - m_new);
      s_run = s_run * rescale + p;
      const float* kl = sm + Lay::keys + l * DK + half * DKH;
#pragma unroll
      for (int i = 0; i < DKH; ++i) acc[i] = fmaf(p, kl[i], acc[i] * rescale);
      m_run = m_new;
    }
  }

  if (g < G) {
    float* o = out + ((size_t)b * G + g) * DK + half * DKH;
    const float inv = 1.f / s_run;
#pragma unroll
    for (int i = 0; i < DKH; ++i) o[i] = acc[i] * inv;
  }
}

template <int D, int H0, int H1, int DK>
int launch(const float* keys, const float* kp, const float* q,
           const float* mask, const float* wk, const float* wq,
           const float* wm, const float* a0, const float* c0,
           const float* w1, const float* a1, const float* c1,
           const float* w2, float* out, int B, int L, int G,
           cudaStream_t stream) {
  auto kern = eval_scorer_kernel<D, H0, H1, DK>;
  const size_t smem = sizeof(float) * Layout<D, H0, H1, DK>::total;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, (G + kGT - 1) / kGT);
  kern<<<grid, kThreads, smem, stream>>>(keys, kp, q, mask, wk, wq, wm, a0,
                                         c0, w1, a1, c1, w2, out, L, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Widths compiled in: (D, DK, H0, H1) = (80, 40, 80, 40), the clsr.yaml
// short-term scorer.  Any other returns cudaErrorInvalidValue.
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
  return (int)cudaErrorInvalidValue;
}

// K3a + K3b: batch statistics of the train-mode target-attention scorer,
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernels clsr_tpu/ops/pallas_attention.py:_stats0_kernel
// (K3a) and :_stats1_kernel (K3b), both driven by _stats_call there.  For
// every (b, l, g) row of the [B, L, G] extent (every history position,
// masked or not):
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
// (K3b) against ~7 MB, far above the FP32 ops-per-byte line.  No tensor
// cores: the math is f32 FMA, so the bound is the 67 TFLOP/s FP32 rate.
//
// Design (not the TPU grid): the TPU version carries the sums across a
// sequential L grid axis in VMEM scratch.  Hopper blocks run in no order,
// so a block owns one batch row b and a chunk of kLC history positions,
// loops over that chunk's (l, g) rows itself, and writes its own partial
// sums to [B, n_chunks, H]; the wrapper reduces them with torch.sum, as the
// TPU wrapper reduces its per-row partials.  No atomics: the sums are the
// same from run to run.  Wk_eff, Wq_eff and Wm (and for K3b W1, a0, c0)
// sit in dynamic shared memory (~115 KB at D = 80, above the 48 KB static
// limit, so with the opt-in attribute); kp·Wk_eff is computed once per
// position and q·Wq_eff once per block.  Each thread owns one output
// channel and a group of rows: the rows' kp∘q vectors are staged per tile
// and read as broadcasts, so every weight read from shared memory feeds
// kRPT0 FMAs.  For K3b the tile's y0 goes through shared memory to the
// second layer, whose threads own one H1 channel each.  Positions beyond
// the real L are never read; masked positions count, as in JAX.

#include <cuda_runtime.h>

namespace {

constexpr int kLC = 16;   // history positions per block
constexpr int kTR = 16;   // (l, g) rows per tile

template <int D, int H0, int H1, int PASS>
struct Layout {
  static constexpr int kThreads = 2 * H0;
  static constexpr int kRG0 = kThreads / H0;   // row groups, layer 0
  static constexpr int kRG1 = kThreads / H1;   // row groups, layer 1
  static constexpr int kRPT0 = kTR / kRG0;     // rows per thread, layer 0
  static constexpr int kRPT1 = kTR / kRG1;     // rows per thread, layer 1
  static constexpr int kOut = PASS == 0 ? H0 : H1;
  static_assert(kThreads % H1 == 0 && kTR % kRG0 == 0 && kTR % kRG1 == 0,
                "threads and tile rows must split evenly over channels");
  // offsets in floats; the G-sized regions come last but one
  static constexpr int wk = 0;                              // [D][H0]
  static constexpr int wq = wk + D * H0;                    // [D][H0]
  static constexpr int wm = wq + D * H0;                    // [D][H0]
  static constexpr int w1 = wm + D * H0;                    // [H0][H1]
  static constexpr int a0 = w1 + (PASS ? H0 * H1 : 0);      // [H0]
  static constexpr int c0 = a0 + (PASS ? H0 : 0);           // [H0]
  static constexpr int kp = c0 + (PASS ? H0 : 0);           // [kLC][D]
  static constexpr int tk = kp + kLC * D;                   // [kLC][H0]
  static constexpr int kq = tk + kLC * H0;                  // [kTR][D]
  static constexpr int y0 = kq + kTR * D;                   // [kTR][H0]
  static constexpr int red = y0 + (PASS ? kTR * H0 : 0);    // [2][kThreads]
  static constexpr int q = red + 2 * kThreads;              // [G][D]
  // then tq [G][H0]
  static long long floats(int G) { return q + (long long)G * (D + H0); }
};

template <int D, int H0, int H1, int PASS>
__global__ void __launch_bounds__(2 * H0)
train_stats_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                   const float* __restrict__ wk, const float* __restrict__ wq,
                   const float* __restrict__ wm, const float* __restrict__ a0,
                   const float* __restrict__ c0, const float* __restrict__ w1,
                   float* __restrict__ out_sum, float* __restrict__ out_sq,
                   int L, int G) {
  using Lay = Layout<D, H0, H1, PASS>;
  constexpr int T = Lay::kThreads;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* s_q = sm + Lay::q;
  float* s_tq = s_q + G * D;

  const int b = blockIdx.x;
  const int chunk = blockIdx.y;
  const int l0 = chunk * kLC;
  const int n = min(kLC, L - l0);
  const int tid = threadIdx.x;

  // ---- weights, this row's queries and this chunk's history ------------
  for (int i = tid; i < D * H0; i += T) {
    sm[Lay::wk + i] = wk[i];
    sm[Lay::wq + i] = wq[i];
    sm[Lay::wm + i] = wm[i];
  }
  if (PASS == 1) {
    for (int i = tid; i < H0 * H1; i += T) sm[Lay::w1 + i] = w1[i];
    for (int i = tid; i < H0; i += T) {
      sm[Lay::a0 + i] = a0[i];
      sm[Lay::c0 + i] = c0[i];
    }
  }
  const float* qb = q + (size_t)b * G * D;
  for (int i = tid; i < G * D; i += T) s_q[i] = qb[i];
  const float* kpb = kp + ((size_t)b * L + l0) * D;
  for (int i = tid; i < n * D; i += T) sm[Lay::kp + i] = kpb[i];
  __syncthreads();

  // q·Wq_eff per candidate, kp·Wk_eff per position
  for (int i = tid; i < G * H0; i += T) {
    const int g = i / H0, h = i % H0;
    float s = 0.f;
    for (int d = 0; d < D; ++d)
      s = fmaf(s_q[g * D + d], sm[Lay::wq + d * H0 + h], s);
    s_tq[i] = s;
  }
  for (int i = tid; i < n * H0; i += T) {
    const int l = i / H0, h = i % H0;
    float s = 0.f;
    for (int d = 0; d < D; ++d)
      s = fmaf(sm[Lay::kp + l * D + d], sm[Lay::wk + d * H0 + h], s);
    sm[Lay::tk + i] = s;
  }

  const int h0 = tid % H0, rg0 = tid / H0;   // layer-0 channel, row group
  const int k1 = tid % H1, rg1 = tid / H1;   // layer-1 channel, row group
  float acc_s = 0.f, acc_q = 0.f;
  const int rows = n * G;
  for (int r0 = 0; r0 < rows; r0 += kTR) {
    __syncthreads();   // tk, tq written; the previous tile is no longer read
    for (int i = tid; i < kTR * D; i += T) {
      const int r = r0 + i / D, d = i % D;
      float v = 0.f;
      if (r < rows) {
        const int l = r / G, g = r % G;
        v = sm[Lay::kp + l * D + d] * s_q[g * D + d];
      }
      sm[Lay::kq + i] = v;
    }
    __syncthreads();

    float x[Lay::kRPT0];
#pragma unroll
    for (int i = 0; i < Lay::kRPT0; ++i) x[i] = 0.f;
    const float* kq = sm + Lay::kq + rg0 * Lay::kRPT0 * D;
    for (int d = 0; d < D; ++d) {
      const float w = sm[Lay::wm + d * H0 + h0];
#pragma unroll
      for (int i = 0; i < Lay::kRPT0; ++i) x[i] = fmaf(kq[i * D + d], w, x[i]);
    }
#pragma unroll
    for (int i = 0; i < Lay::kRPT0; ++i) {
      const int rl = rg0 * Lay::kRPT0 + i;
      const int r = r0 + rl;
      if (r < rows) {
        const int l = r / G, g = r % G;
        const float v = x[i] + sm[Lay::tk + l * H0 + h0] + s_tq[g * H0 + h0];
        if (PASS == 0) {
          acc_s += v;
          acc_q = fmaf(v, v, acc_q);
        } else {
          sm[Lay::y0 + rl * H0 + h0] =
              fmaxf(fmaf(sm[Lay::a0 + h0], v, sm[Lay::c0 + h0]), 0.f);
        }
      }
    }

    if (PASS == 1) {
      __syncthreads();   // the tile's y0 is complete
      float x1[Lay::kRPT1];
#pragma unroll
      for (int i = 0; i < Lay::kRPT1; ++i) x1[i] = 0.f;
      const float* y0 = sm + Lay::y0 + rg1 * Lay::kRPT1 * H0;
      for (int h = 0; h < H0; ++h) {
        const float w = sm[Lay::w1 + h * H1 + k1];
#pragma unroll
        for (int i = 0; i < Lay::kRPT1; ++i) x1[i] = fmaf(y0[i * H0 + h], w, x1[i]);
      }
#pragma unroll
      for (int i = 0; i < Lay::kRPT1; ++i) {
        if (r0 + rg1 * Lay::kRPT1 + i < rows) {
          acc_s += x1[i];
          acc_q = fmaf(x1[i], x1[i], acc_q);
        }
      }
    }
  }

  // ---- the row groups of each channel meet; one partial per block ------
  sm[Lay::red + tid] = acc_s;
  sm[Lay::red + T + tid] = acc_q;
  __syncthreads();
  constexpr int HO = Lay::kOut;
  if (tid < HO) {
    float s = 0.f, sq = 0.f;
    for (int r = 0; r < T / HO; ++r) {
      s += sm[Lay::red + r * HO + tid];
      sq += sm[Lay::red + T + r * HO + tid];
    }
    const size_t o = ((size_t)b * gridDim.y + chunk) * HO + tid;
    out_sum[o] = s;
    out_sq[o] = sq;
  }
}

template <int D, int PASS>
int launch(const float* q, const float* kp, const float* wk,
           const float* wq, const float* wm, const float* a0,
           const float* c0, const float* w1, float* out_sum, float* out_sq,
           int B, int L, int G, cudaStream_t stream) {
  using Lay = Layout<D, 80, 40, PASS>;
  auto kern = train_stats_kernel<D, 80, 40, PASS>;
  const size_t smem = sizeof(float) * Lay::floats(G);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, (L + kLC - 1) / kLC);
  kern<<<grid, Lay::kThreads, smem, stream>>>(q, kp, wk, wq, wm, a0, c0, w1,
                                              out_sum, out_sq, L, G);
  return (int)cudaGetLastError();
}

template <int PASS>
int dispatch(const float* q, const float* kp, const float* wk,
             const float* wq, const float* wm, const float* a0,
             const float* c0, const float* w1, float* out_sum,
             float* out_sq, int B, int L, int G, int D, int H0, int H1,
             void* stream) {
  if (B <= 0 || L <= 0 || G <= 0 || H0 != 80 || H1 != 40)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 80)
    return launch<80, PASS>(q, kp, wk, wq, wm, a0, c0, w1, out_sum, out_sq,
                            B, L, G, s);
  if (D == 40)
    return launch<40, PASS>(q, kp, wk, wq, wm, a0, c0, w1, out_sum, out_sq,
                            B, L, G, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// History positions per block: the partial-sum outputs are
// [B, ceil(L / chunk), H].
extern "C" int clsr_train_stats_chunk_l() { return kLC; }

// Dynamic shared memory of one block, in bytes (the wrapper checks the
// limit); -1 for widths not compiled in.
extern "C" long long clsr_train_stats_smem_bytes(int D, int G, int pass) {
  long long f = -1;
  if (D == 80) f = pass ? Layout<80, 80, 40, 1>::floats(G)
                        : Layout<80, 80, 40, 0>::floats(G);
  if (D == 40) f = pass ? Layout<40, 80, 40, 1>::floats(G)
                        : Layout<40, 80, 40, 0>::floats(G);
  return f < 0 ? -1 : f * (long long)sizeof(float);
}

// Widths compiled in: D in {40, 80}, H0 = 80, H1 = 40 (the clsr.yaml
// scorers).  Any other returns cudaErrorInvalidValue.
extern "C" int clsr_train_stats0(const float* q, const float* kp,
                                 const float* wk, const float* wq,
                                 const float* wm, float* out_sum,
                                 float* out_sq, int B, int L, int G, int D,
                                 int H0, void* stream) {
  return dispatch<0>(q, kp, wk, wq, wm, nullptr, nullptr, nullptr, out_sum,
                     out_sq, B, L, G, D, H0, 40, stream);
}

extern "C" int clsr_train_stats1(const float* q, const float* kp,
                                 const float* wk, const float* wq,
                                 const float* wm, const float* a0,
                                 const float* c0, const float* w1,
                                 float* out_sum, float* out_sq, int B, int L,
                                 int G, int D, int H0, int H1, void* stream) {
  return dispatch<1>(q, kp, wk, wq, wm, a0, c0, w1, out_sum, out_sq, B, L, G,
                     D, H0, H1, stream);
}

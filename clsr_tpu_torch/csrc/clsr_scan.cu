// K2: the three-cell CLSR recurrence, forward, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel clsr_tpu/ops/pallas_scan.py:_kernel (driven by
// _pallas_forward there).  All L steps of three recurrences over one
// history, with the input projections hoisted out by the caller (and the
// candidate biases folded into xc1/xc2):
//
//   interest-evolve GRU (carry h1, U wide, h1_0 = user_short)
//   Time4LSTM          (carries c, m, H wide; forget bias +1, time gates)
//   causal2 GRU        (carry h2, H wide)
//
// with masked carry-through x = mt·x_new + (1-mt)·x.  Outputs: mt·m_new per
// step [B, L, H], and the final h1 [B, U] and h2 [B, H].  The math is that
// of pallas_scan.py:69-108, line by line.
//
// What bounds it on an H100: neither bytes (about 7 MB in and out at the
// serving shape, ~2 us of HBM time) nor operations (16,000 multiply-adds
// per row and step) but the L dependent steps: each step needs the whole
// previous carry.  The design keeps that chain on chip: one block owns one
// batch row and walks the L steps itself, the five recurrent matrices
// (3U^2 + 7H^2 floats, 64 KB at U = H = 40) and the carries stay in shared
// memory, and each step is three phases split by __syncthreads: the gate
// mat-vecs (one thread per gate output), the Time4LSTM cell and GRU reset
// products, and the two GRU candidates with the carry updates.  A masked
// step (mt == 0) changes no carry and writes a zero output, so the block
// skips its arithmetic.  At B = 64 only 64 of the 132 SMs get a block.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
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
    float* __restrict__ h1f, float* __restrict__ h2f, int L, int U, int H) {
  extern __shared__ float sm[];
  const int GW = 2 * U + 6 * H;      // gate outputs per step
  float* s_whg1 = sm;                // [U][2U]
  float* s_whc1 = s_whg1 + 2 * U * U;  // [U][U]
  float* s_wh4 = s_whc1 + U * U;     // [H][4H]
  float* s_whg2 = s_wh4 + 4 * H * H; // [H][2H]
  float* s_whc2 = s_whg2 + 2 * H * H;  // [H][H]
  float* s_h1 = s_whc2 + H * H;      // [U]
  float* s_c = s_h1 + U;             // [H]
  float* s_m = s_c + H;              // [H]
  float* s_h2 = s_m + H;             // [H]
  float* s_ga = s_h2 + H;            // [GW]: sig(r1,u1) | i,j,f,o | sig(r2,u2)
  float* s_zc = s_ga + GW;           // [U+H]: r1*h1 | r2*h2

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int i = tid; i < 2 * U * U; i += nt) s_whg1[i] = whg1[i];
  for (int i = tid; i < U * U; i += nt) s_whc1[i] = whc1[i];
  for (int i = tid; i < 4 * H * H; i += nt) s_wh4[i] = wh4[i];
  for (int i = tid; i < 2 * H * H; i += nt) s_whg2[i] = whg2[i];
  for (int i = tid; i < H * H; i += nt) s_whc2[i] = whc2[i];
  for (int i = tid; i < U; i += nt) s_h1[i] = ushort_[(size_t)b * U + i];
  for (int i = tid; i < H; i += nt) {
    s_c[i] = 0.f;
    s_m[i] = 0.f;
    s_h2[i] = 0.f;
  }
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const size_t bl = (size_t)b * L + l;
    const float mt = mask[bl];
    if (mt == 0.f) {   // uniform over the block: carry through, output 0
      for (int j = tid; j < H; j += nt) outs[bl * H + j] = 0.f;
      continue;
    }

    // phase A: the three cells' carry-gate mat-vecs
    for (int o = tid; o < GW; o += nt) {
      float acc;
      if (o < 2 * U) {
        acc = xg1[bl * 2 * U + o];
        for (int k = 0; k < U; ++k) acc = fmaf(s_h1[k], s_whg1[k * 2 * U + o], acc);
        acc = sigmoidf_(acc);
      } else if (o < 2 * U + 4 * H) {
        const int oo = o - 2 * U;
        acc = xw[bl * 4 * H + oo];
        for (int k = 0; k < H; ++k) acc = fmaf(s_m[k], s_wh4[k * 4 * H + oo], acc);
      } else {
        const int oo = o - 2 * U - 4 * H;
        acc = xg2[bl * 2 * H + oo];
        for (int k = 0; k < H; ++k) acc = fmaf(s_h2[k], s_whg2[k * 2 * H + oo], acc);
        acc = sigmoidf_(acc);
      }
      s_ga[o] = acc;
    }
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
        float acc = xc1[bl * U + o];
        for (int k = 0; k < U; ++k) acc = fmaf(s_zc[k], s_whc1[k * U + o], acc);
        const float cand = tanhf(acc);
        const float u = s_ga[U + o];
        const float h = s_h1[o];
        s_h1[o] = mt * (u * h + (1.f - u) * cand) + (1.f - mt) * h;
      } else {
        const int oo = o - U;
        float acc = xc2[bl * H + oo];
        for (int k = 0; k < H; ++k) acc = fmaf(s_zc[U + k], s_whc2[k * H + oo], acc);
        const float cand = tanhf(acc);
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

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper checks the limit).
extern "C" long long clsr_scan_smem_bytes(int U, int H) {
  const long long floats = 3LL * U * U + 7LL * H * H + U + 3LL * H +
                           (2LL * U + 6LL * H) + (U + H);
  return floats * (long long)sizeof(float);
}

extern "C" int clsr_scan_forward(
    const float* xg1, const float* xc1, const float* xw, const float* tn,
    const float* tl, const float* ot, const float* xg2, const float* xc2,
    const float* mask, const float* ushort_, const float* whg1,
    const float* whc1, const float* wh4, const float* whg2,
    const float* whc2, float* outs, float* h1f, float* h2f, int B, int L,
    int U, int H, void* stream) {
  const int gw = 2 * U + 6 * H;
  const int threads = ((gw + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)clsr_scan_smem_bytes(U, H);
  cudaError_t err = cudaFuncSetAttribute(
      clsr_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  clsr_scan_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask, ushort_, whg1, whc1, wh4,
      whg2, whc2, outs, h1f, h2f, L, U, H);
  return (int)cudaGetLastError();
}

// 3xTF32 tensor-core helpers shared by K1 (eval_scorer.cu) and K3a/K3b
// (train_stats.cu), CUDA C++ for sm_90a.
//
// mma.sync m16n8k8 in TF32 keeps ~3 decimal digits of each operand.  The
// 3xTF32 split keeps products at about f32 accuracy: each f32 operand is
// a TF32 high part plus a remainder, and lo·hi + hi·lo + hi·hi are summed
// in the f32 accumulator (the lo·lo term is below f32 rounding).
//
// Fragment layouts (lane = 4g + t): A (16 x 8, row major) a0 = (g, t),
// a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4); B (8 x 8,
// column major) b0 = (t, g), b1 = (t + 4, g); C (16 x 8) c0 = (g, 2t),
// c1 = (g, 2t + 1), c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1).  The kernels
// permute K within each k-step (k = t -> feature 8 ks + 2t, k = t + 4 ->
// 8 ks + 2t + 1): an A pair is then one float2 load, and the C fragment
// of one product is the A fragment of the next in place.

#pragma once

#include <cuda_runtime.h>

namespace clsr {

// TF32 high part (round to nearest, ties away) and the remainder, whose
// f32 bits go to the unit as they are (it reads their top 19 bits)
__device__ __forceinline__ unsigned tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct SplitA {
  unsigned hi[4], lo[4];
};

__device__ __forceinline__ SplitA split_a(const float* a) {
  SplitA s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.hi[i] = tf32_hi(a[i]);
    s.lo[i] = __float_as_uint(a[i] - __uint_as_float(s.hi[i]));
  }
  return s;
}

// d += a·b on the tensor cores, 3xTF32: lo·hi + hi·lo + hi·hi; b is a
// staged fragment (hi0, hi1, lo0, lo1)
__device__ __forceinline__ void mma3(float* d, const SplitA& a, float4 b) {
  const unsigned bh[2] = {__float_as_uint(b.x), __float_as_uint(b.y)};
  const unsigned bl[2] = {__float_as_uint(b.z), __float_as_uint(b.w)};
#define CLSR_MMA(A, B)                                                      \
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "                 \
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                      \
      : "r"(A[0]), "r"(A[1]), "r"(A[2]), "r"(A[3]), "r"(B[0]), "r"(B[1]))
  CLSR_MMA(a.lo, bh);
  CLSR_MMA(a.hi, bl);
  CLSR_MMA(a.hi, bh);
#undef CLSR_MMA
}

// d += a·b as mma3, but the three products go into a zeroed fragment
// that f32 adds (round to nearest) then fold into d.  The tensor cores'
// own f32 accumulation is biased toward zero: over the k-steps of a
// product its error does not average out across rows, which a batch
// mean over few rows shows (PERF.md, §6).
__device__ __forceinline__ void mma3_add(float* d, const SplitA& a,
                                         float4 b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// Fragment e = (ks, n, lane) of W in the permuted K order: rows k and
// k + 1 of column col, split into high parts and remainders.
__device__ __forceinline__ void stage_fragment(float* dst, const float* w,
                                               int k, int col, int ld) {
  const float b0 = w[k * ld + col], b1 = w[(k + 1) * ld + col];
  const float h0 = __uint_as_float(tf32_hi(b0));
  const float h1 = __uint_as_float(tf32_hi(b1));
  dst[0] = h0;
  dst[1] = h1;
  dst[2] = b0 - h0;
  dst[3] = b1 - h1;
}

}  // namespace clsr

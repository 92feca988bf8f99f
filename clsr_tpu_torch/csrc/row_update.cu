// K5 (row scatter) and K4 (row sweep): set sorted rows of an [N, W] f32
// table, CUDA C++ for sm_90a.
//
// Both compute one function, the last write of the LazyAdam row update
// (clsr_tpu/training/lazy_adam.py:191-192, 315-322):
//
//   table[ids[j], :] = rows[j, :]   for every j with 0 <= ids[j] < N
//
// and drop every other id (the `mode="drop"` of the JAX scatter-set).  The
// ids are sorted; on the compact path they are unique, and on the legacy
// path duplicates carry identical rows, so whichever write lands is right.
//
// K5, clsr_row_scatter, replaces scripts/bench_pallas_update.py:
// rowdma_kernel (one DMA per updated row, straight to HBM).  It does O(M)
// work: a group of `tpr` threads (a warp, or a fraction of one for narrow
// rows) copies one row, 16 bytes a thread when W % 4 == 0.  It is bound by
// bytes: M row reads plus M row writes (5.6 us for 58,000 rows of 40 at
// 3.35 TB/s); at the train step's row counts it is latency-bound, a few
// microseconds of launch and one DRAM round trip.  No host sync: the ids
// past the valid prefix (>= N) are dropped here, so the caller never needs
// the number of valid rows on the host.
//
// K4, clsr_row_sweep, replaces scripts/bench_pallas_update.py:kernel (the
// streaming sweep: each grid step copies a [BLOCK, D] table slab through
// VMEM and overwrites the rows whose ids fall in it).  One block owns a
// slab of `block` table rows: it copies the whole slab from tin to tout,
// then (after __syncthreads, so the copy lands first) writes the rows whose
// ids fall in the slab.  The slab's segment of ids, starts[b] ..
// starts[b+1], comes from a searchsorted in the wrapper, as the TPU script
// computes its segment starts outside the kernel.  No two blocks touch one
// row.  Its bound is K5's, the function's own bytes, but it moves the whole
// table (O(N): 160 MB at 500,000 x 40, ~51 us at the H100's HBM rate, nine
// times those bytes), so the update path uses K5.  tin may equal tout (in
// place).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Copy rows[j] to table[ids[j]] for j in [j0, j1), group by group: `group`
// is this thread's group index, `groups` the number of groups, `lane` its
// place in the group of `tpr` threads.
template <bool kVec>
__device__ __forceinline__ void copy_rows(float* table, int N, int W,
                                          const int* __restrict__ ids,
                                          const float* __restrict__ rows,
                                          long long j0, long long j1,
                                          int group, int groups, int lane,
                                          int tpr) {
  for (long long j = j0 + group; j < j1; j += groups) {
    const int id = ids[j];
    if (id < 0 || id >= N) continue;
    if (kVec) {
      const int n4 = W / 4;
      const float4* src = reinterpret_cast<const float4*>(rows + j * W);
      float4* dst = reinterpret_cast<float4*>(table + (size_t)id * W);
      for (int k = lane; k < n4; k += tpr) dst[k] = src[k];
    } else {
      const float* src = rows + j * W;
      float* dst = table + (size_t)id * W;
      for (int k = lane; k < W; k += tpr) dst[k] = src[k];
    }
  }
}

template <bool kVec>
__global__ void row_scatter_kernel(float* table, int N, int W,
                                   const int* __restrict__ ids, int M,
                                   const float* __restrict__ rows, int tpr) {
  const int groups = kThreads / tpr;
  const int group = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const long long j0 = (long long)blockIdx.x * groups;
  const long long j1 = j0 + groups < M ? j0 + groups : M;
  copy_rows<kVec>(table, N, W, ids, rows, j0, j1, group, groups, lane, tpr);
}

template <bool kVec>
__global__ void row_sweep_kernel(const float* tin, float* tout, int N, int W,
                                 const int* __restrict__ ids,
                                 const int* __restrict__ starts,
                                 const float* __restrict__ rows, int block,
                                 int tpr) {
  const int b = blockIdx.x;
  const long long lo = (long long)b * block;
  const long long hi = lo + block < N ? lo + block : N;
  // 1. stream the slab through: every row of it read and written
  if (kVec) {
    const float4* src = reinterpret_cast<const float4*>(tin + lo * W);
    float4* dst = reinterpret_cast<float4*>(tout + lo * W);
    const long long n4 = (hi - lo) * W / 4;
    for (long long k = threadIdx.x; k < n4; k += kThreads) dst[k] = src[k];
  } else {
    const long long n = (hi - lo) * W;
    for (long long k = threadIdx.x; k < n; k += kThreads)
      tout[lo * W + k] = tin[lo * W + k];
  }
  __syncthreads();
  // 2. the updated rows whose ids fall in this slab
  copy_rows<kVec>(tout, N, W, ids, rows, starts[b], starts[b + 1],
                  threadIdx.x / tpr, kThreads / tpr, threadIdx.x % tpr, tpr);
}

// Threads per row: enough for one row's 16-byte (or 4-byte) units, a power
// of two up to a warp.
int threads_per_row(int W, int vec) {
  const int units = vec ? W / 4 : W;
  int tpr = 1;
  while (tpr < units && tpr < 32) tpr *= 2;
  return tpr;
}

}  // namespace

extern "C" int clsr_row_scatter(float* table, int N, int W, const int* ids,
                                int M, const float* rows, int vec,
                                void* stream) {
  if (M <= 0) return 0;
  const int tpr = threads_per_row(W, vec);
  const int groups = kThreads / tpr;
  const unsigned grid = (unsigned)((M + groups - 1) / groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    row_scatter_kernel<true><<<grid, kThreads, 0, s>>>(table, N, W, ids, M,
                                                       rows, tpr);
  else
    row_scatter_kernel<false><<<grid, kThreads, 0, s>>>(table, N, W, ids, M,
                                                        rows, tpr);
  return (int)cudaGetLastError();
}

extern "C" int clsr_row_sweep(const float* tin, float* tout, int N, int W,
                              const int* ids, const int* starts,
                              const float* rows, int block, int vec,
                              void* stream) {
  if (N <= 0) return 0;
  if (block <= 0 || (vec && W % 4 != 0)) return (int)cudaErrorInvalidValue;
  const int tpr = threads_per_row(W, vec);
  const unsigned grid = (unsigned)((N + block - 1) / block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    row_sweep_kernel<true><<<grid, kThreads, 0, s>>>(tin, tout, N, W, ids,
                                                     starts, rows, block, tpr);
  else
    row_sweep_kernel<false><<<grid, kThreads, 0, s>>>(tin, tout, N, W, ids,
                                                      starts, rows, block,
                                                      tpr);
  return (int)cudaGetLastError();
}

// K5 (row scatter, grouped) and K4 (row sweep): set sorted rows of [N, W]
// tables, CUDA C++ for sm_90a: K5 on f32 and bf16 rows, K4 on f32.
//
// Both compute one function, the last write of the LazyAdam row update
// (clsr_tpu/training/lazy_adam.py:191-192, 315-322):
//
//   table[ids[j], :] = rows[j, :]   for every j with 0 <= ids[j] < N
//
// and drop every other id (the `mode="drop"` of the JAX scatter-set).  The
// ids are sorted; on the compact path they are unique, and on the legacy
// path duplicates carry identical rows, so whichever write lands is right.
// Both are bound by the function's bytes: the ids, the rows read, the
// valid rows written (18.8 MB, 5.6 us at 3.35 TB/s, for 58,000 rows of
// 40; at a train step's row counts a launch and one DRAM round trip).
//
// K5, clsr_row_scatter_group, replaces scripts/bench_pallas_update.py:
// rowdma_kernel (one DMA per updated row, straight to HBM).  One launch
// serves up to kMaxEntries (table, ids, rows) entries, passed by value as
// a __grid_constant__ kernel parameter: no host-to-device copy, no sync.
// The host gives each entry its first block from the entries' shapes; a
// block finds its entry by scanning those offsets.  Inside an entry the
// flattened (row, 16-byte unit) space maps onto threads, so no lane idles
// whatever W is, and each thread issues the loads of kUnitsVec units (ids
// and rows) before its first store.  Each entry carries its element size (4
// for f32, 2 for bf16: a lazy step's group mixes bf16 tables with their f32
// pmn rows), and the kernel only moves bits: an entry whose row bytes are a
// multiple of 16 and whose bases are 16-byte aligned takes 16-byte units
// (bf16 rows of 40, 32 and 8 are 80, 64 and 16 bytes), any other takes
// units of its element size, in the same launch.  (A
// Hopper bulk-copy design, one cp.async.bulk of a block's rows into shared
// memory, then one bulk store per row, was measured beside it and was no
// faster on the card: PERF.md.)  Ids past the valid prefix (>= N) are
// dropped here, so the caller never needs the valid count on the host.
//
// K4, clsr_row_sweep, replaces scripts/bench_pallas_update.py:kernel (the
// streaming sweep: each grid step moves a [BLOCK, D] table slab through
// VMEM and overwrites the rows whose ids fall in it).  On Hopper the table
// stays in HBM: one block owns a slab of `block` table rows, finds its
// segment [lower_bound(b * block), lower_bound((b + 1) * block)) of the
// sorted ids itself by a 256-ary search (two rounds of parallel loads for
// up to 65,536 ids), exits at once if the segment is empty, and moves the
// segment's rows with K5's flattened copy.  No two blocks touch one row,
// and only the rows move, in place.  The search's rounds are dependent
// loads, so each block first asks L2 for its share of the ids' and rows'
// lines: the rounds and the copy then read L2.  Dense slabs (the bench:
// 245 slabs for 58,000 rows) take blocks of 1,024 threads, two an SM, so
// all are in flight and each copies its rows in about one pass; sparse
// slabs (the item table: 2,033 slabs for 22,000 rows) take blocks of 128,
// sixteen an SM, so all 2,033 are resident at once.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // K5
constexpr int kSparseThreads = 128;  // K4 on sparse slabs: 16 blocks an SM
constexpr int kWideThreads = 1024;   // K4 on dense slabs: 2 blocks an SM
constexpr int kSamples = 256;        // K4's search samples per round
constexpr int kMaxEntries = 16;      // entries of one grouped launch
constexpr int kUnitsVec = 4;         // 16-byte units in flight a thread
constexpr int kUnitsScalar = 8;      // 4- or 2-byte units in flight a thread

// units in flight a thread, by unit: 16 bytes, or one element of 4 or 2
template <typename T> struct PerThread {
  static constexpr int value = sizeof(T) == 16 ? kUnitsVec : kUnitsScalar;
};

// Copy units [u0, u1) of the flattened (row j, unit c) space of `rows`
// ([M, n] units of T) to unit c of table row ids[j], dropping ids outside
// [0, N).  Thread t of kT takes u0 + t, u0 + t + kT, ...: it loads its
// units' ids and rows, then stores them.
template <typename T, int kT>
__device__ __forceinline__ void copy_units(void* __restrict__ table, int N,
                                           unsigned n,
                                           const int* __restrict__ ids,
                                           const void* __restrict__ rows,
                                           unsigned u0, unsigned u1) {
  constexpr int U = PerThread<T>::value;
  const T* src = reinterpret_cast<const T*>(rows);
  T* dst = reinterpret_cast<T*>(table);
  for (unsigned base = u0 + threadIdx.x; base < u1; base += U * kT) {
    T v[U];
    long long to[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const unsigned u = base + k * kT;
      to[k] = -1;
      if (u < u1) {
        const unsigned j = u / n;
        const int id = __ldg(ids + j);
        v[k] = __ldcs(src + u);
        if (id >= 0 && id < N) to[k] = (long long)id * n + (u - j * n);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (to[k] >= 0) dst[to[k]] = v[k];
  }
}

enum UnitKind { kUnit16 = 0, kUnit4 = 1, kUnit2 = 2 };

struct Entry {
  void* table;
  const int* ids;
  const void* rows;
  int N, M;
  unsigned n;  // units a row
  int unit;    // UnitKind
};

struct Group {
  Entry e[kMaxEntries];
  int first[kMaxEntries + 1];  // first block of each entry, then the grid
  int count;
};

template <typename T>
__device__ __forceinline__ void scatter_block(const Entry& t, unsigned lb) {
  const unsigned span = kThreads * PerThread<T>::value;
  const unsigned total = (unsigned)t.M * t.n;
  const unsigned u0 = lb * span;
  const unsigned u1 = total - u0 < span ? total : u0 + span;
  copy_units<T, kThreads>(t.table, t.N, t.n, t.ids, t.rows, u0, u1);
}

__global__ void __launch_bounds__(kThreads)
    row_scatter_group_kernel(const __grid_constant__ Group g) {
  int e = 0;
  for (int k = 1; k < g.count; ++k)
    if ((int)blockIdx.x >= g.first[k]) e = k;
  const Entry& t = g.e[e];
  const unsigned lb = blockIdx.x - g.first[e];
  if (t.unit == kUnit16)
    scatter_block<uint4>(t, lb);
  else if (t.unit == kUnit4)
    scatter_block<unsigned>(t, lb);
  else
    scatter_block<unsigned short>(t, lb);
}

// s0 = the first j with ids[j] >= x0, s1 = the first with ids[j] >= x1:
// two lower bounds found together.  Each round the block loads kSamples
// evenly spaced samples of each open interval (kSamples / kT a thread, all
// in flight at once), __syncthreads_count counts the samples below the
// bound (a prefix: the ids are sorted), and the interval shrinks to under
// 1/kSamples of itself: two rounds for up to 65,536 ids.  Every thread
// ends with the same s0, s1.
template <int kT>
__device__ __forceinline__ void segment(const int* __restrict__ ids, int M,
                                        long long x0, long long x1,
                                        int& s0, int& s1) {
  constexpr int kS = kSamples > kT ? kSamples / kT : 1;
  constexpr int kN = kT * kS;
  int lo[2] = {0, 0}, hi[2] = {M, M};
  const long long x[2] = {x0, x1};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    int step[2], c[2] = {0, 0};
    bool below[2][kS];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      step[i] = (hi[i] - lo[i] + kN - 1) / kN;
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const long long p =
            lo[i] + (long long)(threadIdx.x + k * kT) * step[i];
        below[i][k] = p < hi[i] && __ldg(ids + p) < x[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < kS; ++k) c[i] += __syncthreads_count(below[i][k]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (lo[i] >= hi[i]) continue;
      const long long cap = lo[i] + (long long)c[i] * step[i];
      const int next_lo = c[i] ? lo[i] + (c[i] - 1) * step[i] + 1 : lo[i];
      hi[i] = cap < hi[i] ? (int)cap : hi[i];
      lo[i] = next_lo;
    }
  }
  s0 = lo[0];
  s1 = lo[1];
}

// Ask L2 for this block's share of the 128-byte lines of ids and rows
// (`row_floats` floats), so that the searches and the copy find them
// there: the rows are read once either way, now while the block searches.
template <int kT>
__device__ __forceinline__ void prefetch_share(const int* ids, int M,
                                               const float* rows,
                                               long long row_floats) {
  const long long id_lines = ((long long)M + 31) / 32;
  const long long lines = id_lines + (row_floats + 31) / 32;
  const long long end = lines * (blockIdx.x + 1) / gridDim.x;
  for (long long l = lines * blockIdx.x / gridDim.x + threadIdx.x; l < end;
       l += kT) {
    const void* p = l < id_lines ? (const void*)(ids + 32 * l)
                                 : (const void*)(rows + 32 * (l - id_lines));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
  }
}

template <bool kVec, int kT>
__global__ void __launch_bounds__(kT, kT == kWideThreads ? 2 : 16)
    row_sweep_kernel(float* table, int N, unsigned n,
                     const int* __restrict__ ids, int M,
                     const float* __restrict__ rows, int block) {
  using T = typename std::conditional<kVec, uint4, unsigned>::type;
  prefetch_share<kT>(ids, M, rows, (long long)M * n * (kVec ? 4 : 1));
  const long long lo = (long long)blockIdx.x * block;
  int s0, s1;
  segment<kT>(ids, M, lo, lo + block, s0, s1);
  if (s0 < s1)
    copy_units<T, kT>(table, N, n, ids, rows, (unsigned)s0 * n,
                      (unsigned)s1 * n);
}

template <bool kVec>
void launch_sweep(bool wide, unsigned grid, cudaStream_t s, float* table,
                  int N, unsigned n, const int* ids, int M, const float* rows,
                  int block) {
  if (wide)
    row_sweep_kernel<kVec, kWideThreads><<<grid, kWideThreads, 0, s>>>(
        table, N, n, ids, M, rows, block);
  else
    row_sweep_kernel<kVec, kSparseThreads><<<grid, kSparseThreads, 0, s>>>(
        table, N, n, ids, M, rows, block);
}

// Runs on device `device`, switched to and back only when it is not the
// current one; returns the launch's cudaError_t.
template <typename Launch>
int on_device(int device, Launch launch) {
  int current = device;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  launch();
  const int rc = (int)cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return rc;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
T* as_ptr(long long v) {
  return reinterpret_cast<T*>(static_cast<intptr_t>(v));
}

}  // namespace

// The C entries take one array of int64s, which ctypes passes as one
// pointer: the cheapest call from Python.

// args: count (<= kMaxEntries), device, stream, then `count` entries of
// seven: table, N, W, ids (int32), M, rows, element size (4 or 2).  Entries
// with no work are skipped.
extern "C" int clsr_row_scatter_group(const long long* args) {
  const long long count = args[0];
  const int device = (int)args[1];
  cudaStream_t s = as_ptr<CUstream_st>(args[2]);
  const long long* desc = args + 3;
  if (count < 0 || count > kMaxEntries) return (int)cudaErrorInvalidValue;
  Group g = {};
  long long blocks = 0;
  int k = 0;
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + 7 * i;
    const long long N = d[1], W = d[2], M = d[4], esize = d[6];
    if (N < 0 || W < 0 || M < 0 || N > INT_MAX || W > INT_MAX ||
        M > INT_MAX || (esize != 4 && esize != 2))
      return (int)cudaErrorInvalidValue;
    if (N == 0 || W == 0 || M == 0) continue;
    Entry& t = g.e[k];
    t.table = as_ptr<void>(d[0]);
    t.ids = as_ptr<const int>(d[3]);
    t.rows = as_ptr<const void>(d[5]);
    t.N = (int)N;
    t.M = (int)M;
    const long long row_bytes = W * esize;
    const bool vec =
        row_bytes % 16 == 0 && aligned16(t.table) && aligned16(t.rows);
    t.unit = vec ? kUnit16 : esize == 4 ? kUnit4 : kUnit2;
    const long long n = vec ? row_bytes / 16 : W;
    if (M * n > INT_MAX) return (int)cudaErrorInvalidValue;
    t.n = (unsigned)n;
    const long long span = kThreads * (vec ? kUnitsVec : kUnitsScalar);
    g.first[k++] = (int)blocks;
    blocks += (M * n + span - 1) / span;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  g.count = k;
  g.first[k] = (int)blocks;
  if (k == 0) return 0;
  return on_device(device, [&] {
    row_scatter_group_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(g);
  });
}

// Blocks of kWideThreads when the average slab holds more units than a
// quarter of their pass, else of kSparseThreads (the slabs are then
// sparse or empty, and small blocks, all resident at once, search them).
// f32 only.  args: table, N, W, ids (int32), M, rows, block, device, stream.
extern "C" int clsr_row_sweep(const long long* args) {
  if (args[1] > INT_MAX || args[2] > INT_MAX || args[4] > INT_MAX ||
      args[6] > INT_MAX)
    return (int)cudaErrorInvalidValue;
  float* table = as_ptr<float>(args[0]);
  const int N = (int)args[1], W = (int)args[2], M = (int)args[4];
  const int* ids = as_ptr<const int>(args[3]);
  const float* rows = as_ptr<const float>(args[5]);
  const int block = (int)args[6], device = (int)args[7];
  cudaStream_t s = as_ptr<CUstream_st>(args[8]);
  if (N <= 0 || W <= 0 || M <= 0) return 0;
  if (block <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && aligned16(table) && aligned16(rows);
  const unsigned n = vec ? W / 4 : W;
  if ((long long)M * n > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long slabs = (N + (long long)block - 1) / block;
  const bool wide = (long long)M * n > slabs * kWideThreads;
  return on_device(device, [&] {
    if (vec)
      launch_sweep<true>(wide, (unsigned)slabs, s, table, N, n, ids, M, rows,
                         block);
    else
      launch_sweep<false>(wide, (unsigned)slabs, s, table, N, n, ids, M,
                          rows, block);
  });
}

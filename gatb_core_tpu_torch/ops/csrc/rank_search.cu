// Rank of multi-limb rows in a sorted table, written for Hopper (sm_90a).
//
// rank_rows has no Pallas original. It replaces the sort-join of
// gatb_core_tpu/ops/sortops.py (rank_join_traced, :839-884: two lax.sort
// calls over table + queries and three scans) and the gather loop of
// gatb_core_tpu/collections/sortedset.py (_searchsorted_limbs, :28-50). The
// JAX package co-sorts table and queries because its device gathers slowly;
// on this card a data-dependent load is cheap, so the kernel searches.
//
// Contract (that of rank_join_traced): for each of Q query rows of W
// uint32 limbs, rank = index of the equal row among the first n_table rows
// of the ascending table, or -1, and found = (rank >= 0), in query order.
// Rows compare as big-endian unsigned integers (limb 0 most significant).
// Rows at n_table and beyond are padding and never looked at; the all-ones
// row is never found; n_table == 0 finds nothing.
//
// Layout: ROW-MAJOR, table (C, W) and queries (Q, W), not the (P, N) planes
// of limb_sort.cu: a probe reads one row at a data-dependent index, and
// row-major puts its W limbs, and a node's rows, into one line. It is also
// the JAX signature. The buffers are torch int32 storage read as uint32_t.
//
// What bounds it: bytes, by the contract's count (queries read once, the
// live table read once, 5 bytes out per query). What it takes in practice
// is the chain of dependent probes per query and the lines they touch. The
// first version, a lower-bound binary search over the table, made about
// log2(n_table) probes a query in as many lines, and each scattered probe
// costs the SM one L1 wavefront per distinct line. This one walks a B+
// index of the table, built once per table by ops/rank_search.py
// (RankIndex):
//
//   - A node is B rows, one 128-byte line: B = 32 at 1 limb, 16 at 2, 8 at
//     3 (96 bytes) and 4, 4 at 8. The leaf blocks are the table's own rows,
//     B at a time. Level 1 holds the LAST live row of each leaf block,
//     level 2 the last key of each node of level 1, and so on up to a root
//     of at most B keys. The levels are stored top first in one buffer,
//     each padded with all-ones keys to whole nodes, which are below no
//     query; the index is about 1/(B - 1) of the table (15.3 MiB for 30M
//     rows of 2 limbs).
//   - Nothing is staged in shared memory. A query walks every level in
//     device memory, one query per thread on a plain grid. Levels at 2^20
//     / 30M rows (and the index's MiB): 1 limb 3 (0.13) / 4 (3.7); 2 limbs
//     4 (0.53) / 6 (15.3); 3 limbs 6 (1.7) / 8 (49); 4 limbs 6 (2.3) / 8
//     (65); 8 limbs 9 (10.7) / 12 (305). A form that copied the top levels
//     (up to 64 KB) into shared memory once per block with cp.async, on a
//     persistent grid, was built and timed beside the same kernel with none
//     copied: the stress sweep step 0.458 against 0.458 ms, 2^24 random
//     queries 1.995 against 1.949, the k=63 sweep 0.232 against 0.237, 8 x
//     2^20 queries on 2^20 rows 0.630 against 0.556 (PERF.md, PR 9). The
//     top levels, which every query touches, stay in L1 without the copy,
//     so the copy, its budget and its occupancy-sized grid went.
//   - In each node the thread's child is the number of keys below its
//     query: a binary search of log2(B) probes without a branch, all in
//     that node's one line, so a query touches one line a level (two index
//     lines past L1 and the leaf line on a 30M-row table, where the first
//     version touched ~10 lines that miss L1). The child is clamped to the
//     level's last key, so a query above every row walks the rightmost
//     path and finds nothing equal.
//   - Only a hit needs its position. The table is distinct, so the walk
//     needs only the row equal to the query, if it lies among the first
//     n_table rows: the leaf search masks rows at n_table and beyond by
//     position and never reads them (so a padded or partial last block is
//     safe whatever it holds), then one equality test.
//
// Two designs that read each line by a group of lanes were built and
// timed first (gatb_core_tpu_torch/tools/rank_sweep.py, PERF.md): 8 lanes
// comparing a node's rows with one query and __ballot_sync / __popc for the
// child, and 8 lanes copying each thread's line into shared memory for a
// per-thread search. Both lost to the first version at the main path's
// shape (the candidates of 2^21 sorted nodes on the 30M-row table): eight
// lanes repeat the control work of one query, and a staged copy per thread
// cannot share the lines that neighbouring candidates share in L1.
//
// W is a template parameter for 1, 2, 3, 4 and 8 limbs (k <= 16, 32, 48,
// 64, 128). Any other W keeps the first version's search
// (rank_rows_any_kernel: a binary search per thread, limbs read one by
// one) and ignores the index.
//
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): the kernel at 1 / 2 / 3 / 4 / 8 limbs
// uses 23 / 21 / 24 / 22 / 30 registers, the any-W kernel 26, no spill,
// no stack; blocks of 256 threads (1024 read 2-8% slower at every shape).
//
// Measured on an H100 80GB HBM3 (700 W), CUDA events, the index built,
// beside the first version in the same run (tools/rank_sweep.py and
// chip_smoke.py's timing phase, this tree and a git-archive copy of the
// parent in turns; two calls), in ms: the stress sweep step (2^24
// candidates of 2^21 sorted nodes, 30M rows, 2 limbs) 0.443-0.473 (first
// version 0.613-0.649); 2^24 random queries on that table 1.82-1.88
// (3.15-3.20); 8 x 2^20 random queries on 2^20 rows 0.568-0.593 at 2
// limbs (0.633-0.659) and 0.657-0.732 at 4 (0.694-0.718); the k=63
// candidate sweep (523,394 rows, 4 limbs) 0.194-0.223 (0.170-0.175). The
// index build: 0.06-0.12 ms at 2^20 rows, 0.17-0.25 at 30M. The gain is
// the layout: a level's probes share one line, which the first brings
// into L1. At 4 limbs a node is 8 rows, the walk probes as often as a
// binary search of the table, and the table (8-16 MB) sits in L2: there
// the index gains little, and the k=63 sweep reads 12-27% slower than the
// first version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads per block, both kernels
constexpr int kMaxLevels = 32;

// The index's levels, top first: level l holds length[l] keys from row
// offset[l] of the index buffer (offset[count] = the buffer's rows).
struct Levels {
  long long offset[kMaxLevels + 1];
  unsigned length[kMaxLevels];
  int count;
};

// The rows of a node at W limbs (node_rows in ops/rank_search.py agrees).
template <int W>
constexpr int kRows = W == 1 ? 32 : W == 2 ? 16 : W <= 4 ? 8 : 4;

// A row of N words into registers through the read-only path: as 16- or
// 8-byte vectors where N allows it (every row starts at a multiple of its
// vector size: the wrapper hands over 16-byte aligned buffers), else word
// by word.
template <int N>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&v)[N]) {
  if constexpr (N % 4 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const uint4 t = __ldg(q + j);
      v[4 * j] = t.x;
      v[4 * j + 1] = t.y;
      v[4 * j + 2] = t.z;
      v[4 * j + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = __ldg(p + j);
  }
}

// Row a below the key, without a branch.
template <int W>
__device__ __forceinline__ bool row_less(const uint32_t (&a)[W],
                                         const uint32_t (&key)[W]) {
  bool lt = false, eq = true;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    lt = lt | (eq & (a[j] < key[j]));
    eq = eq & (a[j] == key[j]);
  }
  return lt;
}

template <int W>
__device__ __forceinline__ bool row_equal(const uint32_t (&a)[W],
                                          const uint32_t (&key)[W]) {
  bool eq = true;
#pragma unroll
  for (int j = 0; j < W; ++j) eq = eq & (a[j] == key[j]);
  return eq;
}

// The number of the first `valid` rows of a node (B rows of W words from
// `node`) that lie below the key: a binary search of log2(B) probes, all
// inside the node's one line, without a branch (the next probe's load must
// not wait for a branch on this one). Rows at `valid` and beyond
// (valid >= 1) are masked by position and never read. The count stops at
// B - 1: a node whose every row lies below the key ends the walk where the
// caller clamps it.
template <int W>
__device__ __forceinline__ unsigned count_below(const uint32_t* node,
                                                const uint32_t (&key)[W],
                                                unsigned valid) {
  unsigned lo = 0;
#pragma unroll
  for (int step = kRows<W> / 2; step >= 1; step >>= 1) {
    const unsigned i = lo + step - 1;
    uint32_t row[W];
    load_words<W>(node + min(i, valid - 1) * W, row);
    lo = (i < valid) & row_less<W>(row, key) ? lo + step : lo;
  }
  return lo;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
rank_rows_kernel(const uint32_t* __restrict__ table,
                 const uint32_t* __restrict__ index,
                 const __grid_constant__ Levels lv,
                 const uint32_t* __restrict__ queries,
                 int32_t* __restrict__ rank, uint8_t* __restrict__ found,
                 long long n_queries, unsigned n_table) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_queries) return;
  uint32_t key[W];
  load_words<W>(queries + q * W, key);
  unsigned node = 0;
  for (int l = 0; l < lv.count; ++l) {
    const unsigned below = count_below<W>(
        index + (lv.offset[l] + static_cast<long long>(node) * kRows<W>) * W,
        key, kRows<W>);
    node = min(node * kRows<W> + below, lv.length[l] - 1);
  }
  // the leaf block: the table's rows, those at n_table and beyond masked by
  // position
  const long long first = static_cast<long long>(node) * kRows<W>;
  const unsigned valid = static_cast<unsigned>(
      min(static_cast<long long>(kRows<W>),
          static_cast<long long>(n_table) - first));
  bool hit = false;
  unsigned pos = 0;
  if (valid > 0) {
    const uint32_t* leaf = table + first * W;
    pos = count_below<W>(leaf, key, valid);
    uint32_t row[W];
    load_words<W>(leaf + min(pos, valid - 1) * W, row);
    bool ones = true;
#pragma unroll
    for (int j = 0; j < W; ++j) ones = ones & (key[j] == 0xFFFFFFFFu);
    hit = (pos < valid) & !ones & row_equal<W>(row, key);
  }
  rank[q] = hit ? static_cast<int32_t>(first + pos) : -1;
  found[q] = hit ? 1 : 0;
}

// Any number of limbs: the first version's binary search, one thread per
// query, down to the last row, limbs read one by one.
__device__ __forceinline__ int compare_rows_any(const uint32_t* a,
                                                const uint32_t* b, int w) {
  for (int j = 0; j < w; ++j) {
    const uint32_t x = __ldg(a + j), y = __ldg(b + j);
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
rank_rows_any_kernel(const uint32_t* __restrict__ table,
                     const uint32_t* __restrict__ queries,
                     int32_t* __restrict__ rank, uint8_t* __restrict__ found,
                     long long n_queries, long long n_table, int w) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_queries) return;
  const uint32_t* key = queries + q * w;
  bool all_ones = true;
  for (int j = 0; j < w; ++j) {
    all_ones = all_ones && __ldg(key + j) == 0xFFFFFFFFu;
  }
  long long lo = 0, hi = n_table;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (compare_rows_any(table + mid * w, key, w) < 0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const bool hit = lo < n_table && !all_ones &&
                   compare_rows_any(table + lo * w, key, w) == 0;
  rank[q] = hit ? static_cast<int32_t>(lo) : -1;
  found[q] = hit ? 1 : 0;
}

}  // namespace

extern "C" {

// table (>= n_table rows, w limbs each), the index buffer (offsets[count]
// rows, levels top first: level l has lengths[l] keys from row offsets[l])
// and queries (n_queries rows) are row-major and 16-byte aligned; rank is
// int32[n_queries], found is uint8[n_queries]. For w outside
// {1, 2, 3, 4, 8} the index is not read. Returns the launch's cudaError_t
// (0 = launched; nothing is launched for n_queries == 0).
int rank_rows(const void* table, const void* index, const long long* offsets,
              const long long* lengths, int count, const void* queries,
              void* rank, void* found, long long n_queries,
              long long n_table, int w, void* stream) {
  if (n_queries <= 0) return 0;
  const long long blocks = (n_queries + kThreads - 1) / kThreads;
  if (w < 1 || n_table < 0 || n_table > 0x7FFFFFFFLL ||
      blocks > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* t = static_cast<const uint32_t*>(table);
  const uint32_t* x = static_cast<const uint32_t*>(index);
  const uint32_t* q = static_cast<const uint32_t*>(queries);
  int32_t* r = static_cast<int32_t*>(rank);
  uint8_t* f = static_cast<uint8_t*>(found);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  const unsigned n = static_cast<unsigned>(n_table);
  if (w == 1 || w == 2 || w == 3 || w == 4 || w == 8) {
    if (count < 0 || count > kMaxLevels || (n_table > 0 && count == 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Levels lv{};
    lv.count = count;
    for (int l = 0; l <= count; ++l) lv.offset[l] = offsets[l];
    for (int l = 0; l < count; ++l) {
      lv.length[l] = static_cast<unsigned>(lengths[l]);
    }
    switch (w) {
      case 1:
        rank_rows_kernel<1><<<grid, kThreads, 0, s>>>(t, x, lv, q, r, f,
                                                      n_queries, n);
        break;
      case 2:
        rank_rows_kernel<2><<<grid, kThreads, 0, s>>>(t, x, lv, q, r, f,
                                                      n_queries, n);
        break;
      case 3:
        rank_rows_kernel<3><<<grid, kThreads, 0, s>>>(t, x, lv, q, r, f,
                                                      n_queries, n);
        break;
      case 4:
        rank_rows_kernel<4><<<grid, kThreads, 0, s>>>(t, x, lv, q, r, f,
                                                      n_queries, n);
        break;
      default:
        rank_rows_kernel<8><<<grid, kThreads, 0, s>>>(t, x, lv, q, r, f,
                                                      n_queries, n);
    }
  } else {
    rank_rows_any_kernel<<<grid, kThreads, 0, s>>>(t, q, r, f, n_queries,
                                                   n_table, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

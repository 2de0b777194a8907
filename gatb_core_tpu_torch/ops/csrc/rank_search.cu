// Rank of multi-limb rows in a sorted table, written for Hopper (sm_90a).
//
// rank_rows has no Pallas original. It replaces the sort-join of
// gatb_core_tpu/ops/sortops.py (rank_join_traced, :839-884: two lax.sort
// calls over table + queries and three scans) and the gather loop of
// gatb_core_tpu/collections/sortedset.py (_searchsorted_limbs, :28-50). The
// JAX package co-sorts table and queries because its device gathers slowly;
// on this card a data-dependent load is cheap, so the search is what it
// says: one thread per query, a lower-bound binary search among the first
// n_table rows, then one equality test.
//
// Contract (that of rank_join_traced): for each of Q query rows of W
// uint32 limbs, rank = index of the equal row among the first n_table rows
// of the ascending table, or -1, and found = (rank >= 0), in query order.
// Rows compare as big-endian unsigned integers (limb 0 most significant).
// Rows at n_table and beyond are padding and never looked at; the all-ones
// row is never found; n_table == 0 finds nothing.
//
// Layout: ROW-MAJOR, table (C, W) and queries (Q, W), not the (P, N) planes
// of limb_sort.cu. The sort kernels stream whole planes, so planes coalesce
// there; a probe reads ONE row at a data-dependent index, and row-major
// puts its W limbs into one 8- or 16-byte load (one 32-byte sector) where
// planes would cost W sectors. It is also the JAX signature. The buffers
// are torch int32 storage read as uint32_t.
//
// What bounds it: bytes, by the contract's count (queries read once, table
// read once, 5 bytes out per query). What it really takes is about
// log2(n_table) dependent loads per query. The first dozen levels of the
// implicit search tree are shared by every thread and stay in L1; a table
// of 2^20 rows of 8 bytes fits the 50 MB L2 whole, so the rest are L2 hits,
// one 32-byte sector each, and the sectors are what the kernel waits for.
// So the binary search stops when kTail rows are left and the thread reads
// those at once: loads of neighbouring rows, in one or two sectors, that
// depend on lo and hi only and so issue together, in place of two more
// dependent steps. Every compare is branch-free for the same reason: a
// branch on a loaded row holds the next load back. Measured by
// chip_smoke.py on an H100 (700 W), 2^23 queries on 2^20 rows, 2 / 4 limbs:
// 0.64-0.69 / 0.69-0.70 ms with a tail of 4 rows, 0.76 / 0.78 ms with a
// search down to the last row, 0.76 / 0.89 ms with a tail of 8;
// torch.searchsorted on int64 keys (2 limbs only) 0.65 ms. Neighbour threads hold neighbour
// queries, and the postsolid sweeps query the neighbours of SORTED nodes,
// so a warp's probes often share sectors too. Nothing is staged in shared
// memory.
//
// W is a template parameter for 1, 2, 3, 4 and 8 limbs (k <= 16, 32, 48,
// 64, 128): the query row lives in registers and a table row is loaded as
// one vector where W allows it. Any other W runs the same search with the
// limbs read one by one, down to the last row.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTail = 4;  // rows left when the binary search stops

// Row `idx` of a row-major (rows, W) array into registers, as the widest
// aligned vectors W allows (the wrapper hands over 16-byte aligned bases).
template <int W>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ base,
                                         long long idx, uint32_t (&r)[W]) {
  if constexpr (W % 4 == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(base) + idx * (W / 4);
#pragma unroll
    for (int j = 0; j < W / 4; ++j) {
      uint4 t = __ldg(p + j);
      r[4 * j] = t.x;
      r[4 * j + 1] = t.y;
      r[4 * j + 2] = t.z;
      r[4 * j + 3] = t.w;
    }
  } else if constexpr (W % 2 == 0) {
    const uint2* p = reinterpret_cast<const uint2*>(base) + idx * (W / 2);
#pragma unroll
    for (int j = 0; j < W / 2; ++j) {
      uint2 t = __ldg(p + j);
      r[2 * j] = t.x;
      r[2 * j + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = __ldg(base + idx * W + j);
  }
}

// Row a below row b, without a branch: the loads of the rows that the tail
// compares must not wait for one another's outcome.
template <int W>
__device__ __forceinline__ bool row_less(const uint32_t (&a)[W],
                                         const uint32_t (&b)[W]) {
  bool lt = false, eq = true;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    lt = lt | (eq & (a[j] < b[j]));
    eq = eq & (a[j] == b[j]);
  }
  return lt;
}

template <int W>
__device__ __forceinline__ bool row_equal(const uint32_t (&a)[W],
                                          const uint32_t (&b)[W]) {
  bool eq = true;
#pragma unroll
  for (int j = 0; j < W; ++j) eq = eq & (a[j] == b[j]);
  return eq;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
rank_rows_kernel(const uint32_t* __restrict__ table,
                 const uint32_t* __restrict__ queries,
                 int32_t* __restrict__ rank, uint8_t* __restrict__ found,
                 long long n_queries, unsigned n_table) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_queries) return;
  uint32_t key[W];
  load_row<W>(queries, q, key);
  bool all_ones = true;
#pragma unroll
  for (int j = 0; j < W; ++j) all_ones = all_ones & (key[j] == 0xFFFFFFFFu);
  // the lower bound lies in [lo, hi]; n_table < 2^31, so lo + hi fits
  unsigned lo = 0, hi = n_table;
  while (hi - lo > kTail) {
    const unsigned mid = (lo + hi) >> 1;
    uint32_t row[W];
    load_row<W>(table, mid, row);
    const bool below = row_less<W>(row, key);
    lo = below ? mid + 1 : lo;
    hi = below ? hi : mid;
  }
  // what is left of [lo, hi): its rows below the key are a prefix. The
  // loads depend on lo and hi only, so they issue together
  unsigned pos = lo;
#pragma unroll
  for (int j = 0; j < kTail; ++j) {
    const unsigned i = lo + j;
    if (i < hi) {
      uint32_t row[W];
      load_row<W>(table, i, row);
      pos = row_less<W>(row, key) ? i + 1 : pos;
    }
  }
  bool hit = false;
  if (pos < n_table) {
    uint32_t row[W];
    load_row<W>(table, pos, row);
    hit = row_equal<W>(row, key);
  }
  hit = hit & !all_ones;
  rank[q] = hit ? static_cast<int32_t>(pos) : -1;
  found[q] = hit ? 1 : 0;
}

// Any number of limbs: a binary search down to the last row, limbs read
// one by one.
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

template <int W>
void launch(const uint32_t* table, const uint32_t* queries, int32_t* rank,
            uint8_t* found, long long n_queries, long long n_table,
            unsigned blocks, cudaStream_t stream) {
  rank_rows_kernel<W><<<blocks, kThreads, 0, stream>>>(
      table, queries, rank, found, n_queries,
      static_cast<unsigned>(n_table));
}

}  // namespace

extern "C" {

// table (>= n_table rows, w limbs each) and queries (n_queries rows) are
// row-major and 16-byte aligned; rank is int32[n_queries], found is
// uint8[n_queries]. Returns the launch's cudaError_t (0 = launched; nothing
// is launched for n_queries == 0).
int rank_rows(const void* table, const void* queries, void* rank, void* found,
              long long n_queries, long long n_table, int w, void* stream) {
  if (n_queries <= 0) return 0;
  if (w < 1 || n_table < 0 || n_table > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks64 = (n_queries + kThreads - 1) / kThreads;
  if (blocks64 > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(blocks64);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  const uint32_t* q = static_cast<const uint32_t*>(queries);
  int32_t* r = static_cast<int32_t*>(rank);
  uint8_t* f = static_cast<uint8_t*>(found);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 1: launch<1>(t, q, r, f, n_queries, n_table, blocks, s); break;
    case 2: launch<2>(t, q, r, f, n_queries, n_table, blocks, s); break;
    case 3: launch<3>(t, q, r, f, n_queries, n_table, blocks, s); break;
    case 4: launch<4>(t, q, r, f, n_queries, n_table, blocks, s); break;
    case 8: launch<8>(t, q, r, f, n_queries, n_table, blocks, s); break;
    default:
      rank_rows_any_kernel<<<blocks, kThreads, 0, s>>>(t, q, r, f, n_queries,
                                                       n_table, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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
//
// neighbor_masks, in the same file so that it shares the walk: the 8-bit
// adjacency mask of each node (bit j set when candidate j is a live row of
// the table; 0-3 out by nt, 4-7 in by nt). It has no Pallas original
// either. It replaces the JAX package's neighbor_candidates
// (gatb_core_tpu/ops/neighbor_ops.py:83) followed by the sort-join
// (gatb_core_tpu/ops/sortops.py:839) and the pack of
// gatb_core_tpu/debruijn/graph.py's _adjacency_kernel; in the port it
// replaces the chain neighbor_candidates -> as_rows -> rank_rows -> pack,
// about 250 eager launches a call at W = 2, which held the query API to the
// host's dispatch. Eight lanes a node, in aligned groups of 8 within a
// warp: each lane loads the node's row, builds its reverse complement and
// its one candidate in registers (a tie of the two strands is the same
// row, whichever is taken), looks it up as rank_rows does (the index's
// walk at W = 1, 2, 3, 4, 8, the binary search at 5-7), and the group's
// ballot gives its first lane the mask to write. Nothing else is written:
// no candidate tensor, no found flags.
//
// What bounds it: bytes, by the contract's count, a node's row read, 8
// table rows and 1 byte written (71,000 nodes of 2 limbs: 1.5 us); in
// practice, as for rank_rows, the chain of dependent probes of each walk.
// A node's four out-candidates (and its four in-candidates) share k - 1
// bases, so where one strand is canonical they fall in the same or
// neighbouring leaves, and the eight lanes of a group, on one SM, share
// those lines in L1. Three layouts were built and timed in
// tools/rank_sweep.py on an H100 80GB HBM3 (700 W; two runs, a third for
// the form kept; CUDA events, median), through the index of the
// 29,999,970-row k = 31 stress table, in ms: at a query batch (71,000
// nodes in random order, 6 in 7 present) 8 lanes a node 0.0898-0.0967, a
// thread a node walking 8 times 0.1007-0.1059, a warp a candidate over 32
// consecutive nodes (the warps' ballots meeting in shared memory) 0.0922;
// at the sweep step (the first 2^21 sorted nodes) 0.4472-0.4597,
// 0.4138-0.4160 and 0.4419. The thread a
// node wins the sweep, where neighbouring threads walk neighbouring sorted
// nodes' candidates; the 8 lanes win the query batch, the API's shape,
// where 71,000 threads cannot fill the card. So the 8 lanes stay, one form
// for both, and the sweep (0.03 s of a bank) pays 10%. Beside them, the
// chain it replaces took 2.86-4.20 ms (query) and 6.14-6.16 (sweep), and
// rank_rows alone on the same 8 N candidates, made beforehand,
// 0.0824-0.1056 and 0.4525-0.4706: the candidates cost nothing once they
// are built in registers, and at 71,000 nodes both are bound by the
// launch, not the walk.
//
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): neighbor_masks_kernel at W = 1 to 8
// uses 24 / 23 / 27 / 23 / 28 / 27 / 27 / 32 registers, no spill, no
// stack; blocks of 256 threads.

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

// The rank of the key among the first n_table rows of the table, or -1: the
// walk of the index from its root, then the leaf block.
template <int W>
__device__ __forceinline__ int walk_rank(const uint32_t* __restrict__ table,
                                         const uint32_t* __restrict__ index,
                                         const Levels& lv,
                                         const uint32_t (&key)[W],
                                         unsigned n_table) {
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
  return hit ? static_cast<int>(first + pos) : -1;
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
  const int r = walk_rank<W>(table, index, lv, key, n_table);
  rank[q] = r;
  found[q] = r >= 0 ? 1 : 0;
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


// ---- neighbor_masks: the 8 neighbour candidates of a node, their lookup and
// the node's mask, in registers (see the header note)

// The reverse complement of one limb's 16 bases (A C T G = 0 1 2 3, so the
// complement is x ^ 2): the bits reversed, each base's two bits swapped
// back, every base complemented.
__device__ __forceinline__ uint32_t revcomp_word(uint32_t x) {
  x = __brev(x);
  x = ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
  return x ^ 0xAAAAAAAAu;
}

// The k-mer's arithmetic at W = ceil(k / 16) limbs: the mask of limb 0's
// live bits, the slack above the k-mer (32 W - 2k, 0..30) and the place of
// the first base in limb 0 (2k - 2 - 32 (W - 1)).
struct KmerShape {
  uint32_t top;
  unsigned slack, first;
};

template <int W>
__device__ __forceinline__ KmerShape kmer_shape(int k) {
  const unsigned bits = (2u * k) % 32u;
  return {bits ? (1u << bits) - 1u : 0xFFFFFFFFu, 32u * W - 2u * k,
          2u * k - 2u - 32u * (W - 1)};
}

// revcomp_limbs_ of ops/kmer_ops.py: every limb reversed and complemented,
// the limbs in reverse order, then shifted down by the slack.
template <int W>
__device__ __forceinline__ void revcomp_row(const uint32_t (&f)[W],
                                            unsigned slack,
                                            uint32_t (&r)[W]) {
  uint32_t y[W];
#pragma unroll
  for (int j = 0; j < W; ++j) y[j] = revcomp_word(f[W - 1 - j]);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    r[j] = __funnelshift_r(y[j], j ? y[j - 1] : 0u, slack);
  }
}

// candidate j of a node of forward row f and reverse row r, as
// neighbor_candidates of ops/neighbor_ops.py builds it: j < 4 is out(nt),
// canonical((f << 2 | nt) & mask, r >> 2 | rc(nt) << 2(k-1)); j >= 4 is
// in(nt), canonical(f >> 2 | nt << 2(k-1), (r << 2 | rc(nt)) & mask);
// nt = j & 3 and rc(nt) = nt ^ 2. Both are a left shift of one row and a
// right shift of the other; the canonical one is the smaller, and a tie
// is the same row whichever side wins.
template <int W>
__device__ __forceinline__ void candidate(const uint32_t (&f)[W],
                                          const uint32_t (&r)[W], int j,
                                          const KmerShape& ks,
                                          uint32_t (&key)[W]) {
  const bool in = j >= 4;
  const uint32_t nt = j & 3;
  uint32_t left[W], right[W];
  // left = (P << 2 | c) & mask with P = f (out) or r (in)
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t hi = in ? r[i] : f[i];
    const uint32_t lo = i + 1 < W ? (in ? r[i + 1] : f[i + 1]) : 0u;
    left[i] = __funnelshift_l(lo, hi, 2);
  }
  left[W - 1] |= in ? nt ^ 2u : nt;
  left[0] &= ks.top;
  // right = Q >> 2 | c << 2(k-1) with Q = r (out) or f (in)
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t lo = in ? f[i] : r[i];
    const uint32_t hi = i ? (in ? f[i - 1] : r[i - 1]) : 0u;
    right[i] = __funnelshift_r(lo, hi, 2);
  }
  right[0] |= (in ? nt : nt ^ 2u) << ks.first;
  const bool lt = row_less<W>(left, right);
#pragma unroll
  for (int i = 0; i < W; ++i) key[i] = lt ? left[i] : right[i];
}

// Whether the key is one of the first n_table rows: the index's walk at the
// widths rank_rows_kernel takes, else rank_rows_any_kernel's binary search.
template <int W>
__device__ __forceinline__ bool has_row(const uint32_t* __restrict__ table,
                                        const uint32_t* __restrict__ index,
                                        const Levels& lv,
                                        const uint32_t (&key)[W],
                                        unsigned n_table) {
  if constexpr (W == 1 || W == 2 || W == 3 || W == 4 || W == 8) {
    return walk_rank<W>(table, index, lv, key, n_table) >= 0;
  } else {
    unsigned lo = 0, hi = n_table;
    uint32_t row[W];
    while (lo < hi) {
      const unsigned mid = (lo + hi) >> 1;
      load_words<W>(table + static_cast<long long>(mid) * W, row);
      if (row_less<W>(row, key)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo >= n_table) return false;
    load_words<W>(table + static_cast<long long>(lo) * W, row);
    bool ones = true;
#pragma unroll
    for (int j = 0; j < W; ++j) ones = ones & (key[j] == 0xFFFFFFFFu);
    return !ones & row_equal<W>(row, key);
  }
}

// Eight lanes a node, one a candidate: each lane builds its candidate from
// the node's row and looks it up; the group's found bits come together by
// a ballot and its first lane writes the mask.
template <int W>
__global__ void __launch_bounds__(kThreads)
neighbor_masks_kernel(const uint32_t* __restrict__ nodes,
                      const uint32_t* __restrict__ table,
                      const uint32_t* __restrict__ index,
                      const __grid_constant__ Levels lv,
                      uint8_t* __restrict__ masks, long long n_nodes,
                      unsigned n_table, int k) {
  const long long node =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 3;
  const int j = threadIdx.x & 7;
  bool hit = false;
  if (node < n_nodes) {
    const KmerShape ks = kmer_shape<W>(k);
    uint32_t f[W], r[W], key[W];
    load_words<W>(nodes + node * W, f);
    revcomp_row<W>(f, ks.slack, r);
    candidate<W>(f, r, j, ks, key);
    hit = has_row<W>(table, index, lv, key, n_table);
  }
  // every lane of the warp reaches the ballot (the grid is whole warps)
  const unsigned bits = __ballot_sync(0xFFFFFFFFu, hit);
  if (j == 0 && node < n_nodes) {
    masks[node] = static_cast<uint8_t>(bits >> (threadIdx.x & 24));
  }
}

template <int W>
int launch_masks(const uint32_t* nodes, const uint32_t* table,
                 const uint32_t* index, const Levels& lv, uint8_t* masks,
                 long long n_nodes, unsigned n_table, int k, cudaStream_t s) {
  const long long blocks = (n_nodes * 8 + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  neighbor_masks_kernel<W><<<grid, kThreads, 0, s>>>(
      nodes, table, index, lv, masks, n_nodes, n_table, k);
  return static_cast<int>(cudaGetLastError());
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

// nodes (n_nodes rows) and table (>= n_table rows) are row-major w-limb
// k-mers, 16-byte aligned, w = ceil(k / 16) <= 8; the index as rank_rows
// takes it (read at the widths it walks); masks is uint8[n_nodes]: bit j
// is candidate j, 0-3 out by nt, 4-7 in by nt. Returns the launch's
// cudaError_t (0 = launched; nothing is launched for n_nodes == 0).
int neighbor_masks(const void* nodes, const void* table, const void* index,
                   const long long* offsets, const long long* lengths,
                   int count, void* masks, long long n_nodes,
                   long long n_table, int w, int k, void* stream) {
  if (n_nodes <= 0) return 0;
  if (w < 1 || w > 8 || k < 1 || (2 * k + 31) / 32 != w || n_table < 0 ||
      n_table > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv{};
  if (w == 1 || w == 2 || w == 3 || w == 4 || w == 8) {
    if (count < 0 || count > kMaxLevels || (n_table > 0 && count == 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    lv.count = count;
    for (int l = 0; l <= count; ++l) lv.offset[l] = offsets[l];
    for (int l = 0; l < count; ++l) {
      lv.length[l] = static_cast<unsigned>(lengths[l]);
    }
  }
  const uint32_t* nd = static_cast<const uint32_t*>(nodes);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  const uint32_t* x = static_cast<const uint32_t*>(index);
  uint8_t* m = static_cast<uint8_t*>(masks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(n_table);
  switch (w) {
    case 1: return launch_masks<1>(nd, t, x, lv, m, n_nodes, n, k, s);
    case 2: return launch_masks<2>(nd, t, x, lv, m, n_nodes, n, k, s);
    case 3: return launch_masks<3>(nd, t, x, lv, m, n_nodes, n, k, s);
    case 4: return launch_masks<4>(nd, t, x, lv, m, n_nodes, n, k, s);
    case 5: return launch_masks<5>(nd, t, x, lv, m, n_nodes, n, k, s);
    case 6: return launch_masks<6>(nd, t, x, lv, m, n_nodes, n, k, s);
    case 7: return launch_masks<7>(nd, t, x, lv, m, n_nodes, n, k, s);
    default:
      return launch_masks<8>(nd, t, x, lv, m, n_nodes, n, k, s);
  }
}

}  // extern "C"

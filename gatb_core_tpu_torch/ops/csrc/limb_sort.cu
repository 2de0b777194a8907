// Sort and merge of uint32 limb planes, written for Hopper (sm_90a).
//
// Replaces the Pallas tiled bitonic kernels of gatb_core_tpu/ops/pallas_sort.py:
//   tile_sort       <- _tile_sort_kernel (pallas_sort.py:150-178, launched by
//                      _pallas_tile_sweep, :279-298)
//   merge_partition <- the cross-tile compare-exchange stages of
//                      _merge_sorted_runs (pallas_sort.py:204-276, jnp there)
//   merge_tiles     <- _tile_merge_kernel (pallas_sort.py:181-201), the part
//                      of a merge level that works inside one tile
//   bitonic_u64     <- _bitonic_kernel (pallas_sort.py:45-88, launched by
//                      bitonic_sort_u64, :343-364); see the note above its
//                      kernel below
//
// Data layout: P planes of n uint32 each, plane-major in one buffer
// (plane p at planes + p * n), the order of the JAX package's tuples of
// flat planes. Rows compare in big-endian lexicographic order over the
// planes (plane 0 most significant). The buffers are torch int32 storage;
// the kernels read them as uint32_t. n is a power of two.
//
// tile_sort and bitonic_u64 are NOT the TPU's bitonic network either. The
// network costs log2(T) * (log2(T) + 1) / 2 compare-exchange stages per
// tile, each a trip of every row through shared memory behind a barrier.
// Both kernels are one block merge sort, O(T log T) comparisons: a thread
// loads kItems consecutive rows into registers and sorts them with a fixed
// compare-exchange network (no shared memory, no barrier); then the sorted
// runs double log2(T / kItems) times inside the block: every thread puts
// its rows into shared memory, finds where its kItems output rows begin on
// the merge path of the pair of runs they belong to (ties take the first
// run first), and merges them serially back into registers. A round is one
// write and one read of each row in shared memory plus the search. Rows
// live in registers, so the number of planes is a template parameter; any
// other number of planes sorts 32-bit slots into a shared-memory copy of the
// tile through the same core. What bounds both on this card is bytes (each
// row read once and written once); what they take beyond that is the
// rounds' shared-memory traffic. A merge level below costs more than the
// round that a doubled tile adds, so the tile is the largest the registers
// allow (sort_max_threads), and the merge levels finish the sort.
//
// The merge level is NOT the TPU's network. The TPU merges two sorted runs
// with log2(2 * run) compare-exchange stages because it has no cheap
// data-dependent addressing; on this card each stage that crosses tiles
// would be a trip of the whole array through device memory. Here a level is
// a merge-path merge, bounded by bytes: 2 * 4 * P * n of them, each row read
// once and written once, whatever the run length.
//   merge_partition cuts the merged output of every pair of runs into tiles
//   of T rows: one thread per tile boundary binary-searches the boundary's
//   diagonal of the merge path (ties take the first run first) and writes
//   how many first-run rows precede it. Its work is the split array's
//   8 * (n / T + 1) bytes plus about log2(run) scattered row reads per
//   boundary: negligible beside the merge (n / T boundaries, T in the
//   thousands).
//   merge_tiles gives each output tile one block: the tile's two input
//   segments (together exactly T rows) are loaded into shared memory with
//   coalesced 16-byte loads, every thread finds its own diagonal there and
//   merges a few rows serially (plane 0 of both heads cached in registers,
//   further planes read only on a tie), recording the source slot of each
//   output row; the rows then leave shared memory in output order, as
//   coalesced 16-byte stores. It reads src and writes dst, so a level is one
//   trip through device memory. Nearly all of its time is that trip (the
//   searches and the serial merge hide behind it), so the tile is kept small
//   (32 KB of shared memory) and many blocks share an SM.
// cp.async/TMA staging is left for later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSmemBytes = 232448;  // 227 KB per block on sm_90

template <typename Index>
__device__ __forceinline__ bool row_lt(const uint32_t* base, Index stride,
                                       Index a, Index b, int P) {
  for (int p = 0; p < P; ++p) {
    const uint32_t x = base[p * stride + a];
    const uint32_t y = base[p * stride + b];
    if (x != y) return x < y;
  }
  return false;
}

// ---------------------------------------------------------------------------
// The block merge sort shared by tile_sort and bitonic_u64
// ---------------------------------------------------------------------------

#ifndef SORT_ITEMS
#define SORT_ITEMS 16
#endif
// rows a thread keeps in registers (a power of two, a multiple of 4)
constexpr int kItems = SORT_ITEMS;
static_assert(kItems >= 4 && (kItems & (kItems - 1)) == 0, "SORT_ITEMS");

// Threads a block may have when each of its rows takes `words` registers:
// the thread's rows, the two heads of the serial merge, two rows of
// temporaries and about 24 registers of indexes must fit the SM's 65,536
// registers. The launch bounds tell the compiler, and the tile is at most
// this many threads times kItems rows.
constexpr int sort_max_threads(int words) {
  int threads = 1024;
  while (threads * (words * (kItems + 4) + 24) > 65536) threads >>= 1;
  return threads;
}

// A row of P words in registers, P known at compile time. In shared memory
// the rows lie plane-major, row i of a plane at word i + i / 32: a thread
// puts kItems consecutive rows, and the extra word per 32 spreads the
// threads of a warp over all banks (without it they would meet in
// 32 / kItems banks). The serial merge's reads follow the data and are not
// systematic.
template <int P>
struct PlaneRow {
  uint32_t v[P];
};

template <int P>
struct PlaneOps {
  using Row = PlaneRow<P>;
  uint32_t* s;
  int stride;  // words of one plane
  static __host__ __device__ int plane_words(int rows) {
    return rows + (rows >> 5) + 1;
  }
  static __device__ __forceinline__ int at(int i) { return i + (i >> 5); }
  __device__ __forceinline__ bool lt(const Row& a, const Row& b) const {
    bool less = a.v[P - 1] < b.v[P - 1];
#pragma unroll
    for (int p = P - 2; p >= 0; --p)
      less = a.v[p] < b.v[p] || (a.v[p] == b.v[p] && less);
    return less;
  }
  __device__ __forceinline__ Row pick(bool first, const Row& a,
                                      const Row& b) const {
    Row r;
#pragma unroll
    for (int p = 0; p < P; ++p) r.v[p] = first ? a.v[p] : b.v[p];
    return r;
  }
  __device__ __forceinline__ void put(int i, const Row& r) const {
    const int k = at(i);
#pragma unroll
    for (int p = 0; p < P; ++p) s[p * stride + k] = r.v[p];
  }
  __device__ __forceinline__ Row get(int i) const {
    const int k = at(i);
    Row r;
#pragma unroll
    for (int p = 0; p < P; ++p) r.v[p] = s[p * stride + k];
    return r;
  }
  // row i < row j, both in shared memory; a further plane is read on a tie
  __device__ __forceinline__ bool lt_at(int i, int j) const {
    return row_lt<int>(s, stride, at(i), at(j), P);
  }
};

// A (hi, lo) pair joined into one 64-bit key: one compare per row. 8-byte
// words take two banks, so the extra word comes every 16 keys.
struct U64Ops {
  using Row = unsigned long long;
  Row* s;
  static __host__ __device__ int words(int rows) {
    return rows + (rows >> 4) + 1;
  }
  static __device__ __forceinline__ int at(int i) { return i + (i >> 4); }
  __device__ __forceinline__ bool lt(Row a, Row b) const { return a < b; }
  __device__ __forceinline__ Row pick(bool first, Row a, Row b) const {
    return first ? a : b;
  }
  __device__ __forceinline__ void put(int i, Row r) const { s[at(i)] = r; }
  __device__ __forceinline__ Row get(int i) const { return s[at(i)]; }
  __device__ __forceinline__ bool lt_at(int i, int j) const {
    return s[at(i)] < s[at(j)];
  }
};

// Any number of planes, known only at run time: the tile's rows stay where
// they were loaded in shared memory (`data`, plane stride `rows`), and what
// is sorted is each row's slot there, compared through the rows. Rows equal
// in every plane are identical, so the order of their slots shows nowhere.
struct SlotOps {
  using Row = uint32_t;
  const uint32_t* data;
  uint32_t* slots;
  int rows;
  int P;
  static __host__ __device__ int slot_words(int rows) {
    return rows + (rows >> 5) + 1;
  }
  static __device__ __forceinline__ int at(int i) { return i + (i >> 5); }
  __device__ __forceinline__ bool lt(Row a, Row b) const {
    return row_lt<int>(data, rows, static_cast<int>(a), static_cast<int>(b),
                       P);
  }
  __device__ __forceinline__ Row pick(bool first, Row a, Row b) const {
    return first ? a : b;
  }
  __device__ __forceinline__ void put(int i, Row r) const {
    slots[at(i)] = r;
  }
  __device__ __forceinline__ Row get(int i) const { return slots[at(i)]; }
  __device__ __forceinline__ bool lt_at(int i, int j) const {
    return lt(get(i), get(j));
  }
};

// The compare-exchanges of Batcher's odd-even merge sort of kItems rows, in
// order: comparator x exchanges rows lo and lo + gap, and belongs to the
// level that leaves runs of `level` rows sorted (so a tile below kItems rows
// stops early). Worked out at compile time: every register index below is a
// constant.
struct Comparator {
  int lo, gap, level;
};

__host__ __device__ constexpr Comparator sort_comparator(int x) {
  int seen = 0;
  for (int p = 1; p < kItems; p <<= 1)
    for (int k = p; k >= 1; k >>= 1)
      for (int j = k % p; j + k < kItems; j += 2 * k)
        for (int i = 0; i < k && i + j + k < kItems; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p))
            if (seen++ == x) return Comparator{i + j, k, 2 * p};
  return Comparator{0, 0, 0};  // past the last one
}

template <int X, class Ops>
__device__ __forceinline__ void sort_thread_rows(
    typename Ops::Row (&r)[kItems], const Ops& ops, int tile) {
  constexpr Comparator c = sort_comparator(X);
  if constexpr (c.gap > 0) {
    if (c.level <= tile) {
      const typename Ops::Row a = r[c.lo];
      const typename Ops::Row b = r[c.lo + c.gap];
      const bool swap = ops.lt(b, a);
      r[c.lo] = ops.pick(swap, b, a);
      r[c.lo + c.gap] = ops.pick(swap, a, b);
    }
    sort_thread_rows<X + 1>(r, ops, tile);
  }
}

// Sorts every aligned run of `tile` rows of the block's blockDim.x * kItems
// rows ascending; tile is a power of two that divides them. On entry r holds
// the thread's kItems consecutive rows (block rows threadIdx.x * kItems ..),
// on return the rows of the same positions of the sorted block. The shared
// memory behind `ops` needs no initial contents; one word past the block's
// last row is read and never used.
template <class Ops>
__device__ __forceinline__ void block_merge_sort(
    typename Ops::Row (&r)[kItems], const Ops& ops, int tile) {
  using Row = typename Ops::Row;
  sort_thread_rows<0>(r, ops, tile);
  const int d0 = threadIdx.x * kItems;
  for (int run = kItems; run < tile; run <<= 1) {
    __syncthreads();  // the round before has read what this one overwrites
#pragma unroll
    for (int e = 0; e < kItems; ++e) ops.put(d0 + e, r[e]);
    __syncthreads();
    // the thread's output rows d .. d + kItems of the pair of runs
    // [first, first + run) and [first + run, first + 2 * run): search the
    // diagonal d of their merge path as merge_path below does
    const int first = d0 & ~(2 * run - 1);
    const int d = d0 - first;
    int lo = d > run ? d - run : 0;
    int hi = d < run ? d : run;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (!ops.lt_at(first + run + (d - mid - 1), first + mid))
        lo = mid + 1;
      else
        hi = mid;
    }
    const int a_end = first + run;
    const int b_end = a_end + run;
    int ai = first + lo;
    int bi = a_end + (d - lo);
    Row ka = ops.get(ai);  // at a run's end these read the next row, unused
    Row kb = ops.get(bi);
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const bool take_a = bi >= b_end || (ai < a_end && !ops.lt(kb, ka));
      r[e] = ops.pick(take_a, ka, kb);
      const int next = take_a ? ++ai : ++bi;
      const Row x = ops.get(next);
      ka = ops.pick(take_a, x, ka);
      kb = ops.pick(take_a, kb, x);
    }
  }
}

// tile_sort for P planes known at compile time: each block sorts the tiles
// of its blockDim.x * kItems rows (one tile, or several of a tile below 32 *
// kItems rows), in place. kVec (n a multiple of kItems, planes 16-byte
// aligned): a thread's rows move as 16-byte words; tiles are aligned powers
// of two, so no misalignment has to be carried. Rows past n (a last block
// that n does not fill) are all-ones in registers and are not stored: they
// lie in tiles of their own.
template <int P, bool kVec>
__global__ void __launch_bounds__(sort_max_threads(P))
    tile_sort_kernel(uint32_t* planes, int64_t n, int tile) {
  extern __shared__ uint32_t s[];
  const int rows = blockDim.x * kItems;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * rows +
                       threadIdx.x * kItems;
  PlaneRow<P> r[kItems];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const uint32_t* g = planes + p * n + base;
    if (kVec) {
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        const uint4 w = base < n ? reinterpret_cast<const uint4*>(g)[q]
                                 : make_uint4(~0u, ~0u, ~0u, ~0u);
        r[4 * q].v[p] = w.x;
        r[4 * q + 1].v[p] = w.y;
        r[4 * q + 2].v[p] = w.z;
        r[4 * q + 3].v[p] = w.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kItems; ++e) r[e].v[p] = base + e < n ? g[e] : ~0u;
    }
  }
  const PlaneOps<P> ops{s, PlaneOps<P>::plane_words(rows)};
  block_merge_sort(r, ops, tile);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    uint32_t* g = planes + p * n + base;
    if (kVec) {
      if (base < n) {
#pragma unroll
        for (int q = 0; q < kItems / 4; ++q)
          reinterpret_cast<uint4*>(g)[q] =
              make_uint4(r[4 * q].v[p], r[4 * q + 1].v[p], r[4 * q + 2].v[p],
                         r[4 * q + 3].v[p]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kItems; ++e)
        if (base + e < n) g[e] = r[e].v[p];
    }
  }
}

// tile_sort for any other number of planes: the block's rows are copied to
// shared memory, their slots sorted by the same core, and the rows leave in
// the order of the sorted slots.
__global__ void __launch_bounds__(sort_max_threads(1))
    tile_sort_any_kernel(uint32_t* planes, int64_t n, int P, int tile) {
  extern __shared__ uint32_t s[];
  const int rows = blockDim.x * kItems;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * rows;
  uint32_t* slots = s + static_cast<size_t>(P) * rows;
  for (int p = 0; p < P; ++p)
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      s[p * rows + i] = base + i < n ? planes[p * n + base + i] : ~0u;
  if (threadIdx.x == 0) slots[SlotOps::at(rows)] = 0;  // read, never used
  __syncthreads();
  uint32_t r[kItems];
#pragma unroll
  for (int e = 0; e < kItems; ++e) r[e] = threadIdx.x * kItems + e;
  const SlotOps ops{s, slots, rows, P};
  block_merge_sort(r, ops, tile);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kItems; ++e) ops.put(threadIdx.x * kItems + e, r[e]);
  __syncthreads();
  for (int i = threadIdx.x; i < rows && base + i < n; i += blockDim.x) {
    const uint32_t from = ops.get(i);
    for (int p = 0; p < P; ++p) planes[p * n + base + i] = s[p * rows + from];
  }
}

// bitonic_u64: sorts every tile of n (hi, lo) uint32 pairs ascending as
// unsigned 64-bit values, from the two input planes into the (2, n) buffer
// `out` (plane 0 the high words).
//
// Replaces _bitonic_kernel (pallas_sort.py:45-88), which holds the whole
// array in the TPU's fast memory and runs the bitonic network by rolling it.
// Here the pairs are joined into 64-bit keys in registers and go through the
// block merge sort above; the merge levels that finish a sort of more than
// one tile are merge_partition and merge_tiles at two planes, launched by
// the caller. Bytes bound it: 8 read and 8 written per pair.
template <bool kVec>
__global__ void __launch_bounds__(sort_max_threads(2))
    bitonic_u64_kernel(const uint32_t* hi, const uint32_t* lo, uint32_t* out,
                       int64_t n, int tile) {
  extern __shared__ unsigned long long s64[];
  const int rows = blockDim.x * kItems;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * rows +
                       threadIdx.x * kItems;
  unsigned long long r[kItems];
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const uint4 none = make_uint4(~0u, ~0u, ~0u, ~0u);
      const uint4 h =
          base < n ? reinterpret_cast<const uint4*>(hi + base)[q] : none;
      const uint4 l =
          base < n ? reinterpret_cast<const uint4*>(lo + base)[q] : none;
      r[4 * q] = static_cast<unsigned long long>(h.x) << 32 | l.x;
      r[4 * q + 1] = static_cast<unsigned long long>(h.y) << 32 | l.y;
      r[4 * q + 2] = static_cast<unsigned long long>(h.z) << 32 | l.z;
      r[4 * q + 3] = static_cast<unsigned long long>(h.w) << 32 | l.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      r[e] = base + e < n ? static_cast<unsigned long long>(hi[base + e])
                                    << 32 | lo[base + e]
                          : ~0ull;
  }
  const U64Ops ops{s64};
  block_merge_sort(r, ops, tile);
  uint32_t* oh = out + base;
  uint32_t* ol = out + n + base;
  if (kVec) {
    if (base < n) {
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        reinterpret_cast<uint4*>(oh)[q] = make_uint4(
            static_cast<uint32_t>(r[4 * q] >> 32),
            static_cast<uint32_t>(r[4 * q + 1] >> 32),
            static_cast<uint32_t>(r[4 * q + 2] >> 32),
            static_cast<uint32_t>(r[4 * q + 3] >> 32));
        reinterpret_cast<uint4*>(ol)[q] = make_uint4(
            static_cast<uint32_t>(r[4 * q]),
            static_cast<uint32_t>(r[4 * q + 1]),
            static_cast<uint32_t>(r[4 * q + 2]),
            static_cast<uint32_t>(r[4 * q + 3]));
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      if (base + e < n) {
        oh[e] = static_cast<uint32_t>(r[e] >> 32);
        ol[e] = static_cast<uint32_t>(r[e]);
      }
  }
}

// Launches a block merge sort kernel over n rows in tiles of `tile` rows:
// tile / kItems threads per block (at least one warp, so a block of a
// smaller tile sorts several tiles), `smem_of(rows of a block)` bytes of
// shared memory. A tile that needs more threads than `max_threads` or more
// shared memory than a block may have is refused.
template <typename Kernel, typename SmemOf, typename... Args>
int launch_block_sort(Kernel kernel, int max_threads, SmemOf smem_of,
                      long long n, int tile, void* stream, Args... args) {
  if (tile < 2 || (tile & (tile - 1)) || n < 1 || n % tile != 0 ||
      tile / kItems > max_threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = tile / kItems < 32 ? 32 : tile / kItems;
  const long long rows = static_cast<long long>(threads) * kItems;
  const long long smem = smem_of(static_cast<int>(rows));
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>((n + rows - 1) / rows), threads,
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int P>
int launch_tile_sort(void* planes, long long n, int tile, void* stream) {
  auto smem_of = [](int rows) {
    return static_cast<long long>(PlaneOps<P>::plane_words(rows)) * 4 * P;
  };
  uint32_t* x = static_cast<uint32_t*>(planes);
  const int64_t n64 = n;
  if (n % kItems == 0 && aligned16(planes))
    return launch_block_sort(tile_sort_kernel<P, true>, sort_max_threads(P),
                             smem_of, n, tile, stream, x, n64, tile);
  return launch_block_sort(tile_sort_kernel<P, false>, sort_max_threads(P),
                           smem_of, n, tile, stream, x, n64, tile);
}

// Rows of the first run among the first d merged rows of a pair of sorted
// runs: a[0 .. na) and b[0 .. nb) are row indexes into `base` (plane stride
// `stride`), ties take a first. Binary search along the diagonal a + b = d
// of the merge path: a[mid] belongs to the first d rows iff fewer than
// d - mid rows of b are strictly smaller, i.e. iff b[d - mid - 1] is not
// smaller than a[mid].
template <typename Index>
__device__ __forceinline__ Index merge_path(const uint32_t* base,
                                            int64_t stride, Index a, Index na,
                                            Index b, Index nb, Index d,
                                            int P) {
  Index lo = d > nb ? d - nb : 0;
  Index hi = d < na ? d : na;
  while (lo < hi) {
    const Index mid = (lo + hi) >> 1;
    if (!row_lt<Index>(base, static_cast<Index>(stride), b + (d - mid - 1),
                       a + mid, P))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// split[t], t = 0 .. n / T: how many rows of first runs (counted over the
// whole array: pair * run + rows of this pair's first run) precede output
// row t * T when every pair of adjacent ascending runs of length `run` is
// merged. One thread per boundary.
__global__ void merge_partition_kernel(const uint32_t* planes, int64_t* split,
                                       int64_t n, int P, int64_t run,
                                       int64_t T) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t n_tiles = n / T;
  if (t > n_tiles) return;
  if (t == n_tiles) {
    split[t] = n / 2;
    return;
  }
  const int64_t g = t * T;
  const int64_t pair = g / (2 * run);
  const int64_t first = pair * 2 * run;
  split[t] = pair * run + merge_path<int64_t>(planes, n, first, run,
                                              first + run, run, g - first, P);
}

// One output tile of T rows per block (see the note at the top). Shared
// memory: P planes of T + kMergePad words, then T 16-bit source slots. The
// first-run segment of na rows sits in slots [oa, oa + na) of each plane,
// the second-run segment of T - na rows in [ob, ob + T - na).
//
// kVec (n a multiple of 4, src and dst 16-byte aligned, T a multiple of 4):
// the segments move as 16-byte words. A segment begins at any row, so oa and
// ob carry the segment's misalignment in device memory (row index mod 4)
// into shared memory: a 16-byte load then covers an aligned group of 4 rows
// on both sides. The groups at a segment's ends also bring up to 3 rows that
// are not the segment's (still rows of the plane, n being a multiple of 4);
// they land in the padding, and ob starts on a fresh group so that they
// never meet the other segment. The output tile is aligned, so every thread
// gathers 4 rows and stores them as one 16-byte word per plane.
constexpr int kMergePad = 16;

template <bool kVec>
__global__ void merge_tiles_kernel(const uint32_t* src, uint32_t* dst,
                                   const int64_t* split, int64_t n, int P,
                                   int64_t run, int T, int items) {
  extern __shared__ uint32_t s[];
  const int S = T + kMergePad;
  uint16_t* slot = reinterpret_cast<uint16_t*>(s + static_cast<size_t>(P) * S);
  const int64_t t = blockIdx.x;
  const int64_t g = t * T;
  const int64_t pair = g / (2 * run);
  const int64_t first = pair * 2 * run;
  const int64_t a0 = split[t] - pair * run;
  const int na = static_cast<int>(split[t + 1] - pair * run - a0);
  const int64_t ga = first + a0;                      // first row of a
  const int64_t gb = first + run + (g - first - a0);  // first row of b
  const int oa = kVec ? static_cast<int>(ga & 3) : 0;
  const int a_end = oa + na;
  const int ob = kVec ? ((a_end + 3) & ~3) + static_cast<int>(gb & 3) : a_end;
  const int b_end = ob + (T - na);
  if (kVec) {
    const int groups_a = (a_end + 3) >> 2;
    const int groups = groups_a + ((b_end - (ob & ~3) + 3) >> 2);
    const int64_t ga4 = ga - oa;
    const int64_t gb4 = gb - (gb & 3) - 4 * static_cast<int64_t>(groups_a);
    for (int p = 0; p < P; ++p) {
      const uint32_t* plane = src + p * n;
      uint32_t* sp = s + p * S;
      for (int k = threadIdx.x; k < groups; k += blockDim.x)
        *reinterpret_cast<uint4*>(sp + 4 * k) = *reinterpret_cast<const uint4*>(
            plane + (k < groups_a ? ga4 : gb4) + 4 * k);
    }
  } else {
    for (int p = 0; p < P; ++p) {
      const uint32_t* plane = src + p * n;
      for (int i = threadIdx.x; i < T; i += blockDim.x)
        s[p * S + i] = plane[i < na ? ga + i : gb + (i - na)];
    }
  }
  __syncthreads();
  const int d = threadIdx.x * items;
  if (d < T) {
    const int cnt = d + items <= T ? items : T - d;
    int ai = oa + merge_path<int>(s, S, oa, na, ob, T - na, d, P);
    int bi = ob + (d - (ai - oa));
    uint32_t ka = ai < a_end ? s[ai] : 0u;
    uint32_t kb = bi < b_end ? s[bi] : 0u;
    for (int e = 0; e < cnt; ++e) {
      bool take_a;
      if (ai >= a_end)
        take_a = false;
      else if (bi >= b_end)
        take_a = true;
      else if (ka != kb)
        take_a = ka < kb;
      else
        take_a = !row_lt<int>(s + S, S, bi, ai, P - 1);
      if (take_a) {
        slot[d + e] = static_cast<uint16_t>(ai);
        if (++ai < a_end) ka = s[ai];
      } else {
        slot[d + e] = static_cast<uint16_t>(bi);
        if (++bi < b_end) kb = s[bi];
      }
    }
  }
  __syncthreads();
  if (kVec) {
    for (int q = threadIdx.x; q < T / 4; q += blockDim.x) {
      const ushort4 from = reinterpret_cast<const ushort4*>(slot)[q];
      for (int p = 0; p < P; ++p) {
        const uint32_t* sp = s + p * S;
        *reinterpret_cast<uint4*>(dst + p * n + g + 4 * q) =
            make_uint4(sp[from.x], sp[from.y], sp[from.z], sp[from.w]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < T; i += blockDim.x) {
      const int from = slot[i];
      for (int p = 0; p < P; ++p) dst[p * n + g + i] = s[p * S + from];
    }
  }
}

}  // namespace

extern "C" {

// Rows a thread of the sort kernels keeps in registers (the wrapper's
// tile limits are computed from it).
int limb_sort_items() { return kItems; }

// Full ascending sort of every tile of `tile` rows, in place. The planes'
// number picks the kernel: register rows for 1, 2, 3, 4, 5 and 9 planes,
// sorted slots for any other number.
int limb_tile_sort(void* planes, long long n, int P, int tile,
                   void* stream) {
  switch (P) {
    case 1: return launch_tile_sort<1>(planes, n, tile, stream);
    case 2: return launch_tile_sort<2>(planes, n, tile, stream);
    case 3: return launch_tile_sort<3>(planes, n, tile, stream);
    case 4: return launch_tile_sort<4>(planes, n, tile, stream);
    case 5: return launch_tile_sort<5>(planes, n, tile, stream);
    case 9: return launch_tile_sort<9>(planes, n, tile, stream);
    default: break;
  }
  if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto smem_of = [P](int rows) {
    return (static_cast<long long>(rows) * P + SlotOps::slot_words(rows)) * 4;
  };
  return launch_block_sort(tile_sort_any_kernel, sort_max_threads(1), smem_of,
                           n, tile, stream, static_cast<uint32_t*>(planes),
                           static_cast<int64_t>(n), P, tile);
}

// The merge-path split array of one merge level (n / T + 1 entries).
int limb_merge_partition(const void* planes, void* split, long long n, int P,
                         long long run, long long T, void* stream) {
  if (run < 1 || 2 * run > n || n % (2 * run) != 0 || T < 1 ||
      (2 * run) % T != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const long long bounds = n / T + 1;
  merge_partition_kernel<<<static_cast<unsigned>((bounds + threads - 1) /
                                                 threads),
                           threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), static_cast<int64_t*>(split), n, P,
      run, T);
  return static_cast<int>(cudaGetLastError());
}

// One merge level, src -> dst, tile by tile along `split`; every thread
// merges `items` rows.
int limb_merge_tiles(const void* src, void* dst, const void* split,
                     long long n, int P, long long run, int T, int items,
                     void* stream) {
  const long long smem = static_cast<long long>(T + kMergePad) * 4 * P + 2 * T;
  if (run < 1 || 2 * run > n || n % (2 * run) != 0 || T < 1 || T > 32768 ||
      (2 * run) % T != 0 || items < 1 || src == dst || smem > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = (T + items - 1) / items;
  threads = (threads + 31) / 32 * 32;
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = T % 4 == 0 && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  auto kernel = vec ? merge_tiles_kernel<true> : merge_tiles_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n / T), threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
      static_cast<const int64_t*>(split), n, P, run, T, items);
  return static_cast<int>(cudaGetLastError());
}

// Ascending sort of every tile of `tile` (hi, lo) pairs as unsigned 64-bit
// values, from the planes hi and lo into the (2, n) buffer out.
int limb_bitonic_u64(const void* hi, const void* lo, void* out, long long n,
                     int tile, void* stream) {
  auto smem_of = [](int rows) {
    return static_cast<long long>(U64Ops::words(rows)) * 8;
  };
  const uint32_t* h = static_cast<const uint32_t*>(hi);
  const uint32_t* l = static_cast<const uint32_t*>(lo);
  uint32_t* o = static_cast<uint32_t*>(out);
  const int64_t n64 = n;
  if (n % kItems == 0 && aligned16(hi) && aligned16(lo) && aligned16(out))
    return launch_block_sort(bitonic_u64_kernel<true>, sort_max_threads(2),
                             smem_of, n, tile, stream, h, l, o, n64, tile);
  return launch_block_sort(bitonic_u64_kernel<false>, sort_max_threads(2),
                           smem_of, n, tile, stream, h, l, o, n64, tile);
}

}  // extern "C"

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
// tile_sort is the bitonic network of the TPU kernel: every stage reads and
// writes each row it exchanges, so it runs all log2(tile) * (log2(tile) + 1)
// / 2 stages of a tile in shared memory (one block per tile, the tile sized
// to fill up to 227 KB) and touches device memory once.
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
// cp.async/TMA staging and a register-resident serial merge are left for
// later.

#include <cooperative_groups.h>
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

__device__ __forceinline__ void row_swap(uint32_t* base, int64_t stride,
                                         int64_t a, int64_t b, int P) {
  for (int p = 0; p < P; ++p) {
    const uint32_t t = base[p * stride + a];
    base[p * stride + a] = base[p * stride + b];
    base[p * stride + b] = t;
  }
}

// One compare-exchange stage of partner distance j over a shared-memory
// tile: the pair whose low index has bit big_k set sorts descending, every
// other pair ascending (the bitonic sort network, direction from i & K as in
// pallas_sort._stage_exchange).
__device__ __forceinline__ void smem_stage(uint32_t* s, int tile, int P,
                                           int j, int big_k) {
  for (int t = threadIdx.x; t < tile / 2; t += blockDim.x) {
    const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
    const int hi = lo + j;
    const bool asc = (lo & big_k) == 0;
    const bool sw = asc ? row_lt<int64_t>(s, tile, hi, lo, P)
                        : row_lt<int64_t>(s, tile, lo, hi, P);
    if (sw) row_swap(s, tile, lo, hi, P);
  }
  __syncthreads();
}

__device__ __forceinline__ void load_tile(uint32_t* s, const uint32_t* g,
                                          int64_t n, int64_t base, int tile,
                                          int P) {
  for (int p = 0; p < P; ++p)
    for (int i = threadIdx.x; i < tile; i += blockDim.x)
      s[p * tile + i] = g[p * n + base + i];
  __syncthreads();
}

__device__ __forceinline__ void store_tile(const uint32_t* s, uint32_t* g,
                                           int64_t n, int64_t base, int tile,
                                           int P) {
  for (int p = 0; p < P; ++p)
    for (int i = threadIdx.x; i < tile; i += blockDim.x)
      g[p * n + base + i] = s[p * tile + i];
}

__global__ void tile_sort_kernel(uint32_t* planes, int64_t n, int P,
                                 int tile) {
  extern __shared__ uint32_t s[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  load_tile(s, planes, n, base, tile, P);
  for (int big_k = 2; big_k <= tile; big_k <<= 1)
    for (int j = big_k >> 1; j > 0; j >>= 1) smem_stage(s, tile, P, j, big_k);
  store_tile(s, planes, n, base, tile, P);
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

// bitonic_u64: the whole bitonic sort network over n (hi, lo) uint32 pairs
// read as unsigned 64-bit values, ascending, in ONE launch.
//
// Replaces _bitonic_kernel (pallas_sort.py:45-88), which holds the whole
// array in the TPU's fast memory and exchanges by rolling it. Here each
// thread owns pairs i and i ^ j of a stage and compare-exchanges them. The
// two planes are joined into one 64-bit key per pair in shared memory.
//
// What bounds it on an H100: bytes, 8 read and 8 written per pair, when
// n <= 2^14 (128 KB of keys fit one block's 227 KB of shared memory; 2^15
// do not): one block then runs every stage in shared memory. For larger n
// the same launch is cooperative: every block sorts 2^14-pair tiles in
// shared memory, and each further level K runs its stages j >= tile on
// device memory (a grid barrier between stages, 16 B moved per pair and
// stage) and its stages below the tile in shared memory again. A cluster
// with distributed shared memory would keep more levels out of device
// memory; that is left for later.
constexpr int kU64TileLog2 = 14;

__device__ __forceinline__ void u64_smem_stage(unsigned long long* s,
                                               int tile, int j, int64_t big_k,
                                               int64_t base) {
  for (int t = threadIdx.x; t < tile / 2; t += blockDim.x) {
    const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
    const int hi = lo + j;
    const bool asc = ((base + lo) & big_k) == 0;
    const unsigned long long a = s[lo];
    const unsigned long long b = s[hi];
    if (asc ? b < a : a < b) {
      s[lo] = b;
      s[hi] = a;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void u64_load_tile(unsigned long long* s,
                                              const uint32_t* hi,
                                              const uint32_t* lo,
                                              int64_t base, int tile) {
  for (int i = threadIdx.x; i < tile; i += blockDim.x)
    s[i] = (static_cast<unsigned long long>(hi[base + i]) << 32) |
           lo[base + i];
  __syncthreads();
}

__device__ __forceinline__ void u64_store_tile(const unsigned long long* s,
                                               uint32_t* hi, uint32_t* lo,
                                               int64_t base, int tile) {
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    hi[base + i] = static_cast<uint32_t>(s[i] >> 32);
    lo[base + i] = static_cast<uint32_t>(s[i]);
  }
  __syncthreads();  // the next tile's load overwrites s
}

__global__ void bitonic_u64_kernel(uint32_t* hi, uint32_t* lo, int64_t n,
                                   int tile) {
  extern __shared__ unsigned long long s64[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int64_t n_tiles = n / tile;
  // levels K = 2 .. tile: each tile alone, direction from the global index
  for (int64_t tl = blockIdx.x; tl < n_tiles; tl += gridDim.x) {
    const int64_t base = tl * tile;
    u64_load_tile(s64, hi, lo, base, tile);
    for (int big_k = 2; big_k <= tile; big_k <<= 1)
      for (int j = big_k >> 1; j > 0; j >>= 1)
        u64_smem_stage(s64, tile, j, big_k, base);
    u64_store_tile(s64, hi, lo, base, tile);
  }
  const int64_t n_threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int64_t big_k = 2 * static_cast<int64_t>(tile); big_k <= n;
       big_k <<= 1) {
    // stages that cross tiles: device memory, all blocks, a barrier each
    for (int64_t j = big_k >> 1; j >= tile; j >>= 1) {
      grid.sync();
      for (int64_t t = tid; t < n / 2; t += n_threads) {
        const int64_t a_i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int64_t b_i = a_i + j;
        const bool asc = (a_i & big_k) == 0;
        const uint32_t ah = hi[a_i], al = lo[a_i];
        const uint32_t bh = hi[b_i], bl = lo[b_i];
        const bool a_lt_b = ah < bh || (ah == bh && al < bl);
        const bool b_lt_a = bh < ah || (ah == bh && bl < al);
        if (asc ? b_lt_a : a_lt_b) {
          hi[a_i] = bh;
          lo[a_i] = bl;
          hi[b_i] = ah;
          lo[b_i] = al;
        }
      }
    }
    grid.sync();
    // stages j = tile/2 .. 1 of this level, inside each tile
    for (int64_t tl = blockIdx.x; tl < n_tiles; tl += gridDim.x) {
      const int64_t base = tl * tile;
      u64_load_tile(s64, hi, lo, base, tile);
      for (int j = tile >> 1; j > 0; j >>= 1)
        u64_smem_stage(s64, tile, j, big_k, base);
      u64_store_tile(s64, hi, lo, base, tile);
    }
  }
}

int tile_threads(int tile) {
  const int half = tile / 2;
  return half < 1024 ? (half < 32 ? 32 : half) : 1024;
}

template <typename Kernel>
int launch_tile(Kernel kernel, void* planes, long long n, int P, int tile,
                void* stream) {
  const long long smem = static_cast<long long>(tile) * P * 4;
  if (tile < 2 || n % tile != 0 || smem > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n / tile), tile_threads(tile),
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(planes), n, P, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Full ascending sort of every tile of `tile` rows, in place.
int limb_tile_sort(void* planes, long long n, int P, int tile,
                   void* stream) {
  return launch_tile(tile_sort_kernel, planes, n, P, tile, stream);
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

// Full ascending sort of n (hi, lo) pairs as unsigned 64-bit values, in
// place. One cooperative launch; the grid is the number of tiles, capped at
// the number of blocks the card holds at once.
int limb_bitonic_u64(void* hi, void* lo, long long n, void* stream) {
  if (n < 2 || (n & (n - 1))) return static_cast<int>(cudaErrorInvalidValue);
  int tile = n < (1LL << kU64TileLog2) ? static_cast<int>(n)
                                       : (1 << kU64TileLog2);
  const size_t smem = static_cast<size_t>(tile) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_u64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = tile_threads(tile);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, bitonic_u64_kernel, threads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  long long blocks = n / tile;
  if (blocks > static_cast<long long>(per_sm) * sms)
    blocks = static_cast<long long>(per_sm) * sms;
  uint32_t* hi_p = static_cast<uint32_t*>(hi);
  uint32_t* lo_p = static_cast<uint32_t*>(lo);
  int64_t n64 = n;
  void* args[] = {&hi_p, &lo_p, &n64, &tile};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(bitonic_u64_kernel),
      dim3(static_cast<unsigned>(blocks)), dim3(threads), args, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Bitonic sort and merge of uint32 limb planes, written for Hopper (sm_90a).
//
// Replaces the Pallas tiled bitonic kernels of gatb_core_tpu/ops/pallas_sort.py:
//   tile_sort   <- _tile_sort_kernel (pallas_sort.py:150-178, launched by
//                  _pallas_tile_sweep, :279-298)
//   tile_merge  <- _tile_merge_kernel (pallas_sort.py:181-201)
//   merge_stage <- the cross-tile compare-exchange stages of
//                  _merge_sorted_runs (pallas_sort.py:204-276, jnp there)
//   bitonic_u64 <- _bitonic_kernel (pallas_sort.py:45-88, launched by
//                  bitonic_sort_u64, :343-364); see the note above its
//                  kernel below
//
// Data layout: P planes of n uint32 each, plane-major in one buffer
// (plane p at planes + p * n), the order of the JAX package's tuples of
// flat planes. Rows compare in big-endian lexicographic order over the
// planes (plane 0 most significant). The buffers are torch int32 storage;
// the kernels read them as uint32_t. n is a power of two.
//
// What bounds them on an H100: every network stage reads and writes each
// row it exchanges, so a stage in device memory moves 2 * P * 4 * n bytes.
// A sort of n rows has log2(n) * (log2(n) + 1) / 2 stages. tile_sort and
// tile_merge run all stages below the tile size in shared memory (one
// block per tile, the tile sized to fill up to 227 KB), so a level of the
// merge touches device memory once per cross-tile stage (merge_stage, one
// launch per stage) plus one tile_merge sweep, instead of once per stage.
// Compare loops stop at the first differing plane, and a row is written
// only when it moves. Registers, cp.async/TMA and wider per-thread work
// are left for later.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSmemBytes = 232448;  // 227 KB per block on sm_90

__device__ __forceinline__ bool row_lt(const uint32_t* base, int64_t stride,
                                       int64_t a, int64_t b, int P) {
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
// tile. big_k == 0: every pair ascending (merge); otherwise the pair whose
// low index has bit big_k set sorts descending (the bitonic sort network,
// direction from i & K as in pallas_sort._stage_exchange).
__device__ __forceinline__ void smem_stage(uint32_t* s, int tile, int P,
                                           int j, int big_k) {
  for (int t = threadIdx.x; t < tile / 2; t += blockDim.x) {
    const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
    const int hi = lo + j;
    const bool asc = (lo & big_k) == 0;
    const bool sw = asc ? row_lt(s, tile, hi, lo, P)
                        : row_lt(s, tile, lo, hi, P);
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

__global__ void tile_merge_kernel(uint32_t* planes, int64_t n, int P,
                                  int tile) {
  extern __shared__ uint32_t s[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  load_tile(s, planes, n, base, tile, P);
  for (int j = tile >> 1; j > 0; j >>= 1) smem_stage(s, tile, P, j, 0);
  store_tile(s, planes, n, base, tile, P);
}

// One stage of a bitonic merge level in device memory, one thread per
// pair. Adjacent ascending runs of length `run` merge into runs of
// 2 * run. The first stage (j == run) compares i with its mirror
// 2 * run - 1 - i in the pair of runs (the "flip" comparator), which the
// JAX package gets by reversing the second run; later stages compare i
// with i + j, all ascending.
__global__ void merge_stage_kernel(uint32_t* planes, int64_t n, int P,
                                   int64_t run, int64_t j) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= n / 2) return;
  int64_t lo, hi;
  if (j == run) {
    const int64_t r = t & (run - 1);
    const int64_t start = (t - r) << 1;
    lo = start + r;
    hi = start + 2 * run - 1 - r;
  } else {
    lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
    hi = lo + j;
  }
  if (row_lt(planes, n, hi, lo, P)) row_swap(planes, n, lo, hi, P);
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

// Stages j = tile/2 .. 1 of a merge level inside every tile, in place.
int limb_tile_merge(void* planes, long long n, int P, int tile,
                    void* stream) {
  return launch_tile(tile_merge_kernel, planes, n, P, tile, stream);
}

// Stage j of the merge level of runs of length `run`, in place.
int limb_merge_stage(void* planes, long long n, int P, long long run,
                     long long j, void* stream) {
  if (run < 1 || j < 1 || j > run || 2 * run > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long pairs = n / 2;
  merge_stage_kernel<<<static_cast<unsigned>((pairs + threads - 1) / threads),
                       threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(planes), n, P, run, j);
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

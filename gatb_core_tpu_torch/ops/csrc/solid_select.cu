// Abundance histogram and solid-row select of a pass's distinct table,
// written for Hopper (sm_90a).
//
// solid_select has no Pallas original. It replaces the host end of the
// count: the default processor vector of SortingCount (kmer/counting.py),
// CountProcessorHistogram -> CountProcessorSolidity -> CountProcessorCollect
// of kmer/count_processor.py, whose numpy sweep (Histogram.add_counts of
// kmer/histogram.py, solidity_check, the chain's boolean gathers) ran over
// every distinct row of every pass after the whole table was copied to the
// host. Only the solid rows (8-21% of the distinct rows in a read bank)
// and the histogram's bins are needed after it.
//
// Contract (ops/solid_select.py solid_select_plain, solid_histogram_plain):
// W planes of uint32 rows, plane p at planes + p * stride, rows 0..n-1 live
// and sorted; counts, n int32. The histogram adds, for each live row,
// 1 to bins[min(max(c, 0), histo_max)] (uint64 bins, added into, so passes
// accumulate). The select writes the rows with lo <= c <= hi, in table
// order, row-major as (n_solid, W) uint32, and their counts as int32.
//
// What bounds it: bytes, 4 W + 4 read per live row and 4 W + 4 written per
// solid row (the planes are read whole: a 32-byte sector of a plane holds
// 8 rows, and most sectors hold a solid row). It is three launches, for
// a row's output position is a prefix count over the whole table:
//   1. select_partials_kernel: one persistent wave of blocks (as many as
//      fit on the card) walks 8192-row tiles, 16 consecutive rows a thread
//      read as four 16-byte loads. Each block keeps a histogram of its
//      rows in shared memory (the first 12,000 bins; a clamped count past
//      them goes straight to the global bins) and adds its non-zero bins
//      to the global uint64 bins once, at its end. The skew: 79-92% of the
//      distinct rows of a read bank are sequencing errors seen once, and
//      every lane of a warp adding to bin 1 would serialise on one shared
//      address. So each thread counts its count-1 rows in a register,
//      summed over the warp and added once at the block's end; the other
//      counts, spread around the coverage, take plain shared atomics.
//      (Grouping a warp's equal values with __match_any_sync instead, the
//      leader adding the group's size, took 0.25 ms against 0.17-0.19 ms
//      for this launch over 109.5M rows on an H100.) The bins are
//      integers, so the order of the atomics cannot change them. With the
//      select, each tile's solid rows are counted.
//   2. select_scan_kernel: one block scans the tiles' counts (13,400 at
//      109.5M rows) into each tile's first output row, and n_solid.
//   3. select_scatter_kernel: a block per tile, a warp per 512 consecutive
//      rows of it, 32 rows a step: lane l reads row l of the step, a
//      ballot's prefix gives each solid row its output row, so the solid
//      rows of a step go to consecutive output rows. Reads and writes
//      coalesce; a row is written as one 8- or 16-byte store at W 2 and 4.
// The wrapper reads n_solid between launches 2 and 3 to allocate the
// output at exactly n_solid rows. The counts are read twice (launches 1
// and 3); the bound counts them once.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 16;  // consecutive rows a thread: four int4 loads
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
// 48,000 bytes of shared bins: under the 48 KB a block takes without opt-in
constexpr int kSharedBins = 12000;
constexpr uint32_t kFull = 0xFFFFFFFFu;

// Block-wide exclusive sum of x over the threads in order; *total is the
// block's sum. smem holds THREADS / 32 words.
template <int THREADS>
__device__ uint32_t block_excl_sum(uint32_t x, uint32_t* smem,
                                   uint32_t* total) {
  constexpr int warps = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = lane < warps ? smem[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += y;
    }
    if (lane < warps) smem[lane] = v;
  }
  __syncthreads();
  const uint32_t before = warp ? smem[warp - 1] : 0u;
  *total = smem[warps - 1];
  __syncthreads();  // smem is reused by the next scan
  return before + inc - x;
}

// The counts of a thread's kItems rows from i0 (16-row aligned); bit q of
// the result is set when row i0 + q is live.
__device__ __forceinline__ uint32_t load_counts(
    const int32_t* __restrict__ counts, long long n, long long i0,
    int32_t (&c)[kItems]) {
  if (i0 + kItems <= n) {
    const int4* p = reinterpret_cast<const int4*>(counts + i0);
#pragma unroll
    for (int v = 0; v < kItems / 4; ++v) {
      const int4 x = p[v];
      c[4 * v] = x.x;
      c[4 * v + 1] = x.y;
      c[4 * v + 2] = x.z;
      c[4 * v + 3] = x.w;
    }
    return (1u << kItems) - 1u;
  }
  uint32_t live = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const bool ok = i0 + q < n;
    c[q] = ok ? counts[i0 + q] : 0;
    live |= static_cast<uint32_t>(ok) << q;
  }
  return live;
}

__device__ __forceinline__ uint32_t solid_flags(const int32_t (&c)[kItems],
                                                uint32_t live, int lo,
                                                int hi) {
  uint32_t f = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q)
    f |= static_cast<uint32_t>(c[q] >= lo && c[q] <= hi) << q;
  return f & live;
}

// bins: null for no histogram; tile_solid: null for no select, else one
// word a tile (its solid rows).
__global__ void __launch_bounds__(kThreads) select_partials_kernel(
    const int32_t* __restrict__ counts, long long n, long long ntiles,
    int lo, int hi, int histo_max, int nsh,
    unsigned long long* __restrict__ bins, uint32_t* __restrict__ tile_solid) {
  extern __shared__ uint32_t sh_bins[];
  __shared__ uint32_t smem[kWarps];
  const int lane = threadIdx.x & 31;
  uint32_t ones = 0;  // this thread's rows of count 1
  if (bins != nullptr) {
    for (int i = threadIdx.x; i < nsh; i += kThreads) sh_bins[i] = 0u;
    __syncthreads();
  }
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long i0 =
        t * kTile + static_cast<long long>(threadIdx.x) * kItems;
    int32_t c[kItems];
    const uint32_t live = load_counts(counts, n, i0, c);
    if (bins != nullptr) {
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        const bool ok = live >> q & 1u;
        const uint32_t v =
            static_cast<uint32_t>(min(max(c[q], 0), histo_max));
        if (!ok) continue;
        if (v == 1u)
          ++ones;
        else if (v < static_cast<uint32_t>(nsh))
          atomicAdd(&sh_bins[v], 1u);
        else
          atomicAdd(&bins[v], 1ull);
      }
    }
    if (tile_solid != nullptr) {
      uint32_t total;
      block_excl_sum<kThreads>(__popc(solid_flags(c, live, lo, hi)), smem,
                               &total);
      if (threadIdx.x == 0) tile_solid[t] = total;
    }
  }
  if (bins != nullptr) {
    // histo_max >= 1 wherever a count clamps to 1, so bin 1 is shared
    ones = __reduce_add_sync(kFull, ones);
    if (lane == 0 && ones != 0u) atomicAdd(&sh_bins[1], ones);
    __syncthreads();
    for (int i = threadIdx.x; i < nsh; i += kThreads)
      if (sh_bins[i] != 0u)
        atomicAdd(&bins[i], static_cast<unsigned long long>(sh_bins[i]));
  }
}

// tile_solid in place: each tile's solid rows -> the solid rows before it.
__global__ void __launch_bounds__(kScanThreads) select_scan_kernel(
    uint32_t* __restrict__ tile_solid, long long ntiles,
    int32_t* __restrict__ n_solid) {
  __shared__ uint32_t smem[kScanThreads / 32];
  const long long per = (ntiles + kScanThreads - 1) / kScanThreads;
  const long long b0 = min(ntiles, threadIdx.x * per);
  const long long b1 = min(ntiles, b0 + per);
  uint32_t s = 0;
  for (long long b = b0; b < b1; ++b) s += tile_solid[b];
  uint32_t total;
  uint32_t run = block_excl_sum<kScanThreads>(s, smem, &total);
  for (long long b = b0; b < b1; ++b) {
    const uint32_t e = tile_solid[b];
    tile_solid[b] = run;
    run += e;
  }
  if (threadIdx.x == 0) *n_solid = static_cast<int32_t>(total);
}

// One solid row to output row o: W words, as one 8- or 16-byte store
// where W is 2 or 4 (WT; 0 for any W).
template <int WT>
__device__ __forceinline__ void put_row(const uint32_t* __restrict__ planes,
                                        int W, long long stride, long long i,
                                        uint32_t* __restrict__ out,
                                        long long o) {
  if constexpr (WT == 2) {
    reinterpret_cast<uint2*>(out)[o] =
        make_uint2(planes[i], planes[stride + i]);
  } else if constexpr (WT == 4) {
    reinterpret_cast<uint4*>(out)[o] =
        make_uint4(planes[i], planes[stride + i], planes[2 * stride + i],
                   planes[3 * stride + i]);
  } else {
    for (int p = 0; p < W; ++p) out[o * W + p] = planes[p * stride + i];
  }
}

template <int WT>
__global__ void __launch_bounds__(kThreads) select_scatter_kernel(
    const uint32_t* __restrict__ planes, int W, long long stride,
    const int32_t* __restrict__ counts, long long n, int lo, int hi,
    const uint32_t* __restrict__ tile_first, uint32_t* __restrict__ out_rows,
    int32_t* __restrict__ out_counts) {
  constexpr int kSteps = kTile / kThreads;  // steps of 32 rows a warp
  __shared__ uint32_t warp_solid[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = blockIdx.x;
  const long long seg = t * kTile + static_cast<long long>(warp) * kSteps * 32;
  int32_t c[kSteps];
  uint32_t mine = 0;  // bit s: row seg + 32 s + lane is solid
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long long i = seg + s * 32 + lane;
    c[s] = i < n ? counts[i] : 0;
    mine |= static_cast<uint32_t>(i < n && c[s] >= lo && c[s] <= hi) << s;
  }
  const uint32_t in_warp = __reduce_add_sync(kFull, __popc(mine));
  if (lane == 0) warp_solid[warp] = in_warp;
  __syncthreads();
  long long pos = tile_first[t];
  for (int v = 0; v < warp; ++v) pos += warp_solid[v];
  const uint32_t below = (1u << lane) - 1u;  // the lanes before this one
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const uint32_t b = __ballot_sync(kFull, mine >> s & 1u);
    if (mine >> s & 1u) {
      const long long o = pos + __popc(b & below);
      put_row<WT>(planes, W, stride, seg + s * 32 + lane, out_rows, o);
      out_counts[o] = c[s];
    }
    pos += __popc(b);
  }
}

}  // namespace

extern "C" {

// Rows of one tile (the wrapper sizes the tile words from it).
int solid_select_tile() { return kTile; }

// Launch 1 over n > 0 rows of counts (16-byte aligned), with the histogram
// when bins (histo_max + 1 uint64) is not null; with tile_solid (one
// uint32 a tile) not null, the tiles' solid rows and then launch 2, which
// writes n_solid (one int32). Returns the first failed launch's
// cudaError_t (0 = launched).
int solid_select_count(const void* counts, long long n, int lo, int hi,
                       int histo_max, void* bins, void* tile_solid,
                       long long tile_words, void* n_solid, void* stream) {
  const long long ntiles = (n + kTile - 1) / kTile;
  if (n < 1 || n > 0x7FFFFFFFLL || histo_max < 0 ||
      (bins == nullptr && tile_solid == nullptr) ||
      (tile_solid != nullptr && (tile_words < ntiles || n_solid == nullptr)) ||
      reinterpret_cast<uintptr_t>(counts) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nsh =
      bins == nullptr ? 0 : std::min(histo_max + 1, kSharedBins);
  const size_t shared = static_cast<size_t>(nsh) * sizeof(uint32_t);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, select_partials_kernel, kThreads, shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long wave = static_cast<long long>(sms) * std::max(per_sm, 1);
  const unsigned grid = static_cast<unsigned>(std::min(ntiles, wave));
  select_partials_kernel<<<grid, kThreads, shared, s>>>(
      static_cast<const int32_t*>(counts), n, ntiles, lo, hi, histo_max, nsh,
      static_cast<unsigned long long*>(bins),
      static_cast<uint32_t*>(tile_solid));
  e = cudaGetLastError();
  if (e != cudaSuccess || tile_solid == nullptr) return static_cast<int>(e);
  select_scan_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<uint32_t*>(tile_solid), ntiles,
      static_cast<int32_t*>(n_solid));
  return static_cast<int>(cudaGetLastError());
}

// Launch 3: planes (W planes, plane p at planes + p * stride), counts as
// in solid_select_count, tile_first its tile_solid after launch 2;
// out_rows (n_solid, W) uint32, out_counts n_solid int32.
int solid_select_scatter(const void* planes, int W, long long stride,
                         const void* counts, long long n, int lo, int hi,
                         const void* tile_first, void* out_rows,
                         void* out_counts, void* stream) {
  const long long ntiles = (n + kTile - 1) / kTile;
  if (n < 1 || n > 0x7FFFFFFFLL || W < 1 || stride < n ||
      reinterpret_cast<uintptr_t>(out_rows) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = W == 2   ? select_scatter_kernel<2>
                : W == 4 ? select_scatter_kernel<4>
                         : select_scatter_kernel<0>;
  kernel<<<static_cast<unsigned>(ntiles), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), W, stride,
      static_cast<const int32_t*>(counts), n, lo, hi,
      static_cast<const uint32_t*>(tile_first),
      static_cast<uint32_t*>(out_rows), static_cast<int32_t*>(out_counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Distinct reduce of sorted limb planes, written for Hopper (sm_90a).
//
// run_reduce has no Pallas original. It replaces the jnp distinct reduce of
// gatb_core_tpu/ops/sortops.py count_sorted_planes (:559-609) and
// count_sorted_planes_multi (:611-636): run detection, a cumsum of weights
// and the compaction of the run ends, which the JAX package does with
// scans and a sort keyed on the cumsum (_compact_ends :472) because its
// device scatters slowly. The port did it in torch ops (two cumsums, a
// where, two fills and two index_copy_ calls), 257 ms of the stress count's
// device time in the fold path and 490 ms in the LSM chain on an H100.
//
// Contract (ops/sortops.py count_sorted_planes_plain and _multi_plain): P
// planes of n uint32 rows, ascending (plane p at planes + p * n); inv, n
// bytes, nonzero on the invalid rows, which the callers keep at the tail;
// B weight rows of n int32 each (none: a weight of 1 per row, B = 1).
// Row i starts a run when it is valid and i == 0 or it differs from row
// i - 1; it ends one when it is valid and i == n - 1, row i + 1 differs or
// row i + 1 is invalid. n_out = the number of starts (int32), ovf_out =
// n_out > cap_out. The t-th end row (t < cap_out) goes to column t of the
// cap_out-column output planes and its count to column t of each bank's
// count row: the masked weights of the rows after the (t-1)-th end up to
// and including it, summed mod 2^32 (the difference of the int32 weight
// cumsum at the two ends that the plain version takes), and 0 where t >=
// n_out. Columns past the last end are all-ones with count 0.
//
// What bounds it: bytes, 4 P + 4 B + 1 read and, per run, 4 P + 4 B
// written. It is three launches, for the count of ends before a row is a
// prefix over the whole array:
//   1. run_partials_kernel: a block of 512 threads takes 4096 rows, 8
//      consecutive rows a thread; it counts its starts and ends and, per
//      bank, the weight carried past its last end (an ordered reduction of
//      (has end, sum since the last end) pairs); 2 + B words a block.
//   2. run_scan_kernel: one block scans those partials (a few thousand:
//      each thread a contiguous slice serially, one block-wide scan): the
//      ends before each block, the weight each block inherits from the
//      runs open at its start, n_out, ovf_out and the number of ends.
//   3. run_scatter_kernel: the same blocks again; each row's flags are
//      recomputed, a block-wide exclusive scan gives each end row its
//      column and the weight since the end before it (a run that crosses
//      block boundaries inherits the sum of the blocks it crossed from
//      launch 2), and each end row writes its planes and counts. The same
//      blocks then fill their share of the columns past the last end.
// The planes are read twice (launches 1 and 3); the bound counts them once.
// A run needs no atomics and the result does not depend on the order in
// which blocks run.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

// (an end among the rows, the weight after the last end) with the
// ordered combine "a then b"; (0, 0) is the identity
struct Seg {
  uint32_t h, s;
};

__device__ __forceinline__ Seg seg_op(Seg a, Seg b) {
  return {a.h | b.h, b.h ? b.s : a.s + b.s};
}

// Block-wide exclusive scan of x (threads in order) with seg_op; *total is
// the whole block's combine. smem holds 32 entries.
template <int THREADS>
__device__ Seg block_scan(Seg x, Seg* smem, Seg* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int warps = THREADS / 32;
  Seg inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Seg o{__shfl_up_sync(0xFFFFFFFFu, inc.h, d),
          __shfl_up_sync(0xFFFFFFFFu, inc.s, d)};
    if (lane >= d) inc = seg_op(o, inc);
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Seg v = lane < warps ? smem[lane] : Seg{0u, 0u};
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      Seg o{__shfl_up_sync(0xFFFFFFFFu, v.h, d),
            __shfl_up_sync(0xFFFFFFFFu, v.s, d)};
      if (lane >= d) v = seg_op(o, v);
    }
    smem[lane] = v;
  }
  __syncthreads();
  Seg excl{__shfl_up_sync(0xFFFFFFFFu, inc.h, 1),
           __shfl_up_sync(0xFFFFFFFFu, inc.s, 1)};
  if (lane == 0) excl = Seg{0u, 0u};
  const Seg before = warp ? smem[warp - 1] : Seg{0u, 0u};
  *total = smem[warps - 1];
  __syncthreads();  // smem is reused by the next scan
  return seg_op(before, excl);
}

// A sum is the combine of (0, x) pairs.
template <int THREADS>
__device__ uint32_t block_sum_excl(uint32_t x, Seg* smem, uint32_t* total) {
  Seg t;
  const Seg e = block_scan<THREADS>(Seg{0u, x}, smem, &t);
  *total = t.s;
  return e.s;
}

struct Rows {
  const uint32_t* planes;
  int P;
  long long n;
  const uint8_t* inv;
  const uint32_t* weights;  // null: a weight of 1
  // rows i and i - 1 differ, or i == 0 (0 < i < n or i == 0)
  __device__ bool differs_from_prev(long long i) const {
    if (i == 0) return true;
    for (int p = 0; p < P; ++p) {
      const uint32_t* x = planes + static_cast<size_t>(p) * n;
      if (x[i] != x[i - 1]) return true;
    }
    return false;
  }
  __device__ uint32_t weight(int c, long long i) const {
    return weights ? weights[static_cast<size_t>(c) * n + i] : 1u;
  }
};

// The flags of a thread's kItems consecutive rows from i0: bit q of *valid,
// *start and *end for row i0 + q (rows at n and beyond are none of them).
__device__ void row_flags(const Rows& R, long long i0, uint32_t* valid,
                          uint32_t* start, uint32_t* end) {
  uint32_t v = 0, st = 0, en = 0;
  bool prev_ne = i0 < R.n && R.differs_from_prev(i0);
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = i0 + q;
    if (i >= R.n) break;
    const bool last = i == R.n - 1;
    const bool next_ne = last || R.differs_from_prev(i + 1);
    const bool next_inv = last || R.inv[i + 1] != 0;
    if (R.inv[i] == 0) {
      v |= 1u << q;
      if (prev_ne) st |= 1u << q;
      if (next_ne || next_inv) en |= 1u << q;
    }
    prev_ne = next_ne;
  }
  *valid = v;
  *start = st;
  *end = en;
}

// (has an end, weight after the last end) of a thread's rows, bank c
__device__ Seg thread_seg(const Rows& R, long long i0, int c, uint32_t valid,
                          uint32_t end) {
  Seg a{0u, 0u};
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (!(valid >> q & 1u)) continue;
    a = (end >> q & 1u) ? Seg{1u, 0u} : Seg{a.h, a.s + R.weight(c, i0 + q)};
  }
  return a;
}

// aux layout (uint32): [0] the number of ends, then rows of nblocks words:
// starts, ends (after launch 2: the ends before the block), then one per
// bank (after launch 2: the weight the block inherits).
__global__ void __launch_bounds__(kThreads) run_partials_kernel(
    Rows R, int B, uint32_t* __restrict__ aux) {
  __shared__ Seg smem[32];
  const long long nblocks = gridDim.x;
  const long long i0 = blockIdx.x * static_cast<long long>(kTile) +
                       static_cast<long long>(threadIdx.x) * kItems;
  uint32_t valid, start, end;
  row_flags(R, i0, &valid, &start, &end);
  uint32_t n_start, n_end;
  block_sum_excl<kThreads>(__popc(start), smem, &n_start);
  block_sum_excl<kThreads>(__popc(end), smem, &n_end);
  uint32_t* row0 = aux + 1;
  if (threadIdx.x == 0) {
    row0[blockIdx.x] = n_start;
    row0[nblocks + blockIdx.x] = n_end;
  }
  for (int c = 0; c < B; ++c) {
    Seg total;
    block_scan<kThreads>(thread_seg(R, i0, c, valid, end), smem, &total);
    if (threadIdx.x == 0) row0[(2 + c) * nblocks + blockIdx.x] = total.s;
  }
}

__global__ void __launch_bounds__(kScanThreads) run_scan_kernel(
    uint32_t* __restrict__ aux, long long nblocks, int B, long long cap_out,
    int32_t* __restrict__ n_out, uint8_t* __restrict__ ovf_out) {
  __shared__ Seg smem[32];
  uint32_t* starts = aux + 1;
  uint32_t* ends = starts + nblocks;
  const long long per = (nblocks + kScanThreads - 1) / kScanThreads;
  const long long lo = min(nblocks, threadIdx.x * per);
  const long long hi = min(nblocks, lo + per);
  // the weight each block inherits, per bank (reads the ends' counts)
  for (int c = 0; c < B; ++c) {
    uint32_t* carry = ends + (1 + c) * nblocks;
    Seg a{0u, 0u};
    for (long long b = lo; b < hi; ++b)
      a = seg_op(a, Seg{ends[b] ? 1u : 0u, carry[b]});
    Seg total;
    Seg state = block_scan<kScanThreads>(a, smem, &total);
    for (long long b = lo; b < hi; ++b) {
      const Seg mine{ends[b] ? 1u : 0u, carry[b]};
      carry[b] = state.s;
      state = seg_op(state, mine);
    }
  }
  uint32_t st = 0, en = 0;
  for (long long b = lo; b < hi; ++b) {
    st += starts[b];
    en += ends[b];
  }
  uint32_t n_start, n_end;
  block_sum_excl<kScanThreads>(st, smem, &n_start);
  uint32_t run = block_sum_excl<kScanThreads>(en, smem, &n_end);
  for (long long b = lo; b < hi; ++b) {
    const uint32_t e = ends[b];
    ends[b] = run;
    run += e;
  }
  if (threadIdx.x == 0) {
    aux[0] = n_end;
    *n_out = static_cast<int32_t>(n_start);
    *ovf_out = static_cast<long long>(n_start) > cap_out;
  }
}

__global__ void __launch_bounds__(kThreads) run_scatter_kernel(
    Rows R, int B, const uint32_t* __restrict__ aux,
    const int32_t* __restrict__ n_runs, long long cap_out,
    uint32_t* __restrict__ out, uint32_t* __restrict__ counts) {
  __shared__ Seg smem[32];
  const long long nblocks = gridDim.x;
  const long long i0 = blockIdx.x * static_cast<long long>(kTile) +
                       static_cast<long long>(threadIdx.x) * kItems;
  const uint32_t* ends_before = aux + 1 + nblocks;
  const uint32_t* carry = ends_before + nblocks;
  uint32_t valid, start, end;
  row_flags(R, i0, &valid, &start, &end);
  uint32_t n_end_block;
  const long long col0 =
      ends_before[blockIdx.x] +
      static_cast<long long>(block_sum_excl<kThreads>(__popc(end), smem,
                                                      &n_end_block));
  // the end rows' planes
  {
    long long col = col0;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (!(end >> q & 1u)) continue;
      if (col < cap_out)
        for (int p = 0; p < R.P; ++p)
          out[static_cast<size_t>(p) * cap_out + col] =
              R.planes[static_cast<size_t>(p) * R.n + i0 + q];
      ++col;
    }
  }
  // per bank: the weight since the end before each end row
  const long long n = *n_runs;
  for (int c = 0; c < B; ++c) {
    Seg total;
    Seg state = block_scan<kThreads>(thread_seg(R, i0, c, valid, end), smem,
                                     &total);
    state = seg_op(Seg{0u, carry[c * nblocks + blockIdx.x]}, state);
    long long col = col0;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (!(valid >> q & 1u)) continue;
      const uint32_t w = R.weight(c, i0 + q);
      if (end >> q & 1u) {
        if (col < cap_out)
          counts[static_cast<size_t>(c) * cap_out + col] =
              col < n ? state.s + w : 0u;
        ++col;
        state = Seg{1u, 0u};
      } else {
        state.s += w;
      }
    }
  }
  // the columns past the last end: this block's share of them
  const long long filled = min(static_cast<long long>(aux[0]), cap_out);
  const long long share = (cap_out + nblocks - 1) / nblocks;
  const long long lo = max(filled, blockIdx.x * share);
  const long long hi = min(cap_out, (blockIdx.x + 1) * share);
  for (long long col = lo + threadIdx.x; col < hi; col += kThreads) {
    for (int p = 0; p < R.P; ++p)
      out[static_cast<size_t>(p) * cap_out + col] = kSentinel;
    for (int c = 0; c < B; ++c)
      counts[static_cast<size_t>(c) * cap_out + col] = 0u;
  }
}

}  // namespace

extern "C" {

// Rows of one block of launches 1 and 3 (the wrapper sizes aux from it).
int run_reduce_tile() { return kTile; }

// planes: P x n uint32, inv: n bytes, weights: B x n int32 or null (then B
// must be 1); aux: 1 + (2 + B) * ceil(n / tile) uint32 of scratch; n_out: one
// int32, ovf_out: one byte; out: P x cap_out uint32, counts: B x cap_out
// int32. Returns the first failed launch's cudaError_t (0 = launched).
int run_reduce(const void* planes, int P, long long n, const void* inv,
               const void* weights, int B, long long cap_out, void* aux,
               long long aux_words, void* n_out, void* ovf_out, void* out,
               void* counts, void* stream) {
  const long long nblocks = (n + kTile - 1) / kTile;
  if (P < 1 || n < 1 || n > 0xFFFFFFFFLL || B < 1 ||
      (weights == nullptr && B != 1) || cap_out < 0 ||
      aux_words < 1 + (2 + B) * nblocks || nblocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows R{static_cast<const uint32_t*>(planes), P, n,
               static_cast<const uint8_t*>(inv),
               static_cast<const uint32_t*>(weights)};
  uint32_t* a = static_cast<uint32_t*>(aux);
  const unsigned grid = static_cast<unsigned>(nblocks);
  run_partials_kernel<<<grid, kThreads, 0, s>>>(R, B, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  run_scan_kernel<<<1, kScanThreads, 0, s>>>(
      a, nblocks, B, cap_out, static_cast<int32_t*>(n_out),
      static_cast<uint8_t*>(ovf_out));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  run_scatter_kernel<<<grid, kThreads, 0, s>>>(
      R, B, a, static_cast<const int32_t*>(n_out), cap_out,
      static_cast<uint32_t*>(out), static_cast<uint32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

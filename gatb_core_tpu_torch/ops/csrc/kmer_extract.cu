// Canonical k-mer extraction into the sort's limb planes, written for Hopper
// (sm_90a).
//
// extract_planes has no Pallas original. It replaces what one superbatch
// step of the count computes in jnp, fused by XLA into a few loops:
// gatb_core_tpu/ops/kmer_ops.py extract_kmers_packed (:141-200: the funnel
// shifts of _window_limbs_from_words :258-310, the reverse complement, the
// canonical choice, window validity) and _minimizers (:311-340, the
// lexicographic branch), the pass filter (kmer/counting.py, minimizer %
// nb_passes == pass) and the sentinel encoding of ops/sortops.py
// _encode_invalid (:699). The port did this in torch ops, 16 * W extract
// calls and the int64 temporaries of revcomp, compare and where per step of
// 2^22 windows: ~370 ops at k = 31 per step, ~64k per stress count.
//
// Contract (ops/kmer_ops.py extract_planes_plain): R reads of packed words
// (2 bits a base, base 0 in the two most significant bits of word 0),
// n_words words a read; optional validity bits (n_vwords words a read, base
// 0 at bit 31 of word 0; none: every base inside the read is valid); read
// lengths. Window p of read r (0 <= p < P = L - k + 1) is row r * P + p. Its
// W = ceil(2k / 32) limbs (big-endian, limb 0 most significant, the top limb
// masked to 2k - 32 (W - 1) bits) go to planes[j * cap + row] as
// min(forward, reverse complement) in unsigned lexicographic order when
// the window is kept, else all-ones; keep[row] says which. A window is
// valid when p + k <= length and, with validity bits, its k bits are all
// set; with nb_passes > 1 it is kept when valid and its minimizer (the
// least of the lut values of its k - m + 1 m-mers: the canonical m-mer, or
// 4^m - 1 where an 'AA' stands anywhere but at its start) modulo nb_passes
// is pass_i. Rows from R * P up to cap are all-ones and not kept.
// counters[0] += kept windows, counters[1] += valid windows (both 64-bit;
// the caller zeroes them). Words past n_words read as zero, as the plain
// version's padding does.
//
// What bounds it: bytes. The packed words are read once (2 bits a base)
// and 4 W + 1 bytes written per row, about 2 ms for the stress count's
// 720M windows on an H100 (3.35 TB/s). Every word a window needs lies
// within a few words of its neighbours', so one thread per window reads
// them through L1: a thread funnel-shifts its W limbs out of the stream,
// reverses and complements them in registers (__brev and a swap of the bits
// of each base), shifts out the slack 32 W - 2 k, compares and writes. Its
// writes are coalesced (neighbouring threads, neighbouring rows). The
// minimizer is a loop of k - m + 1 m-mers per thread, recomputed by each
// window (a later lever: the m-mers shared by neighbouring windows through
// shared memory); the counting path's default is one pass, which skips it.
// The two counters take one __syncthreads_count each and one atomic per
// block.
//
// W is a template parameter, 1 to 8 limbs (k <= 128).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

// One read's packed stream: bit 0 is the most significant bit of word 0.
struct Stream {
  const uint32_t* w;
  int n;
  __device__ uint32_t word(int i) const { return i < n ? w[i] : 0u; }
  // the 32 bits of the stream from bit `bit` on
  __device__ uint32_t bits32(int bit) const {
    const int i = bit >> 5, s = bit & 31;
    const uint32_t a = word(i);
    return s ? (a << s) | (word(i + 1) >> (32 - s)) : a;
  }
};

// The 16 bases of a word in reverse order, each complemented (code ^ 2).
__device__ __forceinline__ uint32_t revcomp_word(uint32_t x) {
  uint32_t r = __brev(x);
  r = ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
  return r ^ 0xAAAAAAAAu;
}

// bitpack.mmer_allowed: no 'AA' (two zero bases) anywhere but at the start
__device__ __forceinline__ bool mmer_allowed(uint32_t x, int m) {
  const uint32_t mmask = (1u << ((m - 2) * 2)) - 1u;
  const uint32_t a = ~(x | (x >> 2));
  return ((a >> 1) & a & 0x55555555u & mmask) == 0u;
}

template <int W>
__global__ void __launch_bounds__(kThreads) extract_planes_kernel(
    const uint32_t* __restrict__ words, int n_words,
    const uint32_t* __restrict__ vmask, int n_vwords,
    const int32_t* __restrict__ lengths, uint32_t* __restrict__ planes,
    uint8_t* __restrict__ keep, unsigned long long* __restrict__ counters,
    unsigned rows, unsigned cap, int P, int k, int m, int nb_passes,
    int pass_i) {
  const unsigned row = blockIdx.x * kThreads + threadIdx.x;
  bool valid = false, kept = false;
  uint32_t canon[W];
  if (row < rows) {
    const unsigned r = row / static_cast<unsigned>(P);
    const int p = static_cast<int>(row - r * static_cast<unsigned>(P));
    const Stream s{words + static_cast<size_t>(r) * n_words, n_words};
    // forward limbs: limb j is the 32 bits ending 32 (W - 1 - j) bits
    // before the window's end; limb 0 holds the top 2k - 32 (W - 1) bits
    const int top_bits = 2 * k - 32 * (W - 1);
    uint32_t fwd[W];
    fwd[0] = top_bits == 32 ? s.bits32(2 * p)
                            : s.bits32(2 * p) >> (32 - top_bits);
#pragma unroll
    for (int j = 1; j < W; ++j) fwd[j] = s.bits32(2 * p + 2 * k - 32 * (W - j));
    // reverse complement: bases reversed in each limb, limbs reversed, then
    // the 32 W - 2 k slack bits (now at the bottom) shifted out
    uint32_t rc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) rc[j] = revcomp_word(fwd[W - 1 - j]);
    const int slack = 32 * W - 2 * k;
    if (slack) {
#pragma unroll
      for (int j = W - 1; j > 0; --j)
        rc[j] = (rc[j] >> slack) | (rc[j - 1] << (32 - slack));
      rc[0] >>= slack;
    }
    bool fwd_lt = false, decided = false;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (!decided && fwd[j] != rc[j]) {
        fwd_lt = fwd[j] < rc[j];
        decided = true;
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) canon[j] = fwd_lt ? fwd[j] : rc[j];
    valid = p + k <= lengths[r];
    if (valid && vmask != nullptr) {
      const Stream v{vmask + static_cast<size_t>(r) * n_vwords, n_vwords};
      for (int b = 0; b < k; b += 32) {
        const int nb = min(32, k - b);
        const uint32_t need = nb == 32 ? ~0u : ~(~0u >> nb);
        if ((v.bits32(p + b) & need) != need) {
          valid = false;
          break;
        }
      }
    }
    kept = valid;
    if (valid && nb_passes > 1) {
      const uint32_t banned = m == 16 ? ~0u : (1u << (2 * m)) - 1u;
      uint32_t best = ~0u;
      for (int i = p; i <= p + k - m; ++i) {
        const uint32_t mm = s.bits32(2 * i) >> (32 - 2 * m);
        const uint32_t rm = revcomp_word(mm) >> (32 - 2 * m);
        const uint32_t c = min(mm, rm);
        best = min(best, mmer_allowed(c, m) ? c : banned);
      }
      kept = best % static_cast<uint32_t>(nb_passes) ==
             static_cast<uint32_t>(pass_i);
    }
  }
  if (row < cap) {
#pragma unroll
    for (int j = 0; j < W; ++j)
      planes[static_cast<size_t>(j) * cap + row] = kept ? canon[j] : kSentinel;
    keep[row] = kept;
  }
  const int n_valid = __syncthreads_count(valid);
  const int n_kept = __syncthreads_count(kept);
  if (threadIdx.x == 0) {
    if (n_kept) atomicAdd(counters, static_cast<unsigned long long>(n_kept));
    if (n_valid)
      atomicAdd(counters + 1, static_cast<unsigned long long>(n_valid));
  }
}

template <int W>
int launch(const void* words, int n_words, const void* vmask, int n_vwords,
           const void* lengths, void* planes, void* keep, void* counters,
           long long rows, long long cap, int P, int k, int m, int nb_passes,
           int pass_i, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((cap + kThreads - 1) / kThreads);
  extract_planes_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const uint32_t*>(vmask), n_vwords,
      static_cast<const int32_t*>(lengths), static_cast<uint32_t*>(planes),
      static_cast<uint8_t*>(keep),
      static_cast<unsigned long long*>(counters), static_cast<unsigned>(rows),
      static_cast<unsigned>(cap), P, k, m, nb_passes, pass_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// words: R x n_words, vmask: R x n_vwords or null (dense), lengths: R int32;
// planes: W x cap uint32 (W = ceil(2k / 32)), keep: cap bytes, counters: 2
// uint64 (added to). rows = R * P with P = L - k + 1. Returns the launch's
// cudaError_t (0 = launched).
int extract_planes(const void* words, int n_words, const void* vmask,
                   int n_vwords, const void* lengths, void* planes, void* keep,
                   void* counters, long long rows, long long cap, int P, int k,
                   int m, int nb_passes, int pass_i, void* stream) {
  const int w = (2 * k + 31) / 32;
  if (k < 1 || w > 8 || P < 1 || rows < 0 || rows > cap || cap < 1 ||
      cap > 0x7FFFFFFFLL || n_words < 1 || (vmask && n_vwords < 1) ||
      nb_passes < 1 || (nb_passes > 1 && (m < 2 || m > 16 || m > k)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 1: return launch<1>(words, n_words, vmask, n_vwords, lengths, planes,
                             keep, counters, rows, cap, P, k, m, nb_passes,
                             pass_i, s);
    case 2: return launch<2>(words, n_words, vmask, n_vwords, lengths, planes,
                             keep, counters, rows, cap, P, k, m, nb_passes,
                             pass_i, s);
    case 3: return launch<3>(words, n_words, vmask, n_vwords, lengths, planes,
                             keep, counters, rows, cap, P, k, m, nb_passes,
                             pass_i, s);
    case 4: return launch<4>(words, n_words, vmask, n_vwords, lengths, planes,
                             keep, counters, rows, cap, P, k, m, nb_passes,
                             pass_i, s);
    case 5: return launch<5>(words, n_words, vmask, n_vwords, lengths, planes,
                             keep, counters, rows, cap, P, k, m, nb_passes,
                             pass_i, s);
    case 6: return launch<6>(words, n_words, vmask, n_vwords, lengths, planes,
                             keep, counters, rows, cap, P, k, m, nb_passes,
                             pass_i, s);
    case 7: return launch<7>(words, n_words, vmask, n_vwords, lengths, planes,
                             keep, counters, rows, cap, P, k, m, nb_passes,
                             pass_i, s);
    default: return launch<8>(words, n_words, vmask, n_vwords, lengths, planes,
                              keep, counters, rows, cap, P, k, m, nb_passes,
                              pass_i, s);
  }
}

}  // extern "C"

"""Bloom filters as device bit tensors with batched probes.

Port of gatb_core_tpu/collections/bloom.py, the equivalent of gatb-core's
IBloom family (tools/collections/impl/Bloom.hpp:113-1290). The reference's
synchronized/cache-coherent variants exist to manage CPU atomics and cache
lines; here the build is a scatter of idempotent writes and the query is a
vectorized gather, so one implementation covers Bloom/BloomSynchronized/
BloomCacheCoherent use cases.

Hash family: bit-exact port of the reference's seeded hash1 chain
(Bloom.hpp:81-92 seed generation, NativeInt64.hpp:175-188 hash64,
LargeInt.hpp:738-749 per-64-bit-chunk XOR) so filter sizes/false-positive
behavior match the reference's for the same parameters.

Sizing formulas (BloomAlgorithm.cpp:161-163):
  size = nb_items * nbits_per_kmer, n_hash = max(1, floor(0.7 * nbits))

Representation: limbs are (N, W) rows, int32 storage or zero-extended
int64; 64-bit hashes are int64 tensors (ops/u64.py); bit positions are
int64 holding values that the JAX package carries as uint32, cut back to 32
bits after every addition so that they wrap where uint32 wraps. The packed
words are an int32 tensor of uint32 bit patterns (bit ``i`` of word ``j``
is bit ``32 j + i``); ``BloomFilter.to_numpy`` hands them out as uint32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.bitpack import M32, as_u32_i64
from ..ops.u64 import hash64, s64, u64_join, u64_mod_u32

NSEEDSBLOOM = 10
_RBASE = [
    0xAAAAAAAA55555555, 0x33333333CCCCCCCC, 0x6666666699999999,
    0xB5B5B5B54B4B4B4B, 0xAA55AA5555335533, 0x33CC33CCCC66CC66,
    0x6699669999B599B5, 0xB54BB54B4BAA4BAA, 0xAA33AA3355CC55CC,
    0x33663366CC99CC99,
]


def bloom_seeds(user_seed: int = 0) -> list[int]:
    """Seed table generation, bit-exact (Bloom.hpp:81-92)."""
    seeds = list(_RBASE)
    for i in range(NSEEDSBLOOM):
        seeds[i] = (seeds[i] * seeds[(i + 3) % NSEEDSBLOOM] + user_seed) \
            & 0xFFFFFFFFFFFFFFFF
    return seeds


def optimal_params(nb_items: int, nbits_per_kmer: float) -> tuple[int, int]:
    """(size_bits, n_hash) exactly as BloomAlgorithm::execute computes them
    (BloomAlgorithm.cpp:159-165): the C expression
    ``(u_int64_t)(solidKmersNb * NBITS_PER_KMER)`` multiplies in float32
    (NBITS is a C float), and ``(int)floorf(0.7*NBITS)`` rounds through
    float32 too; both are reproduced bit-for-bit so bloom sizes (and hence
    false-positive/cFP sets) match the reference binary."""
    f = np.float32
    size = int(f(nb_items) * f(nbits_per_kmer))
    if size == 0:
        size = 1000  # BloomAlgorithm.cpp:165
    n_hash = int(np.floor(f(0.7 * float(f(nbits_per_kmer)))))
    return size, max(1, min(n_hash, NSEEDSBLOOM))


def _chunk_hash(limbs: torch.Tensor, seed: int) -> torch.Tensor:
    """XOR of hash64 over the 64-bit chunks of each k-mer
    (LargeInt.hpp:738-749). limbs: (N, W32) big-endian uint32; an odd
    number of limbs gets a zero limb IN FRONT. Returns (N,) int64."""
    x = as_u32_i64(limbs)
    n, w32 = x.shape
    if w32 % 2:
        x = torch.cat([torch.zeros((n, 1), dtype=torch.int64,
                                   device=x.device), x], dim=1)
    acc = None
    for j in range(x.shape[1] // 2):
        h = hash64(u64_join(x[:, 2 * j], x[:, 2 * j + 1]), seed)
        acc = h if acc is None else acc ^ h
    return acc


class BloomFilter(NamedTuple):
    """Packed bloom bit array (device) + parameters.

    kind 'basic'  - every probe = hash1(seed_i) mod size
                    (reference Bloom/BloomSynchronized, Bloom.hpp:113-416)
    kind 'cache'  - h0 = hash1(seed_0) mod size; probes i>=1 land in the
                    2^12-bit block at h0: h0 + (simplehash16(key, i) & fff)
                    (reference BloomCacheCoherent, Bloom.hpp:430-497: the
                    default BloomKind of a graph build, Enums.hpp:73).
                    The bit array carries 2*2^12 slack bits past size_bits,
                    exactly like the reference ctor (Bloom.hpp:438-442).
    kind 'neighbor' - see ``_bloom_positions``.
    """

    words: torch.Tensor     # (ceil((size+pad)/32),) int32: uint32 patterns
    size_bits: int          # logical size (== _reduced_tai for 'cache')
    n_hash: int
    user_seed: int
    kind: str = "basic"
    kmer_size: int = 0      # needed by the 'neighbor' kind only

    def contains(self, limbs: torch.Tensor) -> torch.Tensor:
        """Batched membership probe: (N, W32) -> (N,) bool, on the device
        of the words."""
        return _bloom_contains(self.words, limbs.to(self.words.device),
                               self.size_bits, self.n_hash, self.user_seed,
                               self.kind, self.kmer_size)

    def to_numpy(self) -> np.ndarray:
        """The packed words as a uint32 numpy array."""
        return self.words.detach().cpu().numpy().view(np.uint32)


BLOCK_NBITS = 12  # BloomCacheCoherent block size (Bloom.hpp:437)

# canonical (first_nt, last_nt) pair table of BloomNeighborCoherent
# (Bloom.hpp:526-541 cano2[16])
CANO2 = (0, 1, 2, 3, 4, 5, 3, 7, 8, 9, 0, 4, 9, 13, 1, 5)


def _simplehash16(limbs: torch.Tensor, shift: int,
                  span1: bool) -> torch.Tensor:
    """Bit-exact port of simplehash16 on the LOW 64-bit word of the k-mer.
    Returns (N,) int64 (the 64-bit hash).

    Two variants exist in the reference and the choice follows the
    compiled span type of the k-mer, NOT a formula:
    - LargeInt<1> (k <= 31, span 32): LargeInt1.pri:190-201 XORs THREE
      RANDOM_VALUES bytes: (key>>shift), (key>>shift+8), and (key&255).
    - every other span: NativeInt64.hpp:211-219 via LargeInt2.pri:248 /
      LargeInt.hpp:792-800: only the first TWO bytes.
    shift < 10 here (hash index), so all bytes live in the low 32 bits.
    """
    from .bloom_data import RANDOM_VALUES

    assert shift + 16 <= 32, "simplehash16 shift out of low-limb range"
    lo = as_u32_i64(limbs[:, -1])
    rv = torch.tensor([s64(v) for v in RANDOM_VALUES], dtype=torch.int64,
                      device=lo.device)
    out = rv[(lo >> shift) & 0xFF] ^ rv[(lo >> (shift + 8)) & 0xFF]
    if span1:
        out = out ^ rv[lo & 0xFF]
    return out


def _neighbor_hashpart(limbs: torch.Tensor, k: int) -> tuple:
    """(canonical inner (k-2)-mer limbs, cano2 prefix value) of each k-mer
    (BloomNeighborCoherent insert/contains, Bloom.hpp:555-575). The inner
    (k-2)-mer can have one limb fewer than the k-mer (k = 17, 33, 49 ...)."""
    from ..ops.kmer_ops import lex_lt, nb_limbs, top_mask
    from ..ops.neighbor_ops import revcomp_limbs

    x = as_u32_i64(limbs)
    n, w = x.shape
    top_bits = 2 * k - 32 * (w - 1)
    first_nt = (x[:, 0] >> (top_bits - 2)) & 3
    last_nt = x[:, -1] & 3
    cano2 = torch.tensor(CANO2, dtype=torch.int64, device=x.device)
    pref_val = cano2[(first_nt << 2) + last_nt]
    # hashpart = (v >> 2) & mask_{2(k-2)}
    hp = x >> 2
    hp[:, 1:] |= (x[:, :-1] << 30) & M32
    wk2 = nb_limbs(k - 2)
    if wk2 < w:
        hp = hp[:, w - wk2:].contiguous()
    hp[:, 0] &= top_mask(k - 2)
    rc = revcomp_limbs(hp, k - 2)
    hp = torch.where(lex_lt(hp, rc)[:, None], hp, rc)
    return hp, pref_val


def _bloom_positions(limbs, size_bits: int, n_hash: int, seed: int,
                     kind: str = "basic", kmer_size: int = 0):
    """(N, n_hash) int64 bit positions (uint32 values) of each k-mer."""
    seeds = bloom_seeds(seed)
    if kind == "basic":
        return torch.stack([u64_mod_u32(_chunk_hash(limbs, seeds[i]),
                                        size_bits)
                            for i in range(n_hash)], dim=-1)
    mask_block = (1 << BLOCK_NBITS) - 1
    # the simplehash16 variant follows the compiled span type of the item:
    # LargeInt<1> (k <= 31 with KSIZE_LIST 32/64/96/128) uses the 3-byte mix
    span1 = 0 < kmer_size <= 31
    if kind == "neighbor":
        # BloomNeighborCoherent (Bloom.hpp:514-640): hash the canonical
        # inner (k-2)-mer, offset h0 by the cano2 (first,last)-nt value:
        # a k-mer and its neighbors share the same 2^12-bit block
        key, pref_val = _neighbor_hashpart(limbs, kmer_size)
        h0 = (u64_mod_u32(_chunk_hash(key, seeds[0]), size_bits)
              + pref_val) & M32
    else:
        # cache-coherent (Bloom.hpp:446-497): h0 anywhere, others in-block
        h0 = u64_mod_u32(_chunk_hash(limbs, seeds[0]), size_bits)
        key = limbs
    pos = [h0]
    for i in range(1, n_hash):
        off = _simplehash16(key, i, span1) & mask_block
        pos.append((h0 + off) & M32)
    return torch.stack(pos, dim=-1)


def _bloom_nwords(size_bits: int, kind: str) -> int:
    pad = 2 * (1 << BLOCK_NBITS) if kind in ("cache", "neighbor") else 0
    return (size_bits + pad + 31) // 32


_PACK_WORDS = 1 << 22     # words packed per step (bounds the temporaries)


def _pack_bits(bits: torch.Tensor, n_words: int) -> torch.Tensor:
    """(32 * n_words,) bool -> (n_words,) int32 words, little-endian in the
    word: bit ``i`` of word ``j`` is bit ``32 j + i``. The sum of distinct
    powers of two wraps into int32 with bit 31 as the sign bit."""
    weights = torch.ones(32, dtype=torch.int32, device=bits.device) \
        << torch.arange(32, dtype=torch.int32, device=bits.device)
    words = torch.empty((n_words,), dtype=torch.int32, device=bits.device)
    grid = bits.view(n_words, 32)
    for i in range(0, n_words, _PACK_WORDS):
        words[i:i + _PACK_WORDS] = (
            grid[i:i + _PACK_WORDS].to(torch.int32) * weights[None, :]
        ).sum(dim=1, dtype=torch.int32)
    return words


def _bloom_build(limbs, valid, size_bits: int, n_hash: int, seed: int,
                 kind: str = "basic", kmer_size: int = 0):
    """Packed words of the filter over the valid rows of ``limbs``. Invalid
    rows are left out before any position is computed (the JAX module
    sends theirs to a dropped out-of-range bit)."""
    n_words = _bloom_nwords(size_bits, kind)
    bits = torch.zeros((n_words * 32,), dtype=torch.bool,
                       device=limbs.device)
    if valid is not None:
        limbs = limbs[valid]
    if limbs.shape[0]:
        pos = _bloom_positions(limbs, size_bits, n_hash, seed, kind,
                               kmer_size)
        bits[pos.reshape(-1)] = True
    return _pack_bits(bits, n_words)


def _bloom_contains(words, limbs, size_bits: int, n_hash: int, seed: int,
                    kind: str = "basic", kmer_size: int = 0):
    if limbs.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=words.device)
    pos = _bloom_positions(limbs, size_bits, n_hash, seed, kind, kmer_size)
    bit = (words[pos >> 5].to(torch.int64) >> (pos & 31)) & 1
    return (bit == 1).all(dim=-1)


def build_bloom(limbs: torch.Tensor, valid: torch.Tensor | None = None, *,
                nbits_per_kmer: float = 12.0, nb_items: int | None = None,
                user_seed: int = 0, kind: str = "basic",
                kmer_size: int = 0) -> BloomFilter:
    """Build a bloom over a set of k-mers (BloomAlgorithm equivalent,
    kmer/impl/BloomAlgorithm.cpp:155-203), on the device of ``limbs``.
    kind: 'basic', 'cache', or 'neighbor' (the graph-build default;
    requires kmer_size)."""
    if kind in ("cache-coherent", "default"):
        kind = "cache"
    if kind not in ("basic", "cache", "neighbor"):
        raise ValueError(f"unknown bloom kind {kind!r}")
    if kind == "neighbor" and kmer_size < 3:
        raise ValueError("neighbor bloom needs kmer_size >= 3")
    if nb_items is None:
        nb_items = limbs.shape[0] if valid is None else int(valid.sum())
    size_bits, n_hash = optimal_params(nb_items, nbits_per_kmer)
    words = _bloom_build(limbs, valid, size_bits, n_hash, user_seed, kind,
                         kmer_size)
    return BloomFilter(words, size_bits, n_hash, user_seed, kind, kmer_size)


# NBITS_PER_KMER formula used by debloom (DebloomAlgorithm.cpp:628-650);
# the C function returns a float, so the value is rounded through float32
def debloom_nbits_per_kmer(kmer_size: int, cascading: bool) -> float:
    import math

    if cascading:
        if kmer_size > 128:
            raise ValueError(
                f"kmer size {kmer_size} too big for cascading bloom filters")
        from .bloom_data import CASCADING_NBITS

        v = CASCADING_NBITS[kmer_size]
    else:
        lg2 = math.log(2)
        v = math.log(16 * kmer_size * (lg2 * lg2)) / (lg2 * lg2)
    v = float(np.float32(v))
    return v if v != 0 else 1.0

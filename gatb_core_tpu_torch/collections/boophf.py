"""BooPHF-style minimal perfect hash (BBHash algorithm) on torch tensors.

Port of gatb_core_tpu/collections/boophf.py. Reference: gatb-core's BooPHF
wrapper (tools/collections/impl/BooPHF.hpp:230-340) over the vendored
BBHash (thirdparty/BooPHF/BooPHF.h): a cascade of level bitvectors; at each
level every remaining key is hashed into a gamma*n-slot bit array; slots hit
exactly once become final (bit set), colliding keys fall through to the next
level; leftovers after the last level go to a small exact fallback. The
code of a key is the rank of its set bit across all levels (gamma = 3.0 for
fast build, BooPHF.hpp:269).

The query is branch-free: per level one 64-bit hash (ops/u64.py, one int64
per 64-bit value), one bitvector word gather, one prefix-rank gather and a
popcount of the bits below (SWAR: torch has no popcount op); the fallback
is a rank search through ``ops/rank_search.rank_rows``. The build runs on
the device of the keys too, where the JAX module goes to the host after
hashing: ``torch.bincount`` of the slots, a bit pack, a SWAR popcount and
``cumsum`` for the prefix, a stable sort of the placed slots. Every array
equals the JAX module's for the same keys.

Codes stay aligned with the sorted-table rank used everywhere else
(collections/sortedset.py): ``perm[code] -> sorted rank``, so this
structure answers ``SortedKmerSet.rank`` with identical return values.

Tensors: ``bits`` int32 storage of the uint32 words, ``prefix`` int32,
``perm`` int32, ``fallback_keys`` (F, W) int32 rows, ``fallback_ranks``
int32, all on one device.
"""

from __future__ import annotations

import torch

from ..ops.bitpack import as_u32_i64
from ..ops.rank_search import as_rows
from ..ops.u64 import hash64, u64_mod_u32

I32 = torch.int32
I64 = torch.int64

# fixed per-level seeds (the JAX package's constants; the level hash only
# needs to be deterministic and well-mixed; reference BBHash likewise
# re-seeds per level)
LEVEL_SEEDS = (
    0x9E3779B97F4A7C15,
    0xC2B2AE3D27D4EB4F,
    0x165667B19E3779F9,
    0x27D4EB2F165667C5,
    0x85EBCA6B2F165667,
)
DEFAULT_LEVELS = 4
GAMMA = 3.0  # BooPHF.hpp:269 (gamma=3 chosen by gatb for fast build)


def _limbs_to_u64(limbs: torch.Tensor) -> list[torch.Tensor]:
    """(N, W) big-endian uint32 limbs -> list of 64-bit chunks, one int64
    tensor each; an odd W gets a zero limb in front.

    Mirrors the reference's per-64-bit-chunk hashing of LargeInt
    (tools/math/LargeInt.hpp:738-749: XOR of hash64 over uint64 words).
    """
    x = as_u32_i64(limbs)
    n, w = x.shape
    if w % 2:
        x = torch.cat([torch.zeros((n, 1), dtype=I64, device=x.device), x],
                      dim=1)
        w += 1
    return [(x[:, j] << 32) | x[:, j + 1] for j in range(0, w, 2)]


def _level_hash(limbs: torch.Tensor, seed: int, size: int) -> torch.Tensor:
    """Per-level slot index: XOR of chunk hashes mod the level size.
    Returns int64 in [0, size)."""
    h = None
    for c in _limbs_to_u64(limbs):
        hc = hash64(c, seed)
        h = hc if h is None else h ^ hc
    return u64_mod_u32(h, size)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 storage or zero-extended int64),
    SWAR in int64. Returns int64."""
    x = as_u32_i64(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _round_up_64(x: int) -> int:
    return max(64, (x + 63) & ~63)


class BooPHF:
    """Static minimal perfect hash over a sorted distinct k-mer table.

    Query returns the *sorted rank* (same codes as SortedKmerSet.rank) in
    O(levels) gathers instead of O(log n) binary-search rounds.
    """

    def __init__(self, sizes, bits, prefix, offsets, fallback_keys,
                 fallback_ranks, perm, n):
        self.sizes = sizes                  # per-level slot counts
        self.bits = bits                    # (total_words,) uint32 bits
        self.prefix = prefix                # (total_words,) int32 rank prefix
        self.offsets = offsets              # per-level word offsets
        self.fallback_keys = fallback_keys  # (F, W) sorted leftover keys
        self.fallback_ranks = fallback_ranks  # (F,) their sorted ranks
        self.perm = perm                    # (n,) code -> sorted rank
        self.n = n

    @property
    def device(self) -> torch.device:
        return self.bits.device

    # ------------------------------------------------------------------ build

    @classmethod
    def build(cls, limbs, n: int, levels: int = DEFAULT_LEVELS,
              gamma: float = GAMMA) -> "BooPHF":
        """limbs: (C, W) sorted distinct keys as a limb tensor (rows >= n
        are padding); the structure is built on its device."""
        from ..collections.bloom import _pack_bits

        keys = as_rows(limbs[:n])
        dev = keys.device
        remaining = torch.arange(n, device=dev)   # sorted ranks unplaced
        sizes: list[int] = []
        level_bits: list[torch.Tensor] = []
        codes = torch.full((n,), -1, dtype=I64, device=dev)
        next_code = 0
        for lvl in range(levels):
            left = remaining.shape[0]
            if left == 0:
                sizes.append(64)
                level_bits.append(torch.zeros(2, dtype=I32, device=dev))
                continue
            size = _round_up_64(int(gamma * left))
            h = _level_hash(keys[remaining], LEVEL_SEEDS[lvl], size)
            counts = torch.bincount(h, minlength=size)
            placed = counts[h] == 1
            slots = h[placed]
            # bit set exactly at once-hit slots
            once = counts == 1
            sizes.append(size)
            level_bits.append(_pack_bits(once, size // 32))
            # codes: rank of slot among set bits of this level, offset by
            # previously assigned codes
            order = torch.sort(slots, stable=True).indices
            nb = slots.shape[0]
            codes[remaining[placed][order]] = next_code + torch.arange(
                nb, device=dev)
            next_code += nb
            remaining = remaining[~placed]

        # fallback: leftover keys, exact sorted-array lookup
        codes[remaining] = next_code + torch.arange(remaining.shape[0],
                                                    device=dev)
        offsets = []
        word_off = 0
        for bv in level_bits:
            offsets.append(word_off)
            word_off += bv.shape[0]
        bits = torch.cat(level_bits)
        pop = _popcount32(bits)
        prefix = torch.zeros_like(pop)
        prefix[1:] = torch.cumsum(pop, 0)[:-1]

        perm = torch.full((max(n, 1),), -1, dtype=I32, device=dev)
        if n:
            perm[codes] = torch.arange(n, dtype=I32, device=dev)
        return cls(tuple(sizes), bits, prefix.to(I32), tuple(offsets),
                   keys[remaining].contiguous(), remaining.to(I32), perm, n)

    # ------------------------------------------------------------------ query

    def rank(self, queries: torch.Tensor) -> torch.Tensor:
        """(Q, W) limb rows -> (Q,) int32 sorted rank on the structure's
        device; valid only for keys in the set (MPHF contract, like
        reference BooPHF): an absent key may alias a code."""
        q = as_rows(queries.to(self.device))
        if self.n == 0:
            return torch.full((q.shape[0],), -1, dtype=I32, device=q.device)
        return _boophf_rank(q, self.bits, self.prefix, self.perm,
                            self.fallback_keys, self.fallback_ranks,
                            self.sizes, self.offsets)


def _boophf_rank(queries, bits, prefix, perm, fb_keys, fb_ranks,
                 sizes: tuple, offsets: tuple) -> torch.Tensor:
    """Per level: hash, one word gather, the popcount of the bits below;
    then the fallback search (``rank_rows``) and the code -> rank map. No
    host sync: the level bases stay 0-d tensors."""
    from ..ops.rank_search import rank_rows

    q = queries.shape[0]
    code = torch.full((q,), -1, dtype=I64, device=queries.device)
    prefix = prefix.to(I64)
    level_base = torch.zeros((), dtype=I64, device=queries.device)
    for lvl, (size, woff) in enumerate(zip(sizes, offsets)):
        idx = _level_hash(queries, LEVEL_SEEDS[lvl], size)
        word_i = woff + (idx >> 5)
        word = as_u32_i64(bits[word_i])
        bitpos = idx & 31
        hit = ((word >> bitpos) & 1) != 0
        below = word & ((1 << bitpos) - 1)
        rank = prefix[word_i] - prefix[woff] + _popcount32(below)
        code = torch.where((code < 0) & hit, level_base + rank, code)
        # number of set bits in this level = prefix at the next level's
        # first word (or the popcount of the last word past the end)
        end = woff + size // 32
        total_lvl = prefix[end] if end < prefix.shape[0] \
            else prefix[-1] + _popcount32(bits[-1:])[0]
        level_base = level_base + (total_lvl - prefix[woff])
    # fallback: rank search over the leftover sorted keys
    nf = fb_keys.shape[0]
    if nf:
        pos, found = rank_rows(fb_keys, queries, nf)
        code = torch.where((code < 0) & found, level_base + pos.to(I64),
                           code)
    out = torch.where(code >= 0, perm[code.clamp(min=0)].to(I64),
                      torch.full_like(code, -1))
    return out.to(I32)

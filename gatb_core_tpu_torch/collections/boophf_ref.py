"""Reference-format BooPHF: parse / build / query / serialize the exact
binary layout of gatb-core's MPHF, the stream a graph ``.h5`` carries at
/dsk/mphf.

Port of gatb_core_tpu/collections/boophf_ref.py without its
``RefMPHFAdapter``. It is host code in both packages (numpy, one
sequential pass per level) and is copied here as it is. The port writes
the stream for reference tools; it answers ``Graph.node_index`` through
the rank search on the device, so it needs no lookup through the stream.

Layout (thirdparty/BooPHF/BooPHF.h save/load:933-1010, little-endian):
  double gamma | int32 nb_levels | u64 lastbitsetrank | u64 nelem
  per level (bitVector::save:627-635):
    u64 size_bits | u64 nchar | nchar x u64 words |
    u64 nb_ranks | nb_ranks x u64 (cumulative ACROSS levels,
                                   sampled every 512 bits)
  u64 final_hash_size | entries (elem_t key = W x u64 words, u64 value)

Hash chain (gatb wrapper BooPHF.hpp:230-340 + XorshiftHashFunctors,
BooPHF.h:304-360): h0 = get<0>(jenkins64(key)), h1 = get<2> (the
0x33333333CCCCCCCCULL "hack" selects the third lane), then xorshift128+
steps. The jenkins seed is the first draw of std::mt19937_64(37)
(BooPHF.hpp:244 `std::mt19937_64 rng(37)`).

Construction (mphf::processLevel, BooPHF.h:860-930): 25 levels, per
level every still-unplaced key hashes into a bit array; bits hit once
keep the key at this level, collided bits are cleared and the keys
cascade; leftovers land in an exact final map valued by arrival order.
Deterministic given the key iteration order, so the numpy build emits a
stream the reference binary loads. Key width: see ref_key_words().
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import numpy as np

U64 = np.uint64
# first output of std::mt19937_64(37) — the deterministic jenkins seed
# gatb-core uses (BooPHF.hpp:244); computed with g++/libstdc++
JENKINS_SEED = np.uint64(18006821046139946489)
_GOLDEN = np.uint64(0x9E3779B97F4A7C13)
NB_LEVELS = 25
_RANK_SAMPLE = 512  # _nb_bits_per_rank_sample


def _mix(a, b, c):
    """The 12-step jenkins mix (BooPHF.hpp:185-200), uint64 wraparound."""
    a = a - b - c
    a = a ^ (c >> U64(43))
    b = b - c - a
    b = b ^ (a << U64(9))
    c = c - a - b
    c = c ^ (b >> U64(8))
    a = a - b - c
    a = a ^ (c >> U64(38))
    b = b - c - a
    b = b ^ (a << U64(23))
    c = c - a - b
    c = c ^ (b >> U64(5))
    a = a - b - c
    a = a ^ (c >> U64(35))
    b = b - c - a
    b = b ^ (a << U64(49))
    c = c - a - b
    c = c ^ (b >> U64(11))
    a = a - b - c
    a = a ^ (c >> U64(12))
    b = b - c - a
    b = b ^ (a << U64(18))
    c = c - a - b
    c = c ^ (b >> U64(22))
    return a, b, c


def jenkins64(words: np.ndarray):
    """(N, W) uint64 little-endian key words -> (h0, h2) lanes of the
    jenkins64 triple (BooPHF.hpp:92-160). Key length = 8*W bytes, so the
    24-byte loop runs W//3 times and the tail switch adds the remaining
    words to lanes 0/1 and len to lane 2."""
    n, w = words.shape
    with np.errstate(over="ignore"):
        a = np.full(n, JENKINS_SEED)
        b = np.full(n, JENKINS_SEED)
        c = np.full(n, _GOLDEN)
        full = w // 3
        for i in range(full):
            a = a + words[:, 3 * i]
            b = b + words[:, 3 * i + 1]
            c = c + words[:, 3 * i + 2]
            a, b, c = _mix(a, b, c)
        c = c + U64(8 * w)            # get<2>(h) += len
        rem = w - 3 * full
        if rem >= 1:
            a = a + words[:, 3 * full]
        if rem == 2:
            b = b + words[:, 3 * full + 1]
        a, b, c = _mix(a, b, c)
    return a, c


def _xorshift_next(s0, s1):
    """xorshift128+ step (BooPHF.h:348-358): returns (new_s0, new_s1,
    hash)."""
    with np.errstate(over="ignore"):
        a = s0.copy()
        b = s1
        a ^= a << U64(23)
        new_s1 = a ^ b ^ (a >> U64(17)) ^ (b >> U64(26))
        return b, new_s1, new_s1 + b


class _HashChain:
    """Per-key level-hash sequence: h0, h1, next, next, ..."""

    def __init__(self, words: np.ndarray):
        self.h0, self.h1 = jenkins64(words)
        self.s0 = None
        self.s1 = None

    def level_hash(self, level: int):
        if level == 0:
            self.s0 = self.h0.copy()
            return self.h0
        if level == 1:
            self.s1 = self.h1.copy()
            return self.h1
        self.s0, self.s1, h = _xorshift_next(self.s0, self.s1)
        return h


def _popcount(x: np.ndarray) -> np.ndarray:
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x).astype(np.int64)
    x = x.copy()
    cnt = np.zeros(len(x), np.int64)
    for _ in range(64):
        cnt += (x & U64(1)).astype(np.int64)
        x >>= U64(1)
    return cnt


@dataclass
class _Level:
    size_bits: int
    words: np.ndarray        # (nchar,) uint64
    ranks: np.ndarray        # (nb,) uint64 — cumulative across levels
    prefix: np.ndarray       # (nchar + 1,) int64 popcount prefix (local)


class RefBooPHF:
    """Query + (de)serialization of the reference BooPHF format."""

    def __init__(self, gamma: float, nelem: int, lastbitsetrank: int,
                 levels: list, final_keys: np.ndarray,
                 final_vals: np.ndarray, width: int):
        self.gamma = gamma
        self.nelem = nelem
        self.lastbitsetrank = lastbitsetrank
        self.levels = levels
        self.width = width             # key width in u64 words
        # sorted final-hash arrays for vectorized lookup
        order = np.lexsort(tuple(final_keys[:, j]
                                 for j in range(width - 1, -1, -1))) \
            if len(final_keys) else np.zeros(0, np.int64)
        self._fkeys = final_keys[order] if len(final_keys) else final_keys
        self._fvals = final_vals[order] if len(final_vals) else final_vals

    # ------------------------------------------------------------------
    @classmethod
    def from_bytes(cls, data: bytes, width: int) -> "RefBooPHF":
        off = 0
        gamma, = struct.unpack_from("<d", data, off)
        off += 8
        nb_levels, = struct.unpack_from("<i", data, off)
        off += 4
        lastbitsetrank, nelem = struct.unpack_from("<QQ", data, off)
        off += 16
        levels = []
        for _ in range(nb_levels):
            size_bits, nchar = struct.unpack_from("<QQ", data, off)
            off += 16
            words = np.frombuffer(data, U64, int(nchar), off).copy()
            off += 8 * int(nchar)
            nrk, = struct.unpack_from("<Q", data, off)
            off += 8
            ranks = np.frombuffer(data, U64, int(nrk), off).copy()
            off += 8 * int(nrk)
            prefix = np.zeros(int(nchar) + 1, np.int64)
            prefix[1:] = np.cumsum(_popcount(words))
            levels.append(_Level(int(size_bits), words, ranks, prefix))
        fsize, = struct.unpack_from("<Q", data, off)
        off += 8
        fkeys = np.zeros((int(fsize), width), U64)
        fvals = np.zeros(int(fsize), U64)
        for i in range(int(fsize)):
            fkeys[i] = np.frombuffer(data, U64, width, off)
            off += 8 * width
            fvals[i], = struct.unpack_from("<Q", data, off)
            off += 8
        return cls(gamma, int(nelem), int(lastbitsetrank), levels,
                   fkeys, fvals, width)

    def to_bytes(self) -> bytes:
        out = bytearray()
        out += struct.pack("<d", self.gamma)
        out += struct.pack("<i", len(self.levels))
        out += struct.pack("<QQ", self.lastbitsetrank, self.nelem)
        for lv in self.levels:
            out += struct.pack("<QQ", lv.size_bits, len(lv.words))
            out += lv.words.tobytes()
            out += struct.pack("<Q", len(lv.ranks))
            out += lv.ranks.tobytes()
        out += struct.pack("<Q", len(self._fkeys))
        for i in range(len(self._fkeys)):
            out += self._fkeys[i].tobytes()
            out += struct.pack("<Q", int(self._fvals[i]))
        return bytes(out)

    # ------------------------------------------------------------------
    def lookup(self, words: np.ndarray) -> np.ndarray:
        """(N, W) uint64 keys -> (N,) int64 mphf codes; -1 if the key was
        not in the built set AND falls through to the final map (absent
        keys that hit a level bit alias a valid code, as in the
        reference — mphf contract)."""
        n = len(words)
        out = np.full(n, -1, np.int64)
        if n == 0 or self.nelem == 0:
            return out
        chain = _HashChain(words)
        active = np.ones(n, bool)
        idx = np.arange(n)
        for ii in range(len(self.levels) - 1):
            lv = self.levels[ii]
            h = chain.level_hash(ii)
            if not active.any():
                # keep advancing the chain state? not needed: once no
                # actives remain, later levels are unreachable
                break
            pos = h % U64(max(lv.size_bits, 1))
            wi = (pos >> U64(6)).astype(np.int64)
            bit = (lv.words[wi] >> (pos & U64(63))) & U64(1)
            hit = active & (bit == 1)
            if hit.any():
                p = pos[hit].astype(np.int64)
                wih = wi[hit]
                block = p // _RANK_SAMPLE
                base = lv.ranks[block].astype(np.int64)
                # popcount of words between the sample and the position
                start_w = block * (_RANK_SAMPLE // 64)
                mid = lv.prefix[wih] - lv.prefix[start_w]
                mask = (U64(1) << (pos[hit] & U64(63))) - U64(1)
                last = _popcount(lv.words[wih] & mask)
                out[idx[hit]] = base + mid + last
                active &= ~hit
        # leftovers: the exact final map
        rem = np.nonzero(active)[0]
        if len(rem) and len(self._fkeys):
            q = words[rem]
            pos = np.searchsorted(
                self._view1d(self._fkeys), self._as_void(q))
            pos = np.minimum(pos, len(self._fkeys) - 1)
            eq = (self._fkeys[pos] == q).all(axis=1)
            out[rem[eq]] = self._fvals[pos[eq]].astype(np.int64) \
                + self.lastbitsetrank
        return out

    @staticmethod
    def _as_void(arr):
        a = np.ascontiguousarray(arr)
        return a.view([("", a.dtype)] * a.shape[1]).ravel()

    @classmethod
    def _view1d(cls, arr):
        return cls._as_void(arr)

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, words: np.ndarray, gamma: float = 3.0) -> "RefBooPHF":
        """Deterministic single-threaded construction, byte-compatible
        with boomphf::mphf(n, keys, 1, gamma) for the same key order
        (BooPHF.h:740-784 + processLevel:860-930)."""
        n, w = words.shape
        if n == 0:
            return cls(gamma, 0, 0, [], np.zeros((0, w), U64),
                       np.zeros(0, U64), w)
        hash_domain = int(math.ceil(float(n) * gamma))
        proba = 1.0 - math.pow((gamma * n - 1.0) / (gamma * n), n - 1)
        domains = []
        for ii in range(NB_LEVELS):
            d = ((int(hash_domain * math.pow(proba, ii)) + 63) // 64) * 64
            domains.append(d if d else 64)

        chain = _HashChain(words)
        active = np.ones(n, bool)
        levels = []
        offset = 0
        for ii in range(NB_LEVELS):
            dom = domains[ii]
            nchar = dom // 64 + 1    # bitVector: _nchar = 1 + n/64 — one
            lv_words = np.zeros(nchar, U64)  # trailing zero guard word
            # the LAST level's bit array stays empty: keys reaching it go
            # straight to the final map (processLevel, BooPHF.h:895-905)
            if ii < NB_LEVELS - 1:
                h = chain.level_hash(ii)
                if active.any():
                    pos = (h[active] % U64(dom)).astype(np.int64)
                    cnt = np.bincount(pos, minlength=dom)
                    placed_bit = cnt == 1       # collisions cleared
                    keep = placed_bit[pos]      # keys placed at this level
                    bits = np.nonzero(placed_bit)[0]
                    # set bits via two exact float64 bincounts (distinct
                    # powers of two per 32-bit half sum exactly) — the
                    # bitwise_or.at scatter is one of numpy's slowest ops
                    wi2 = bits // 64
                    bi = bits % 64
                    lo = bi < 32
                    w_lo = np.bincount(
                        wi2[lo], weights=(1 << bi[lo]).astype(np.float64),
                        minlength=nchar)
                    w_hi = np.bincount(
                        wi2[~lo],
                        weights=(1 << (bi[~lo] - 32)).astype(np.float64),
                        minlength=nchar)
                    lv_words = (w_hi.astype(U64) << U64(32)) \
                        | w_lo.astype(U64)
                    act_idx = np.nonzero(active)[0]
                    active[act_idx[keep]] = False
            # ranks: cumulative across levels, sampled every 512 bits
            # (= every 8th word), value = set bits before that word
            pc = _popcount(lv_words)
            excl = np.zeros(nchar, np.int64)
            excl[1:] = np.cumsum(pc)[:-1]
            ranks = (offset + excl[0:nchar:8]).astype(U64)
            offset += int(pc.sum())
            prefix = np.zeros(nchar + 1, np.int64)
            prefix[1:] = np.cumsum(pc)
            levels.append(_Level(dom, lv_words, ranks, prefix))

        rem = np.nonzero(active)[0]             # arrival order = key order
        fkeys = words[rem].astype(U64)
        fvals = np.arange(len(rem), dtype=U64)
        return cls(gamma, n, offset, levels, fkeys, fvals, w)


def ref_key_words(k: int) -> int:
    """Key width in u64 words of the reference's Kmer<span>::Type for
    kmer size k: the span classes are 32/64/96/128 and require k < span
    (Model.hpp:401 throws on sizeKmer >= span), so span = the smallest
    class STRICTLY above k and sizeof = 8 * ((span+31)/32 words / ...)
    = 8 * (k // 32 + 1) bytes. For odd k this equals ceil(2k/64); for
    k = 32/64/96 (even multiples of 32) it is one word MORE than our
    limb count implies — sizing by limbs alone misparses the stream."""
    return k // 32 + 1


def limbs_to_words64(limbs: np.ndarray, k: int) -> np.ndarray:
    """(N, W32) big-endian uint32 limb rows -> (N, W64) little-endian
    uint64 key words, exactly the in-memory LargeInt layout the
    reference hashes (low word first), W64 = ref_key_words(k)."""
    n, w32 = limbs.shape
    w64 = ref_key_words(k)
    out = np.zeros((n, w64), U64)
    for j in range(w32):
        word_idx = (w32 - 1 - j) // 2
        shift = U64(32 * ((w32 - 1 - j) % 2))
        out[:, word_idx] |= limbs[:, j].astype(U64) << shift
    return out

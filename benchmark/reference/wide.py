"""k-mers of 1 <= k <= 63 as exact pairs of int64 words: their count,
neighbours and ranks.

The wide twin of ``kmers.py``, for the configurations whose k passes 31.
A k-mer is the integer v of its 2k bits, first base highest (codes A=0,
C=1, T=2, G=3); its canonical form is the smaller of it and its reverse
complement. v < 2^126 is held as a key, the last axis of an int64 tensor
of size 2: [v >> 63, v & (2^63 - 1)]. Both words are non-negative, so
keys order lexicographically exactly as the k-mers do, and no k-mer is
truncated or hashed. Plain torch, so that the same code runs on the card
at the cells' sizes and on the CPU in the tests.
"""

from __future__ import annotations

import numpy as np
import torch

I64 = torch.int64
BITS = 63                     # bits of each word of a key
M63 = (1 << BITS) - 1
CHUNK = 1 << 22               # nodes or queries per call of the sweeps


def check_k(k: int) -> None:
    if not 1 <= k <= 63:
        raise ValueError(f"the wide reference holds 1 <= k <= 63, got {k}")


def key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.stack([hi, lo], dim=-1)


def _shl2(hi, lo):
    """v << 2 (the caller trims to 2k bits)."""
    return (hi << 2) | (lo >> (BITS - 2)), (lo << 2) & M63


def _shr2(hi, lo):
    return hi >> 2, (lo >> 2) | ((hi & 3) << (BITS - 2))


def _trim(hi, lo, k: int):
    """v mod 2^2k."""
    if 2 * k <= BITS:
        return torch.zeros_like(hi), lo & ((1 << (2 * k)) - 1)
    return hi & ((1 << (2 * k - BITS)) - 1), lo


def _put(hi, lo, c, p: int):
    """v | c << p for 2-bit codes c at the even bit p; the bits of c may
    straddle the two words (p = 62)."""
    if p < BITS:
        lo = lo | ((c << p) & M63)
    if p + 2 > BITS:
        hi = hi | (c >> (BITS - p) if p <= BITS else c << (p - BITS))
    return hi, lo


def _base(hi, lo, p: int):
    """The 2-bit code at the even bit p."""
    if p + 2 <= BITS:
        return (lo >> p) & 3
    if p >= BITS:
        return (hi >> (p - BITS)) & 3
    return ((lo >> p) & 1) | ((hi & 1) << 1)


def less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b, key by key."""
    return (a[..., 0] < b[..., 0]) | ((a[..., 0] == b[..., 0])
                                      & (a[..., 1] < b[..., 1]))


def equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] == b[..., 0]) & (a[..., 1] == b[..., 1])


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(less(b, a)[..., None], b, a)


def canonical_values(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(n, L - k + 1, 2) canonical keys of the k-mers of reads of codes."""
    check_k(k)
    n, length = codes.shape
    p = length - k + 1
    c = codes.to(I64)
    fh = torch.zeros((n, p), dtype=I64, device=codes.device)
    fl, rh, rl = (torch.zeros_like(fh) for _ in range(3))
    for t in range(k):
        win = c[:, t:t + p]
        fh, fl = _shl2(fh, fl)
        fl = fl | win
        rh, rl = _put(rh, rl, win ^ 2, 2 * t)
    return minimum(key(fh, fl), key(rh, rl))


def argsort(keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts (N, 2) keys ascending: by the low word,
    then stably by the high word."""
    order = torch.argsort(keys[:, 1], stable=True)
    return order[torch.argsort(keys[order, 0], stable=True)]


def unique(keys: torch.Tensor):
    """(distinct keys, ascending; how often each occurs) of (N, 2) keys."""
    s = keys[argsort(keys)]
    n = s.shape[0]
    if n == 0:
        return s, torch.zeros((0,), dtype=I64, device=keys.device)
    new = torch.ones((n,), dtype=torch.bool, device=keys.device)
    new[1:] = ~equal(s[1:], s[:-1])
    start = torch.nonzero(new).squeeze(1)
    ends = torch.cat([start[1:], torch.tensor([n], device=keys.device)])
    return s[start], ends - start


def count(blocks, k: int):
    """(distinct canonical keys, ascending; their counts; windows) over an
    iterable of (n, L) code blocks."""
    vals = []
    for block in blocks:
        vals.append(canonical_values(block, k).reshape(-1, 2))
    allv = torch.cat(vals)
    del vals
    windows = allv.shape[0]
    uniq, counts = unique(allv)
    return uniq, counts, windows


def revcomp(v: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of keys, base by base."""
    hi, lo = v[..., 0], v[..., 1]
    oh, ol = torch.zeros_like(hi), torch.zeros_like(lo)
    for t in range(k):
        oh, ol = _shl2(oh, ol)
        ol = ol | (_base(hi, lo, 2 * t) ^ 2)
    return key(oh, ol)


def canonical(v: torch.Tensor, k: int) -> torch.Tensor:
    return minimum(v, revcomp(v, k))


def successors(v: torch.Tensor, k: int) -> list[torch.Tensor]:
    """The 4 oriented successors of oriented k-mers, by nucleotide."""
    hi, lo = _trim(*_shl2(v[..., 0], v[..., 1]), k)
    return [key(hi, lo | nt) for nt in range(4)]


def predecessors(v: torch.Tensor, k: int) -> list[torch.Tensor]:
    hi, lo = _shr2(v[..., 0], v[..., 1])
    return [key(*_put(hi, lo, torch.full_like(lo, nt), 2 * k - 2))
            for nt in range(4)]


def neighbor_candidates(nodes: torch.Tensor, k: int) -> torch.Tensor:
    """(N, 8, 2) canonical neighbour candidates of canonical nodes: 0-3 out
    by nucleotide, 4-7 in (GATB's Graph::getItems order)."""
    cands = successors(nodes, k) + predecessors(nodes, k)
    return torch.stack([canonical(c, k) for c in cands], dim=1)


def rank(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Index of each query key in the ascending (N, 2) table, -1 where
    absent: a lower-bound binary search, one step a bit of N."""
    shape = q.shape[:-1]
    q = q.reshape(-1, 2)
    n = table.shape[0]
    if n == 0:
        return torch.full(shape, -1, dtype=I64, device=q.device)
    lo = torch.zeros((q.shape[0],), dtype=I64, device=q.device)
    hi = torch.full_like(lo, n)
    for _ in range(n.bit_length()):
        mid = (lo + hi) // 2
        live = lo < hi
        below = less(table[mid.clamp(max=n - 1)], q)
        lo, hi = (torch.where(live & below, mid + 1, lo),
                  torch.where(live & ~below, mid, hi))
    hit = equal(table[lo.clamp(max=n - 1)], q) & (lo < n)
    return torch.where(hit, lo, torch.full_like(lo, -1)).reshape(shape)


def masks(table: torch.Tensor, nodes: torch.Tensor, k: int,
          member=None) -> torch.Tensor:
    """(N,) uint8 adjacency masks of nodes in the graph of ``table``: bit
    i set where candidate i is a node. ``member(table, q)`` -> bool, by
    default exact membership."""
    member = member or (lambda t, q: rank(t, q) >= 0)
    n = nodes.shape[0]
    out = torch.empty((n,), dtype=torch.uint8, device=nodes.device)
    weights = 1 << torch.arange(8, device=nodes.device)
    for s in range(0, n, CHUNK):
        c = neighbor_candidates(nodes[s:s + CHUNK], k)
        found = member(table, c.reshape(-1, 2)).reshape(c.shape[:-1])
        out[s:s + CHUNK] = (found.to(I64) * weights).sum(1).to(torch.uint8)
    return out


_U32 = np.uint64(0xFFFFFFFF)


def limbs_to_keys(limbs: np.ndarray) -> np.ndarray:
    """(N, W) uint32 limb rows (W <= 4, the program's node rows, first limb
    highest, the value in the low bits) -> (N, 2) int64 keys. A row with a
    bit set at 126 or above, which no k <= 63 has, becomes the key
    (-1, -1), which no k-mer is."""
    a = np.asarray(limbs, np.uint32)
    a = a.reshape(len(a), -1).astype(np.uint64)
    w = a.shape[1]
    if w > 4:
        raise ValueError(f"the wide reference reads at most 4 limbs, got {w}")
    a = np.concatenate([np.zeros((len(a), 4 - w), np.uint64), a], axis=1)
    top = (a[:, 0] << np.uint64(32)) | a[:, 1]
    bot = (a[:, 2] << np.uint64(32)) | a[:, 3]
    hi = (top << np.uint64(1)) | (bot >> np.uint64(BITS))
    lo = bot & np.uint64(M63)
    out = np.stack([hi, lo], axis=1).astype(np.int64)
    out[(top >> np.uint64(62)) != 0] = -1
    return out


def keys_to_limbs(keys: np.ndarray, k: int) -> np.ndarray:
    """(N, 2) int64 keys -> (N, W) uint32 limb rows, W = ceil(2k / 32)."""
    v = np.asarray(keys, np.int64).reshape(-1, 2).astype(np.uint64)
    top = v[:, 0] >> np.uint64(1)
    bot = v[:, 1] | ((v[:, 0] & np.uint64(1)) << np.uint64(BITS))
    four = np.stack([top >> np.uint64(32), top & _U32, bot >> np.uint64(32),
                     bot & _U32], axis=1).astype(np.uint32)
    return np.ascontiguousarray(four[:, 4 - (2 * k + 31) // 32:])


def sym_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Size of the symmetric difference of two ascending unique (N, 2)
    key arrays."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return int(a.shape[0] + b.shape[0])
    common = int((rank(b, a) >= 0).sum())
    return int(a.shape[0] + b.shape[0] - 2 * common)

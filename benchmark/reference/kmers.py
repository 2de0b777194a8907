"""k-mers as int64 values, their count, neighbours and ranks (k <= 31).

Frozen from ``chip_smoke.py``'s numpy truths (``truth_k31``,
``revcomp_u64``, ``neighbors_u64``, ``member_u64``, ``masks_of``),
written in plain torch so that the same code runs on the card at the
cells' sizes and on the CPU in the tests. A k-mer is the integer whose
2k bits are its bases, first base highest (codes A=0, C=1, T=2, G=3);
its canonical form is the smaller of it and its reverse complement. A
config with k > 31 needs a wider reference than this one.
"""

from __future__ import annotations

import numpy as np
import torch

I64 = torch.int64
CHUNK = 1 << 22               # nodes or queries per call of the sweeps


def check_k(k: int) -> None:
    if not 1 <= k <= 31:
        raise ValueError(f"the int64 reference holds 1 <= k <= 31, got {k}")


def canonical_values(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(n, L - k + 1) canonical values of the k-mers of reads of codes."""
    check_k(k)
    n, length = codes.shape
    p = length - k + 1
    c = codes.to(I64)
    fwd = torch.zeros((n, p), dtype=I64, device=codes.device)
    rev = torch.zeros_like(fwd)
    for t in range(k):
        win = c[:, t:t + p]
        fwd = (fwd << 2) | win
        rev |= (win ^ 2) << (2 * t)
    return torch.minimum(fwd, rev)


def count(blocks, k: int):
    """(distinct canonical values, ascending; their counts; windows) over
    an iterable of (n, L) code blocks."""
    vals = []
    windows = 0
    for block in blocks:
        v = canonical_values(block, k).reshape(-1)
        windows += v.numel()
        vals.append(v)
    allv = torch.cat(vals)
    del vals
    uniq, counts = torch.unique(allv, sorted=True, return_counts=True)
    return uniq, counts, windows


def revcomp(v: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of k-mer values, base by base."""
    out = torch.zeros_like(v)
    for t in range(k):
        out = (out << 2) | (((v >> (2 * t)) & 3) ^ 2)
    return out


def canonical(v: torch.Tensor, k: int) -> torch.Tensor:
    return torch.minimum(v, revcomp(v, k))


def successors(v: torch.Tensor, k: int) -> list[torch.Tensor]:
    """The 4 oriented successors of oriented k-mers, by nucleotide."""
    mask = (1 << (2 * k)) - 1
    return [((v << 2) | nt) & mask for nt in range(4)]


def predecessors(v: torch.Tensor, k: int) -> list[torch.Tensor]:
    return [(v >> 2) | (nt << (2 * k - 2)) for nt in range(4)]


def neighbor_candidates(nodes: torch.Tensor, k: int) -> torch.Tensor:
    """(N, 8) canonical neighbour candidates of canonical nodes: 0-3 out
    by nucleotide, 4-7 in (GATB's Graph::getItems order)."""
    cands = successors(nodes, k) + predecessors(nodes, k)
    return torch.stack([canonical(c, k) for c in cands], dim=1)


def rank(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Index of each query in the ascending table, -1 where absent."""
    if table.numel() == 0:
        return torch.full_like(q, -1)
    pos = torch.searchsorted(table, q)
    hit = table[pos.clamp(max=table.numel() - 1)] == q
    return torch.where(hit, pos, torch.full_like(pos, -1))


def masks(table: torch.Tensor, nodes: torch.Tensor, k: int,
          member=None) -> torch.Tensor:
    """(N,) uint8 adjacency masks of nodes in the graph of ``table``: bit
    i set where candidate i is a node. ``member(table, q)`` -> bool, by
    default exact membership."""
    member = member or (lambda t, q: rank(t, q) >= 0)
    out = torch.empty(nodes.shape, dtype=torch.uint8, device=nodes.device)
    weights = 1 << torch.arange(8, device=nodes.device)
    for s in range(0, nodes.numel(), CHUNK):
        c = neighbor_candidates(nodes[s:s + CHUNK], k)
        found = member(table, c.reshape(-1)).reshape(c.shape)
        out[s:s + CHUNK] = (found.to(I64) * weights).sum(1).to(torch.uint8)
    return out


def popcount4(m: torch.Tensor) -> torch.Tensor:
    m = m.to(I64) & 15
    return (m & 1) + ((m >> 1) & 1) + ((m >> 2) & 1) + ((m >> 3) & 1)


def limbs_to_values(limbs: np.ndarray) -> np.ndarray:
    """(N, W) uint32 limb rows (W <= 2, the program's node rows, first limb
    highest) -> int64 values."""
    a = np.asarray(limbs, np.uint32)
    a = a.reshape(len(a), -1).astype(np.int64)
    out = a[:, -1].copy()
    if a.shape[1] == 2:
        out |= a[:, 0] << 32
    return out


def values_to_limbs(values: np.ndarray, k: int) -> np.ndarray:
    """int64 values -> (N, W) uint32 limb rows, W = 1 for k <= 16, else 2."""
    v = np.asarray(values, np.int64).astype(np.uint64)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if k <= 16:
        return lo[:, None]
    return np.stack([(v >> np.uint64(32)).astype(np.uint32), lo], axis=1)


def sym_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Size of the symmetric difference of two ascending unique arrays."""
    if a.numel() == 0 or b.numel() == 0:
        return int(a.numel() + b.numel())
    common = int((rank(b, a) >= 0).sum())
    return int(a.numel() + b.numel() - 2 * common)

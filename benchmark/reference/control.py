"""The controls: the reference put in the program's place with 32-bit
keys where the configuration states exact 62-bit k-mers.

The configurations state exact k-mers (GATB's counts, graph and node
index are exact). The step below that, the one that would tempt a later
change to save memory or bandwidth, is a 32-bit fingerprint of each
k-mer in place of the k-mer: counts of k-mers whose fingerprints
collide merge, and a query whose fingerprint matches a node's is taken
for that node. ``benchmark/control.py`` runs these on the card at the
cells' sizes, and the tests at a small size, and each must come out not
correct.
"""

from __future__ import annotations

import torch

from . import kmers as K

I64 = torch.int64
_GOLDEN = -7046029254386353131      # 0x9E3779B97F4A7C15 as a signed int64


def fingerprint(v: torch.Tensor) -> torch.Tensor:
    """The top 32 bits of a multiplicative hash of each value."""
    return ((v * _GOLDEN) >> 32) & 0xFFFFFFFF


def count_fp(blocks, k: int):
    """``kmers.count`` with the k-mers keyed by fingerprint: every distinct
    k-mer gets the count of its fingerprint."""
    vals = [K.canonical_values(b, k).reshape(-1) for b in blocks]
    allv = torch.cat(vals)
    del vals
    windows = allv.numel()
    fp_u, fp_c = torch.unique(fingerprint(allv), sorted=True,
                              return_counts=True)
    distinct = torch.unique(allv, sorted=True)
    del allv
    counts = fp_c[torch.searchsorted(fp_u, fingerprint(distinct))]
    return distinct, counts, windows


class FingerprintIndex:
    """Membership and rank of queries by fingerprint over an exact,
    ascending node table."""

    def __init__(self, nodes: torch.Tensor):
        fp = fingerprint(nodes)
        self.fp, order = torch.sort(fp, stable=True)
        self.rank_of = order

    def rank(self, q: torch.Tensor) -> torch.Tensor:
        fq = fingerprint(q)
        if self.fp.numel() == 0:
            return torch.full_like(q, -1)
        pos = torch.searchsorted(self.fp, fq)
        p = pos.clamp(max=self.fp.numel() - 1)
        hit = self.fp[p] == fq
        return torch.where(hit, self.rank_of[p], torch.full_like(q, -1))

    def member(self, table, q: torch.Tensor) -> torch.Tensor:
        return self.rank(q) >= 0

    def masks(self, nodes: torch.Tensor, k: int) -> torch.Tensor:
        return K.masks(nodes, nodes, k, self.member)

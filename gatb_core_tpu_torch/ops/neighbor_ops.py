"""Neighbor-candidate ops: batched de Bruijn adjacency for limb k-mers.

Port of gatb_core_tpu/ops/neighbor_ops.py. Reference semantics
(debruijn/impl/Graph.cpp getItems_visitor:1168-1390): for a node with
forward strand value f (and revcomp r), the 8 neighbor candidates are
    out(nt):  canonical( ((f<<2)|nt) & mask ,  (r>>2) | rc(nt)<<2(k-1) )
    in(nt):   canonical( (f>>2) | nt<<2(k-1) , ((r<<2)|rc(nt)) & mask  )
membership of each candidate in the graph gives the 8-bit adjacency mask
(4 out bits then 4 in bits, like precomputeAdjacency, Graph.cpp:3508-3610).

All ops are vectorized over (N, W) big-endian limb arrays. As in
ops/kmer_ops.py limbs are int64 tensors holding zero-extended uint32 values
(int32 storage is read as raw 32-bit patterns), so every left shift is cut
back to 32 bits; results are int64.
"""

from __future__ import annotations

import torch

from .bitpack import M32, as_u32_i64
from .kmer_ops import lex_lt, revcomp_limbs_, top_mask

# one body, two names: the JAX package keeps this function here, the port's
# extraction needs it too and holds it in kmer_ops
revcomp_limbs = revcomp_limbs_


def _code(c, like: torch.Tensor) -> torch.Tensor:
    """(N,) nucleotide codes as int64 on the limbs' device; a Python int
    stands for the same code in every row."""
    if isinstance(c, torch.Tensor):
        return c.to(torch.int64)
    return torch.full(like.shape[:-1], int(c), dtype=torch.int64,
                      device=like.device)


def shl2_or(limbs: torch.Tensor, c, k: int) -> torch.Tensor:
    """((v << 2) | c) & mask for (N, W) limbs, c: (N,) codes."""
    x = as_u32_i64(limbs)
    out = (x << 2) & M32
    out[..., :-1] |= x[..., 1:] >> 30
    out[..., -1] |= _code(c, x)
    out[..., 0] &= top_mask(k)
    return out


def shr2_or_top(limbs: torch.Tensor, c, k: int) -> torch.Tensor:
    """(v >> 2) | c << 2(k-1) for (N, W) limbs."""
    x = as_u32_i64(limbs)
    w = x.shape[-1]
    out = x >> 2
    out[..., 1:] |= (x[..., :-1] << 30) & M32
    bitpos = 2 * k - 2
    jins = w - 1 - bitpos // 32
    out[..., jins] |= _code(c, x) << (bitpos % 32)
    return out


def canonical_limbs(fwd: torch.Tensor, rev: torch.Tensor) -> torch.Tensor:
    return torch.where(lex_lt(fwd, rev)[..., None], fwd, rev)


def neighbor_candidates(nodes: torch.Tensor, k: int) -> torch.Tensor:
    """All 8 canonical neighbor candidates of each node.

    nodes: (N, W) canonical k-mer limbs.
    Returns (N, 8, W) int64: [:, 0:4] out-neighbors by nt, [:, 4:8]
    in-neighbors.
    """
    f = as_u32_i64(nodes)
    r = revcomp_limbs(f, k)
    n, w = f.shape
    cands = torch.empty((n, 8, w), dtype=torch.int64, device=f.device)
    for nt in range(4):
        cands[:, nt] = canonical_limbs(shl2_or(f, nt, k),
                                       shr2_or_top(r, nt ^ 2, k))
        cands[:, 4 + nt] = canonical_limbs(shr2_or_top(f, nt, k),
                                           shl2_or(r, nt ^ 2, k))
    return cands


def extend_right(nodes_fwd: torch.Tensor, nt: torch.Tensor, k: int,
                 nodes_rev: torch.Tensor | None = None):
    """(fwd, rev) of the right-extension of a strand-oriented k-mer."""
    if nodes_rev is None:
        nodes_rev = revcomp_limbs(as_u32_i64(nodes_fwd), k)
    f = shl2_or(nodes_fwd, nt, k)
    r = shr2_or_top(nodes_rev, _code(nt, f) ^ 2, k)
    return f, r

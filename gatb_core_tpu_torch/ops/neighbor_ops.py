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

``neighbor_masks`` is the mask itself: on a CUDA tensor one launch of the
``neighbor_masks`` kernel (``csrc/rank_search.cu``), which builds each
candidate in registers, looks it up in the table and packs the 8 found
bits, with no candidate tensor; on a CPU tensor ``neighbor_masks_plain``,
the candidates, the rank search and the pack in torch ops. Callers that
need the candidates themselves keep ``neighbor_candidates``.
"""

from __future__ import annotations

import ctypes

import torch

from . import rank_search
from .bitpack import M32, as_u32_i64
from .kmer_ops import lex_lt, nb_limbs, revcomp_limbs_, top_mask

# kernel launches made through neighbor_masks (CUDA tensors only) and the
# distinct (W, k, table rows, live rows, nodes) they launched with
launches = {"neighbor_masks": 0}
launch_shapes: dict[str, set] = {"neighbor_masks": set()}
# the widest rows the kernel takes (k <= 128)
KERNEL_MAX_WIDTH = 8

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


def reset_launches() -> None:
    launches["neighbor_masks"] = 0
    launch_shapes["neighbor_masks"].clear()


def _check_masks(nodes: torch.Tensor, table: torch.Tensor, n_table: int,
                 k: int) -> None:
    rank_search._check_table(table, n_table)
    rank_search._check_rows("nodes", nodes)
    w = nodes.shape[1]
    if table.shape[1] != w:
        raise ValueError("neighbor_masks: nodes and table differ in width")
    if w != nb_limbs(k):
        raise ValueError(f"neighbor_masks: {w} limbs do not hold k = {k}")
    if table.device != nodes.device:
        raise ValueError("neighbor_masks: nodes and table on different "
                         "devices")


def neighbor_masks(nodes: torch.Tensor, table: torch.Tensor, n_table,
                   k: int, index=None) -> torch.Tensor:
    """8-bit adjacency mask of each node: bit j is set when candidate j of
    ``neighbor_candidates`` (0-3 out by nt, 4-7 in by nt) is one of the
    first ``n_table`` rows of the sorted table.

    nodes: (N, W) and table: (C, W) contiguous int32 storage, W the limbs
    of k; ``index``: the table's ``RankIndex`` where the caller holds one
    (a CUDA call builds a transient one at the widths the kernel walks).
    Returns (N,) uint8 on the nodes' device. A CUDA tensor launches the
    kernel on the current stream; a CPU tensor runs
    ``neighbor_masks_plain``; any other device raises."""
    n_table = int(n_table)
    _check_masks(nodes, table, n_table, k)
    if index is not None:
        rank_search.held_index(table, n_table, index)
    if nodes.device.type == "cpu":
        return neighbor_masks_plain(nodes, table, n_table, k, index)
    if not nodes.is_cuda:
        raise ValueError(f"neighbor_masks: unsupported device {nodes.device}")
    n, w = nodes.shape
    if w > KERNEL_MAX_WIDTH:
        raise ValueError(f"neighbor_masks: the kernel takes up to "
                         f"{KERNEL_MAX_WIDTH} limbs (k <= 128), got {w}")
    masks = torch.empty((n,), dtype=torch.uint8, device=nodes.device)
    if n == 0:
        return masks
    rows, offsets, lengths, count = rank_search.index_args(table, n_table,
                                                           index)
    table, nodes = rank_search.aligned(table), rank_search.aligned(nodes)
    with torch.cuda.device(nodes.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(nodes.device).cuda_stream)
        rc = rank_search._lib().neighbor_masks(
            nodes.data_ptr(), table.data_ptr(), rows.data_ptr(), offsets,
            lengths, count, masks.data_ptr(), n, n_table, w, k, stream)
    if rc != 0:
        raise RuntimeError(f"neighbor_masks: CUDA launch failed with error "
                           f"{rc}")
    launches["neighbor_masks"] += 1
    launch_shapes["neighbor_masks"].add((w, k, table.shape[0], n_table, n))
    return masks


def neighbor_masks_plain(nodes: torch.Tensor, table: torch.Tensor, n_table,
                         k: int, index=None) -> torch.Tensor:
    """Plain version of ``neighbor_masks`` on any device, torch ops only:
    the (N, 8, W) candidates, the rank search's plain walk of ``index``
    (its binary search without one) and a pack of the 8 found bits."""
    n_table = int(n_table)
    _check_masks(nodes, table, n_table, k)
    n, w = nodes.shape
    cands = rank_search.as_rows(neighbor_candidates(nodes, k)
                                .reshape(n * 8, w))
    if index is None:
        _, found = rank_search.rank_rows_plain(table, cands, n_table)
    else:
        rank_search.held_index(table, n_table, index)
        _, found = rank_search.rank_rows_indexed_plain(index, cands)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=found.device)
    return (found.reshape(n, 8).to(torch.int32) * weights[None, :]) \
        .sum(dim=1).to(torch.uint8)

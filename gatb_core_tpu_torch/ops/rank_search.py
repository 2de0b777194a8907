"""Rank of multi-limb rows in a sorted table: the ``rank_rows`` kernel.

Every postsolid sweep stands on one question: where does this row sit in
the sorted solid table, if at all? Adjacency asks it for 8 candidates per
node, the debloom probe for the same 8, ``Graph.node_index`` and
``contains`` for their queries. The JAX package answers with a sort-join
(gatb_core_tpu/ops/sortops.py:839, two sorts of table + queries and three
scans) or a gather loop (collections/sortedset.py:28); ``torch.searchsorted``
takes scalar keys, so rows of more than two limbs have no torch call at all.
Here it is one hand-written CUDA kernel, ``csrc/rank_search.cu``: each
thread walks a B+ index over the table (``RankIndex``) for its query, a
binary search inside each level's one 128-byte node, then one equality
test in the leaf block.

``RankIndex(table, n_table)`` is built once per table with torch ops
(strided slices) and counted in ``builds``; ``held_index`` is where a
sweep of many chunks gets the one it walks. ``rank_rows`` is the wrapper:
for a CUDA tensor it launches the kernel (building a transient index when
the caller holds none) and counts the launch in ``launches``; for a CPU
tensor it runs ``rank_rows_indexed_plain``, the same walk in torch ops,
when given an index and ``rank_rows_plain``, a binary search, when not;
any other device raises. Nothing falls back from the kernel to a plain
version, and nothing chooses between the index and another search.

Rows are (N, W) int32 tensors holding uint32 bit patterns, limb 0 most
significant, row-major (see the kernel's header note for why not planes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .bitpack import M32, as_u32_i64
from .kmer_ops import lex_eq, lex_lt

# kernel launches made through the wrapper (CUDA tensors only) and the
# distinct (W, table rows, live rows, queries) they launched with
launches = {"rank_rows": 0}
launch_shapes: dict[str, set] = {"rank_rows": set()}
# RankIndex builds, on any device (a sweep builds one for all its chunks)
builds = {"rank_index": 0}
# widths the kernel walks the index at; any other runs a binary search
KERNEL_WIDTHS = (1, 2, 3, 4, 8)


def reset_launches() -> None:
    launches["rank_rows"] = 0
    launch_shapes["rank_rows"].clear()
    builds["rank_index"] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at the first launch, never at import)."""
    from ._build import load_cuda

    lib = load_cuda("rank_search")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.rank_rows.argtypes = [vp, vp, vp, vp, i, vp, vp, vp, ll, ll, i, vp]
    lib.rank_rows.restype = ctypes.c_int
    # the neighbour masks of ops/neighbor_ops.py, in the same source
    lib.neighbor_masks.argtypes = [vp, vp, vp, vp, vp, i, vp, ll, ll, i, i,
                                   vp]
    lib.neighbor_masks.restype = ctypes.c_int
    return lib


def as_rows(x: torch.Tensor) -> torch.Tensor:
    """(N, W) limb rows in any integer dtype (int32 storage, or int64
    holding zero-extended uint32 values) -> contiguous int32 storage."""
    if x.dim() != 2:
        raise ValueError(f"limb rows must be (N, W), got {tuple(x.shape)}")
    return x.to(torch.int32).contiguous()


def _check_rows(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(f"rank_rows: {name} must be a contiguous (N, W) "
                        "int32 tensor")


def _check_table(table: torch.Tensor, n_table: int) -> None:
    _check_rows("table", table)
    if table.shape[1] < 1:
        raise ValueError("rank_rows: rows of no limb")
    if not 0 <= n_table <= table.shape[0]:
        raise ValueError(f"rank_rows: n_table {n_table} outside the table's "
                         f"{table.shape[0]} rows")
    if table.shape[0] >= 1 << 31:
        raise ValueError("rank_rows: ranks are int32")


def _check(table: torch.Tensor, queries: torch.Tensor, n_table: int) -> None:
    _check_table(table, n_table)
    _check_rows("queries", queries)
    if table.shape[1] != queries.shape[1]:
        raise ValueError("rank_rows: table and queries differ in width")
    if table.device != queries.device:
        raise ValueError("rank_rows: table and queries on different devices")


def node_rows(w: int) -> int:
    """Rows of a node (and of a leaf block) at ``w`` limbs: as many as one
    128-byte line holds, rounded down to a power of two, at least 2 (32 at
    1 limb, 16 at 2, 8 at 3 and 4, 4 at 5-8)."""
    b = max(2, 32 // w)
    return 1 << (b.bit_length() - 1)


class RankIndex:
    """A B+ index over the first ``n_table`` rows of a sorted distinct
    table, built once with torch ops (strided slices) on the table's
    device; about 1/(B - 1) of the table's bytes.

    Level 1 holds the last row of each block of B = ``node_rows(W)`` rows,
    level 2 the last key of each B keys of level 1, and so on up to a root
    of at most B keys. ``rows`` stacks the levels top first, each padded
    with all-ones keys to a multiple of B; level l holds ``lengths[l]``
    keys from row ``offsets[l]`` (``offsets[-1]``: the rows in all). The
    table's rows past ``n_table`` are never read. An index holds its
    table, which it answers for: ``rank_rows`` raises when given another."""

    def __init__(self, table: torch.Tensor, n_table: int):
        n_table = int(n_table)
        _check_table(table, n_table)
        self.table, self.n = table, n_table
        w = self.width = table.shape[1]
        b = self.node = node_rows(w)
        levels, prev, m = [], table, n_table
        while m:
            # the last row of each group of b: a strided slice, and the
            # last row where the group is short
            keys = prev[b - 1:m:b]
            if m % b:
                keys = torch.cat([keys, prev[m - 1:m]])
            levels.append(keys)
            if len(keys) <= b:
                break
            prev, m = keys, len(keys)
        parts, self.offsets, self.lengths = [], [0], []
        for keys in reversed(levels):
            pad = -len(keys) % b
            parts += [keys, table.new_full((pad, w), -1)]
            self.lengths.append(len(keys))
            self.offsets.append(self.offsets[-1] + len(keys) + pad)
        self.rows = torch.cat(parts) if parts else table.new_empty((0, w))
        self._c_levels = (
            (ctypes.c_longlong * len(self.offsets))(*self.offsets),
            (ctypes.c_longlong * max(1, len(self.lengths)))(*self.lengths))
        builds["rank_index"] += 1

    def answers(self, table: torch.Tensor, n_table: int) -> bool:
        """Whether this is the index of ``table``'s first n_table rows."""
        return (table.data_ptr() == self.table.data_ptr()
                and table.shape == self.table.shape
                and table.device == self.table.device
                and int(n_table) == self.n)


def held_index(table: torch.Tensor, n_table: int,
               index: RankIndex | None = None) -> RankIndex:
    """The index a sweep walks for all its chunks: ``index`` where the
    caller holds one (it must answer for ``table``'s first n_table rows),
    else one built here."""
    if index is None:
        return RankIndex(table, n_table)
    if not index.answers(table, n_table):
        raise ValueError("rank_rows: the index is another table's")
    return index


def index_args(table: torch.Tensor, n_table: int,
               index: RankIndex | None = None) -> tuple:
    """The index arguments of a kernel launch on ``table``: (index rows,
    level offsets, level lengths, level count) of the held or a transient
    ``RankIndex`` at the widths the kernels walk; the table and no level
    at any other, where the binary search reads no index."""
    if table.shape[1] not in KERNEL_WIDTHS:
        return table, None, None, 0
    index = held_index(table, n_table, index)
    return (index.rows, *index._c_levels, len(index.lengths))


def aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy where its storage is off 16-byte alignment: the
    kernels load rows as 8- and 16-byte vectors."""
    return x.clone() if x.data_ptr() % 16 else x


def rank_rows(table: torch.Tensor, queries: torch.Tensor, n_table: int,
              index: RankIndex | None = None):
    """Rank and membership of query rows in a sorted distinct-row table.

    table: (C, W) int32 storage, ascending as big-endian unsigned rows;
    rows >= n_table are padding and never looked at. queries: (Q, W), any
    order. ``index``: the table's ``RankIndex``, for callers that search
    one table many times (a transient one is built on a CUDA tensor when
    none is given). Returns (rank (Q,) int32: index in the table, -1 if
    absent; found (Q,) bool), in query order. The all-ones row is never
    found; ``n_table == 0`` finds nothing."""
    n_table = int(n_table)
    _check(table, queries, n_table)
    if index is not None:
        held_index(table, n_table, index)
    if queries.device.type == "cpu":
        if index is None:
            return rank_rows_plain(table, queries, n_table)
        return rank_rows_indexed_plain(index, queries)
    if not queries.is_cuda:
        raise ValueError(f"rank_rows: unsupported device {queries.device}")
    q, w = queries.shape
    rank = torch.empty((q,), dtype=torch.int32, device=queries.device)
    found = torch.empty((q,), dtype=torch.bool, device=queries.device)
    if q == 0:
        return rank, found
    rows, offsets, lengths, count = index_args(table, n_table, index)
    table, queries = aligned(table), aligned(queries)
    with torch.cuda.device(queries.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(queries.device).cuda_stream)
        rc = _lib().rank_rows(table.data_ptr(), rows.data_ptr(), offsets,
                              lengths, count, queries.data_ptr(),
                              rank.data_ptr(), found.data_ptr(), q, n_table,
                              w, stream)
    if rc != 0:
        raise RuntimeError(f"rank_rows: CUDA launch failed with error {rc}")
    launches["rank_rows"] += 1
    launch_shapes["rank_rows"].add((w, table.shape[0], n_table, q))
    return rank, found


def rank_rows_indexed_plain(index: RankIndex, queries: torch.Tensor):
    """Plain version of the kernel's walk, torch ops on any device: from
    the root, each level counts the keys of the query's node that lie
    below it (the kernel finds the count by a binary search) and moves to
    the child at that count, clamped to the level's last key; in the leaf
    block, rows at n_table and beyond are masked by position and the equal
    row, if any, is the rank. Queries go 2^16 at a time (the node gathers
    are (2^16, B, W))."""
    _check(index.table, queries, index.n)
    q, n, b = queries.shape[0], index.n, index.node
    rank = torch.full((q,), -1, dtype=torch.int32, device=queries.device)
    found = torch.zeros((q,), dtype=torch.bool, device=queries.device)
    if q == 0 or n == 0:
        return rank, found
    keys_all = as_u32_i64(index.rows)
    lane = torch.arange(b, device=queries.device)
    chunk = 1 << 16
    for lo in range(0, q, chunk):
        key = as_u32_i64(queries[lo:lo + chunk])[:, None, :]
        node = torch.zeros((key.shape[0],), dtype=torch.int64,
                           device=queries.device)
        for off, length in zip(index.offsets, index.lengths):
            below = lex_lt(keys_all[off + node[:, None] * b + lane], key)
            node = torch.clamp(node * b + below.sum(dim=1), max=length - 1)
        pos = node[:, None] * b + lane
        rows = as_u32_i64(index.table[torch.clamp(pos, max=n - 1)])
        eq = lex_eq(rows, key) & (pos < n) & ~(key == M32).all(dim=-1)
        hit = eq.any(dim=1)
        found[lo:lo + chunk] = hit
        rank[lo:lo + chunk] = torch.where(
            hit, (pos * eq).sum(dim=1), -1).to(torch.int32)
    return rank, found


def lower_bound_rows(table: torch.Tensor, queries: torch.Tensor,
                     n_table: int) -> torch.Tensor:
    """Lower-bound index of each query row among the first ``n_table`` rows
    of the sorted table: (Q,) int64 in [0, n_table]. The loop of the JAX
    ``_searchsorted_limbs`` (gather row ``mid``, compare, move ``lo`` or
    ``hi``), all queries at once, in torch ops on the tensors' device."""
    keys = as_u32_i64(queries)
    q = keys.shape[0]
    lo = torch.zeros((q,), dtype=torch.int64, device=keys.device)
    hi = torch.full((q,), n_table, dtype=torch.int64, device=keys.device)
    for _ in range(n_table.bit_length()):
        open_ = lo < hi
        mid = (lo + hi) >> 1
        # a search that has closed at lo == hi == n_table points one past
        # the table: read a safe row, the update below leaves it alone
        row = as_u32_i64(table[torch.clamp(mid, max=n_table - 1)])
        lt = lex_lt(row, keys)
        lo = torch.where(open_ & lt, mid + 1, lo)
        hi = torch.where(open_ & ~lt, mid, hi)
    return lo


def rank_rows_plain(table: torch.Tensor, queries: torch.Tensor,
                    n_table: int):
    """Plain version of ``rank_rows`` on any device, torch ops only: the
    lower bound of every query, then the equality test."""
    n_table = int(n_table)
    _check(table, queries, n_table)
    q = queries.shape[0]
    if q == 0 or n_table == 0:
        return (torch.full((q,), -1, dtype=torch.int32,
                           device=queries.device),
                torch.zeros((q,), dtype=torch.bool, device=queries.device))
    lo = lower_bound_rows(table, queries, n_table)
    row = table[torch.clamp(lo, max=n_table - 1)]
    found = lex_eq(row, queries) & (lo < n_table) \
        & ~(queries == -1).all(dim=-1)
    rank = torch.where(found, lo, torch.full_like(lo, -1)).to(torch.int32)
    return rank, found

"""Rank of multi-limb rows in a sorted table: the ``rank_rows`` kernel.

Every postsolid sweep stands on one question: where does this row sit in
the sorted solid table, if at all? Adjacency asks it for 8 candidates per
node, the debloom probe for the same 8, ``Graph.node_index`` and
``contains`` for their queries. The JAX package answers with a sort-join
(gatb_core_tpu/ops/sortops.py:839, two sorts of table + queries and three
scans) or a gather loop (collections/sortedset.py:28); ``torch.searchsorted``
takes scalar keys, so rows of more than two limbs have no torch call at all.
Here it is one hand-written CUDA kernel, ``csrc/rank_search.cu``: one thread
per query, a lower-bound binary search over row-major rows, one equality
test.

``rank_rows`` is the wrapper: for a CUDA tensor it launches the kernel and
counts the launch in ``launches``; for a CPU tensor it runs
``rank_rows_plain``, the same search in torch ops; any other device raises.
Nothing falls back from the kernel to the plain version.

Rows are (N, W) int32 tensors holding uint32 bit patterns, limb 0 most
significant, row-major (see the kernel's header note for why not planes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .bitpack import as_u32_i64
from .kmer_ops import lex_eq, lex_lt

# kernel launches made through the wrapper (CUDA tensors only) and the
# distinct (W, table rows, live rows, queries) they launched with
launches = {"rank_rows": 0}
launch_shapes: dict[str, set] = {"rank_rows": set()}


def reset_launches() -> None:
    launches["rank_rows"] = 0
    launch_shapes["rank_rows"].clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at the first launch, never at import)."""
    from ._build import load_cuda

    lib = load_cuda("rank_search")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.rank_rows.argtypes = [vp, vp, vp, vp, ll, ll, ctypes.c_int, vp]
    lib.rank_rows.restype = ctypes.c_int
    return lib


def as_rows(x: torch.Tensor) -> torch.Tensor:
    """(N, W) limb rows in any integer dtype (int32 storage, or int64
    holding zero-extended uint32 values) -> contiguous int32 storage."""
    if x.dim() != 2:
        raise ValueError(f"limb rows must be (N, W), got {tuple(x.shape)}")
    return x.to(torch.int32).contiguous()


def _check(table: torch.Tensor, queries: torch.Tensor, n_table: int) -> None:
    for name, x in (("table", table), ("queries", queries)):
        if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
            raise TypeError(f"rank_rows: {name} must be a contiguous (N, W) "
                            "int32 tensor")
    if table.shape[1] != queries.shape[1] or table.shape[1] < 1:
        raise ValueError("rank_rows: table and queries differ in width")
    if table.device != queries.device:
        raise ValueError("rank_rows: table and queries on different devices")
    if not 0 <= n_table <= table.shape[0]:
        raise ValueError(f"rank_rows: n_table {n_table} outside the table's "
                         f"{table.shape[0]} rows")
    if table.shape[0] >= 1 << 31:
        raise ValueError("rank_rows: ranks are int32")


def rank_rows(table: torch.Tensor, queries: torch.Tensor, n_table: int):
    """Rank and membership of query rows in a sorted distinct-row table.

    table: (C, W) int32 storage, ascending as big-endian unsigned rows;
    rows >= n_table are padding and never looked at. queries: (Q, W), any
    order. Returns (rank (Q,) int32: index in the table, -1 if absent;
    found (Q,) bool), in query order. The all-ones row is never found;
    ``n_table == 0`` finds nothing."""
    n_table = int(n_table)
    _check(table, queries, n_table)
    if queries.device.type == "cpu":
        return rank_rows_plain(table, queries, n_table)
    if not queries.is_cuda:
        raise ValueError(f"rank_rows: unsupported device {queries.device}")
    q, w = queries.shape
    rank = torch.empty((q,), dtype=torch.int32, device=queries.device)
    found = torch.empty((q,), dtype=torch.bool, device=queries.device)
    if q == 0:
        return rank, found
    # the kernel loads rows as 8- and 16-byte vectors
    if table.data_ptr() % 16:
        table = table.clone()
    if queries.data_ptr() % 16:
        queries = queries.clone()
    with torch.cuda.device(queries.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(queries.device).cuda_stream)
        rc = _lib().rank_rows(table.data_ptr(), queries.data_ptr(),
                              rank.data_ptr(), found.data_ptr(), q, n_table,
                              w, stream)
    if rc != 0:
        raise RuntimeError(f"rank_rows: CUDA launch failed with error {rc}")
    launches["rank_rows"] += 1
    launch_shapes["rank_rows"].add((w, table.shape[0], n_table, q))
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

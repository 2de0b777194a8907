"""Sort / distinct-reduce primitives over limb-plane k-mer keys.

Port of gatb_core_tpu/ops/sortops.py: the counting half (lines 52-224 and
439-823), the stacked merges (lines 140 and 225-420) and, at the end of
the file, the rank search of the graph stages (lines 825-966). In the
counting half k-mers ride as one (P, N) int32 tensor of uint32 limb planes
(plane 0 most significant, see ops/limb_sort.py), sorted by the
hand-written kernels (a bitonic sort of tiles, then merge-path merge
levels), then reduced to a distinct table by run detection and a weight
prefix sum. The row-major entry points of the JAX
module (``sort_by_kmer``, ``count_sorted``, ``count_batch``,
``merge_tables``, ``pallas_sort_rows``) take and return (N, W) rows and
wrap the plane-major ones.

There is no ``use_pallas`` argument and no environment switch: every sort
and merge here goes through ``limb_sort.sort_u32_limbs`` /
``merge_sorted_runs``, which launch the CUDA kernels on a CUDA tensor and
run their plain versions on a CPU tensor. Both return the tensor that
holds the result (a merge is out of place, the sort ping-pongs between its
argument and a scratch tensor), so every caller here takes the return
value. The kernels carry no payload channel, so payloads (counts, bank ids) ride as least-significant
key planes; every caller sums them per equal-k-mer run, so their order
inside a run does not reach a result. The sorts need a power-of-two row
count: inputs are padded with all-ones sentinel rows, so capacities along
the way can differ from the JAX package's exact-size ``lax.sort`` path
while live rows, counts and ``n`` are equal.

The JAX reduce avoids gathers and scatters (slow on the TPU) and compacts
the run-end rows with a sort keyed on the weight cumsum
(``_compact_ends``/``_compact_ends_blocked``). Here the distinct reduce
(``count_sorted_planes`` and ``count_sorted_planes_multi``) is the
hand-written kernel of ``csrc/run_reduce.cu`` on a CUDA tensor (three
launches a call, counted once in ``launches["run_reduce"]``): each run end
finds its column by a prefix count of the ends and writes its row and the
weight since the end before it. On a CPU tensor the plain versions
(``count_sorted_planes_plain``, ``count_sorted_planes_multi_plain``) take
a prefix sum over the end flags and one scatter of all planes. Both give
the same table, counts, ``n`` and ``n > cap_out`` flag as the JAX
package. The JAX blocked compaction (``blocked=True``) and its extra
block-overflow flag have no counterpart.

Results that the JAX package returns as device scalars (``n``, the
overflow flag) are 0-d tensors on the input's device, so a caller can
queue further work before it reads them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .bitpack import as_u32_i64
from .limb_sort import as_planes, merge_sorted_runs, sort_u32_limbs

I32 = torch.int32
SENTINEL = -1                 # all-ones uint32 in int32 storage

# calls of the distinct-reduce kernel (CUDA tensors only; three launches
# each), and the distinct (planes, rows, weight rows or 0, cap_out) they
# launched with
launches = {"run_reduce": 0}
launch_shapes: dict[str, set] = {"run_reduce": set()}


def reset_launches() -> None:
    launches["run_reduce"] = 0
    launch_shapes["run_reduce"].clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at the first launch, never at import)."""
    from ._build import load_cuda

    lib = load_cuda("run_reduce")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.run_reduce.argtypes = [vp, i, ll, vp, vp, i, ll, vp, ll, vp, vp, vp,
                               vp, vp]
    lib.run_reduce.restype = ctypes.c_int
    lib.run_reduce_tile.argtypes = []
    lib.run_reduce_tile.restype = ctypes.c_int
    return lib


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class CountTable(NamedTuple):
    """Fixed-capacity sorted table of distinct k-mers with counts
    (row-major, the layout of the JAX package's CountTable).

    kmers:  (C, W) int32 limbs (uint32 patterns), ascending integer order;
            rows >= n are all-ones padding
    counts: (C,) int32 abundances (0 on padding rows)
    n:      () int32 number of live rows
    """

    kmers: torch.Tensor
    counts: torch.Tensor
    n: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.kmers.shape[0]

    @property
    def width(self) -> int:
        return self.kmers.shape[1]


def _rows_i32(kmers: torch.Tensor) -> torch.Tensor:
    """(..., W) limbs, int32 storage or zero-extended int64 (what
    extraction returns) -> (N, W) int32 storage."""
    return kmers.reshape(-1, kmers.shape[-1]).to(I32)


def pallas_sort_rows(flat: torch.Tensor, inv: torch.Tensor,
                     spare_bits: bool, *payloads):
    """Sort (N, W) k-mer rows (+ optional (N,) payloads) with the limb-sort
    kernels; the row-major wrapper over ``sort_u32_limbs`` (the name is the
    JAX module's, where this is the Pallas route). Pads N to a power of two
    (at least 256) with all-ones sentinel rows.

    Returns (sorted_kmers (P, W), sorted_inv (P,) or None with spare_bits,
    *sorted_payloads int32) with P = next_pow2(N); sentinel and invalid
    rows ride to the tail. With ``spare_bits`` the caller has already
    encoded invalid rows as all-ones; otherwise ``inv`` leads as a key.
    Payloads ride as least-significant key planes: pass only payloads
    whose order within equal-k-mer runs is irrelevant."""
    flat = _rows_i32(flat)
    n, w = flat.shape
    p = _next_pow2(max(n, 256))
    n_keys = w if spare_bits else w + 1
    planes = torch.full((n_keys + len(payloads), p), SENTINEL, dtype=I32,
                        device=flat.device)
    k0 = n_keys - w
    if not spare_bits:
        planes[0, :n] = inv.to(I32)
    planes[k0:n_keys, :n] = flat.T
    for i, q in enumerate(payloads):
        planes[n_keys + i, :n] = q.to(I32)
        planes[n_keys + i, n:] = 0
    planes = sort_u32_limbs(planes)
    si = None if spare_bits else planes[0] != 0
    sk = planes[k0:n_keys].T.contiguous()
    return (sk, si) + tuple(planes[n_keys + i]
                            for i in range(len(payloads)))


def sort_by_kmer(kmers: torch.Tensor, invalid: torch.Tensor, *payloads):
    """Sort rows by (invalid, kmer) ascending; invalid rows go to the tail.

    kmers: (N, W); invalid: (N,) bool; payloads: extra (N,) tensors
    reordered alongside (as least-significant keys, see
    ``pallas_sort_rows``). Returns (kmers, invalid, *payloads) sorted, N
    rows each: the power-of-two padding sorts behind every input row and
    is cut off again."""
    for q in payloads:
        if q.dim() != 1:
            raise ValueError("payloads must be rank-1")
    n = kmers.shape[0]
    out = pallas_sort_rows(kmers, invalid, False, *payloads)
    return tuple(x[:n] for x in out)


def count_sorted(sorted_kmers: torch.Tensor, inv: torch.Tensor,
                 weights: torch.Tensor | None = None) -> CountTable:
    """Reduce a sorted (kmer, invalid) stream of (C, W) rows into a
    CountTable of the same capacity; invalid rows all sit at the tail.

    weights defaults to 1 per valid row (raw occurrence counting); pass
    existing counts when merging tables."""
    planes = _rows_i32(sorted_kmers).T.contiguous()
    out_p, counts, n, _ = count_sorted_planes(planes, inv, weights=weights)
    return CountTable(out_p.T.contiguous(), counts, n)


def count_batch(kmers: torch.Tensor, valid: torch.Tensor,
                spare_bits: bool = False) -> CountTable:
    """Flatten, sort, and reduce one extracted batch into a CountTable.

    With ``spare_bits=True`` (top limb has unused high bits, i.e.
    2k % 32 != 0), invalid rows are encoded as the all-ones sentinel,
    which no valid k-mer can equal, and the sort drops the validity key.
    Capacity is the row count padded to the next power of two."""
    flat = _rows_i32(kmers)
    inv = ~valid.reshape(-1)
    if spare_bits:
        flat = torch.where(inv[:, None], torch.full_like(flat, SENTINEL),
                           flat)
        sk, _ = pallas_sort_rows(flat, inv, True)
        si = torch.arange(sk.shape[0], device=sk.device) >= valid.sum()
        return count_sorted(sk, si)
    sk, si = pallas_sort_rows(flat, inv, False)
    return count_sorted(sk, si)


def merge_tables(a: CountTable, b: CountTable) -> CountTable:
    """Merge two sorted count tables (capacity = cap_a + cap_b); the
    counts ride the sort as the least significant key and are summed per
    run."""
    dev = a.kmers.device
    kmers = torch.cat([a.kmers, b.kmers], dim=0)
    counts = torch.cat([a.counts, b.counts], dim=0)
    live = torch.cat([torch.arange(a.capacity, device=dev) < a.n,
                      torch.arange(b.capacity, device=dev) < b.n])
    sk, si, sc = sort_by_kmer(kmers, ~live, counts)
    return count_sorted(sk, si, weights=sc)


def _run_starts(sorted_kmers: torch.Tensor,
                inv: torch.Tensor) -> torch.Tensor:
    """Boolean mask of first element of each distinct-valid-kmer run."""
    neq_prev = (sorted_kmers[1:] != sorted_kmers[:-1]).any(dim=-1)
    one = torch.ones((1,), dtype=torch.bool, device=sorted_kmers.device)
    return torch.cat([one, neq_prev]) & ~inv


def _lex_lt_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the last (limb) axis, limbs compared as
    uint32 (int32 storage or zero-extended int64)."""
    a, b = as_u32_i64(a), as_u32_i64(b)
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for j in range(a.shape[-1]):
        lt = lt | (eq & (a[..., j] < b[..., j]))
        eq = eq & (a[..., j] == b[..., j])
    return lt


# ---------------------------------------------------------------------------
# Stacked merges (the JAX module's lines 225-420): per-batch sorted tables,
# (NB, C, W) limbs and (NB, C) counts, merged into one table on the device.
# The JAX package merges pairs with a bitonic network under ``vmap``; here
# the tables lie end to end as W + 1 limb planes and every level of the tree
# is one ``merge_sorted_runs`` (two kernel launches) over all pairs at once.
# The count rides as the least significant key, stored as its bitwise NOT:
# a row of count 0 (padding) is then all-ones in every plane, the
# kernels' sentinel, and sorts behind every live row, also behind a live
# all-ones k-mer. Inside a run of equal keys the counts come in another
# order than the JAX network's (descending here); every caller sums them,
# and with distinct keys inside each table the order is total.
# ---------------------------------------------------------------------------


def _stacked_planes(kmers: torch.Tensor, counts: torch.Tensor, nb2: int,
                    c2: int, mask: bool = True) -> torch.Tensor:
    """(NB, C, W) limbs + (NB, C) counts -> (W + 1, nb2 * c2) int32 planes:
    table i at rows [i * c2, i * c2 + C), then the key limbs, then ~count;
    every padding row all-ones, and with ``mask`` the keys of rows with
    count <= 0 too. A table of distinct keys stays sorted by this order."""
    nb, c_len, w = kmers.shape
    kmers, counts = kmers.to(I32), counts.to(I32)
    if mask:
        live = counts > 0
        kmers = torch.where(live[..., None], kmers, SENTINEL)
        counts = torch.where(live, counts, 0)
    planes = torch.full((w + 1, nb2, c2), SENTINEL, dtype=I32,
                        device=kmers.device)
    planes[:w, :nb, :c_len] = kmers.permute(2, 0, 1)
    planes[w, :nb, :c_len] = torch.bitwise_not(counts)
    return planes.view(w + 1, nb2 * c2)


def _reduce_stacked(planes: torch.Tensor) -> CountTable:
    """Distinct reduce of merged stacked planes (``_stacked_planes``
    layout): live rows lead, their counts are summed per key."""
    w = planes.shape[0] - 1
    counts = torch.bitwise_not(planes[w])
    idx = torch.arange(planes.shape[1], device=planes.device)
    si = idx >= (counts > 0).sum()
    out_p, cnt, n, _ = count_sorted_planes(planes[:w], si, weights=counts)
    return CountTable(out_p.T.contiguous(), cnt, n)


def bitonic_merge_pair(ka, ca, kb, cb):
    """Merge two *sorted* (C, W) tables + (C,) counts into a sorted
    (2C, W) table and its (2C,) counts: one ``merge_sorted_runs`` of the
    two tables as limb planes with ~count as the least significant key
    (the JAX function is a bitonic merge network; the name stays). A C
    that is no power of two is padded with all-ones rows, which sort
    behind every row of the tables and are cut off. Keys come out as the
    JAX network gives them; counts inside a run of equal keys may come in
    another order."""
    c_len, w = ka.shape
    c2 = _next_pow2(c_len)
    planes = _stacked_planes(torch.stack([ka, kb]), torch.stack([ca, cb]),
                             2, c2, mask=False)
    out = merge_sorted_runs(planes, c2)[:, :2 * c_len]
    return (out[:w].T.contiguous(),
            torch.bitwise_not(out[w]).to(ca.dtype))


def merge_stacked_tree(kmers: torch.Tensor, counts: torch.Tensor,
                       spare_bits: bool = False) -> CountTable:
    """Device global merge of per-batch *sorted* tables through a merge
    tree and one final distinct reduce.

    kmers: (NB, C, W) sorted tables, counts: (NB, C); rows of count 0 are
    padding. C and NB are padded to powers of two with all-ones rows and
    tables; each of the log2(NB) levels is one merge level over every pair
    of tables (two kernel launches). Returns a CountTable of capacity
    next_pow2(NB) * next_pow2(C), as the JAX function does. Padding rows
    become all-ones sentinels whatever ``spare_bits`` says (the JAX
    function masks them only without spare bits and otherwise requires
    them to be sentinels already)."""
    nb, c_len, w = kmers.shape
    c2, nb2 = _next_pow2(c_len), _next_pow2(nb)
    planes = _stacked_planes(kmers, counts, nb2, c2)
    run = c2
    while run < planes.shape[1]:
        planes = merge_sorted_runs(planes, run)
        run *= 2
    return _reduce_stacked(planes)


def _dedup_compact_planes(planes: torch.Tensor, cap_out: int):
    """``_dedup_compact`` over a batch of tables in the stacked-plane
    layout: planes (W + 1, B, n), each table sorted, ~count in the last
    plane. Adjacent equal live keys (runs of at most 2) are summed into
    the first, then the live rows of each table are compacted to its front
    by an exclusive prefix count of the dead rows; rows past cap_out are
    dropped. Returns (planes (W + 1, B, cap_out), n_live (B,), overflow
    (B,))."""
    P, B, n = planes.shape
    dev = planes.device
    keys = planes[:-1]
    c = torch.bitwise_not(planes[-1])
    live = c > 0
    eq_next = (keys[:, :, 1:] == keys[:, :, :-1]).all(dim=0) \
        & live[:, 1:] & live[:, :-1]
    no = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    absorb = torch.cat([eq_next, no], dim=1)
    c_next = torch.cat([c[:, 1:], torch.zeros((B, 1), dtype=I32,
                                              device=dev)], dim=1)
    c = c + torch.where(absorb, c_next, 0)
    dead = torch.cat([no, eq_next], dim=1) | ~live
    dead_i = dead.to(I32)
    idx = torch.arange(n, dtype=I32, device=dev)
    dest = idx - (torch.cumsum(dead_i, dim=1, dtype=I32) - dead_i)
    n_live = (n - dead_i.sum(dim=1)).to(I32)
    dest = torch.where(dead | (dest >= cap_out), cap_out, dest).long()
    dest = (dest + torch.arange(B, device=dev)[:, None]
            * (cap_out + 1)).reshape(-1)
    src = torch.cat([keys, torch.bitwise_not(c)[None]]).reshape(P, B * n)
    out = torch.full((P, B, cap_out + 1), SENTINEL, dtype=I32, device=dev)
    out.view(P, B * (cap_out + 1)).index_copy_(1, dest, src)
    return out[:, :, :cap_out], n_live, n_live > cap_out


def _dedup_compact(k: torch.Tensor, c: torch.Tensor, cap_out: int):
    """Collapse adjacent equal-key runs (length <= 2) of a sorted table and
    compact live rows to the front of a ``cap_out``-capacity table.

    Requires: k sorted ascending, padding rows have c == 0, and every live
    key appears at most twice (true when merging two distinct-key tables).
    Returns (kmers (cap_out, W), counts (cap_out,), n_live, overflow)."""
    n, w = k.shape
    planes = torch.cat([k.to(I32).T, torch.bitwise_not(c.to(I32))[None]])
    out, n_live, ov = _dedup_compact_planes(planes[:, None, :], cap_out)
    return (out[:w, 0].T.contiguous(), torch.bitwise_not(out[w, 0]),
            n_live[0], ov[0])


def merge_stacked_tree_capped(kmers: torch.Tensor, counts: torch.Tensor,
                              cap: int):
    """Capacity-bounded device merge of per-batch *distinct-key* tables.

    Same contract as merge_stacked_tree, plus: every input table must have
    distinct keys (count_batch output satisfies this) and the global number
    of distinct kmers must fit in ``cap`` (from the configuration plan's
    distinct-kmer estimate, ConfigurationAlgorithm.cpp:308-319). Each merge
    level dedups equal keys (run length <= 2) and compacts every table back
    to min(2 * its length, next_pow2(cap)) rows, batched over the level's
    tables, so tables stop growing once they reach the cap. Returns
    (CountTable, overflow); on overflow the result is invalid and the
    caller must fall back to merge_stacked_tree."""
    nb, c_len, w = kmers.shape
    c2, nb2 = _next_pow2(c_len), _next_pow2(nb)
    cap2 = _next_pow2(cap)
    planes = _stacked_planes(kmers, counts, nb2, c2)
    length = c2
    if nb2 == 1:  # single table: dedup no-op, normalize capacity
        planes, _, ov = _dedup_compact_planes(
            planes.view(w + 1, 1, c2), min(c2, cap2))
        overflow = ov[0]
    else:
        overflow = torch.zeros((), dtype=torch.bool, device=kmers.device)
        while planes.shape[1] > length:
            merged = merge_sorted_runs(planes, length)
            pairs = merged.shape[1] // (2 * length)
            length = min(2 * length, cap2)
            planes, _, ov = _dedup_compact_planes(
                merged.view(w + 1, pairs, -1), length)
            # one pair's slice is a strided view; the next merge level
            # takes contiguous planes
            planes = planes.reshape(w + 1, pairs * length).contiguous()
            overflow = overflow | ov.any()
    planes = planes.reshape(w + 1, -1)
    cnt = torch.bitwise_not(planes[w])
    return CountTable(planes[:w].T.contiguous(), cnt,
                      (cnt > 0).sum().to(I32)), overflow


def merge_stacked(kmers: torch.Tensor, counts: torch.Tensor,
                  spare_bits: bool = False) -> CountTable:
    """Merge stacked per-batch tables fully on device.

    kmers: (NB, C, W) per-batch tables (padding rows have count 0),
    counts: (NB, C). One ``sort_u32_limbs`` of all rows (padded to a power
    of two with all-ones rows, which sort behind them) with ~count as the
    least significant key, then the distinct reduce. Returns a CountTable
    of capacity NB * C, as the JAX function does. ``spare_bits`` changes
    nothing: padding rows are all-ones in every plane either way (the JAX
    function sorts a validity key first without spare bits)."""
    nb, c_len, w = kmers.shape
    n = nb * c_len
    planes = _stacked_planes(kmers.reshape(1, n, w), counts.reshape(1, n),
                             1, _next_pow2(max(n, 2)))
    return _reduce_stacked(sort_u32_limbs(planes)[:, :n].contiguous())


def _run_stats(planes: torch.Tensor, inv: torch.Tensor):
    """Run detection of a sorted stream: (starts, rid, n, is_end).

    rid = run id per row (nondecreasing); is_end marks each run's last
    valid row; n is a 0-d int32 tensor."""
    dev = planes.device
    neq = (planes[:, 1:] != planes[:, :-1]).any(dim=0)
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    starts = torch.cat([one, neq]) & ~inv
    rid = torch.cumsum(starts, dim=0, dtype=I32) - 1
    n = rid[-1] + 1
    next_inv = torch.cat([inv[1:], one])
    next_neq = torch.cat([neq, one])
    is_end = (~inv) & (next_neq | next_inv)
    return starts, rid, n, is_end


def _cumw(inv: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum (last axis) of masked weights. Sampled at
    the run END rows, adjacent differences give per-run totals."""
    w = torch.where(inv, torch.zeros_like(weights, dtype=I32),
                    weights.to(I32))
    return torch.cumsum(w, dim=-1, dtype=I32)


def _diff_counts(cwe: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Per-run totals from the cumsum sampled at run ends (last axis)."""
    prev = torch.cat([torch.zeros(cwe.shape[:-1] + (1,), dtype=I32,
                                  device=cwe.device), cwe[..., :-1]], dim=-1)
    return torch.where(live, cwe - prev, torch.zeros_like(cwe))


def _compact_ends(planes: torch.Tensor, cumw: torch.Tensor,
                  is_end: torch.Tensor, cap_out: int):
    """Move each run's END row (k-mer + its weight cumsum(s)) to its run
    position: a prefix sum over the end flags gives the destination, ends
    past cap_out and non-end rows go to a dump slot. ``cumw`` is (N,) or,
    with one cumsum per bank, (B, N). Returns (out_planes (P, cap_out),
    cwe (cap_out,) or (B, cap_out)); unfilled rows are sentinels / 0."""
    P = planes.shape[0]
    dev = planes.device
    pos = torch.cumsum(is_end, dim=0) - 1
    dest = torch.where(is_end & (pos < cap_out), pos,
                       torch.full_like(pos, cap_out))
    out = torch.full((P, cap_out + 1), SENTINEL, dtype=I32, device=dev)
    out.index_copy_(1, dest, planes)
    cwe = torch.zeros(cumw.shape[:-1] + (cap_out + 1,), dtype=I32,
                      device=dev)
    cwe.index_copy_(cumw.dim() - 1, dest, cumw)
    return out[:, :cap_out].contiguous(), cwe[..., :cap_out]


def run_reduce(planes: torch.Tensor, inv: torch.Tensor,
               weights: torch.Tensor | None, cap_out: int):
    """The distinct-reduce kernel on CUDA tensors: (P, N) int32 sorted
    planes, (N,) bool inv (invalid rows at the tail), weights None or (B,
    N) int32 rows. Returns (out_planes (P, cap_out), counts (B, cap_out)
    int32, n () int32, overflow () bool); see count_sorted_planes."""
    planes = as_planes(planes)
    if not planes.is_cuda:
        raise ValueError(f"run_reduce: unsupported device {planes.device}")
    P, n_rows = planes.shape
    if n_rows < 1:
        raise ValueError("run_reduce: no rows")
    if inv.shape != (n_rows,):
        raise ValueError("run_reduce: inv must be (N,)")
    if cap_out < 0:
        raise ValueError("run_reduce: negative cap_out")
    if inv.device != planes.device or (
            weights is not None and weights.device != planes.device):
        raise ValueError("run_reduce: planes, inv and weights on different "
                         "devices")
    dev = planes.device
    inv = inv.to(torch.bool).contiguous()
    if weights is not None:
        weights = weights.to(I32).contiguous()
        if weights.dim() != 2 or weights.shape[1] != n_rows:
            raise ValueError("run_reduce: weights must be (B, N)")
    b = 1 if weights is None else weights.shape[0]
    lib = _lib()
    tile = lib.run_reduce_tile()
    aux = torch.empty((1 + (2 + b) * -(-n_rows // tile),), dtype=I32,
                      device=dev)
    n = torch.empty((), dtype=I32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    out = torch.empty((P, cap_out), dtype=I32, device=dev)
    counts = torch.empty((b, cap_out), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.run_reduce(
            planes.data_ptr(), P, n_rows, inv.data_ptr(),
            None if weights is None else weights.data_ptr(), b, cap_out,
            aux.data_ptr(), aux.numel(), n.data_ptr(), overflow.data_ptr(),
            out.data_ptr(), counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"run_reduce: CUDA launch failed with error {rc}")
    launches["run_reduce"] += 1
    launch_shapes["run_reduce"].add(
        (P, n_rows, 0 if weights is None else b, cap_out))
    return out, counts, n, overflow


def count_sorted_planes(planes, inv: torch.Tensor,
                        weights: torch.Tensor | None = None,
                        cap_out: int | None = None):
    """Reduce sorted limb planes into a compacted distinct table.

    planes: (P, N) int32, rows sorted ascending; inv: (N,) bool, True
    rows must all sit at the tail; weights: optional (N,) int32, >= 1 per
    valid row (defaults to 1); cap_out: output capacity (default N).

    Returns (out_planes (P, cap_out), counts (cap_out,) int32, n,
    overflow) with n and overflow 0-d tensors; overflow is n > cap_out,
    and the first cap_out runs are kept. On a CUDA tensor the
    ``run_reduce`` kernel, on a CPU tensor ``count_sorted_planes_plain``.
    """
    x = as_planes(planes)
    if cap_out is None:
        cap_out = x.shape[1]
    if x.device.type == "cpu":
        return count_sorted_planes_plain(x, inv, weights, cap_out)
    out, counts, n, overflow = run_reduce(
        x, inv, None if weights is None else weights.reshape(1, -1), cap_out)
    return out, counts[0], n, overflow


def count_sorted_planes_plain(planes, inv: torch.Tensor,
                              weights: torch.Tensor | None = None,
                              cap_out: int | None = None):
    """Plain version of ``count_sorted_planes`` on any device, torch ops:
    run detection, the weight cumsum, the compaction of the run ends by a
    prefix sum over the end flags and one scatter, the cumsum differences."""
    x = as_planes(planes)
    n_rows = x.shape[1]
    if cap_out is None:
        cap_out = n_rows
    _, _, n, is_end = _run_stats(x, inv)
    if weights is None:
        # every invalid row sits at the tail, so the masked cumsum of
        # all-ones weights is min(i+1, n_valid)
        n_valid = (n_rows - inv.sum()).to(I32)
        idx = torch.arange(1, n_rows + 1, dtype=I32, device=x.device)
        cumw = torch.minimum(idx, n_valid)
    else:
        cumw = _cumw(inv, weights)
    out_planes, cwe = _compact_ends(x, cumw, is_end, cap_out)
    live = torch.arange(cap_out, device=x.device) < n
    return out_planes, _diff_counts(cwe, live), n, n > cap_out


def count_sorted_planes_multi(planes, inv: torch.Tensor,
                              weights: torch.Tensor,
                              cap_out: int | None = None):
    """Multi-weight variant of count_sorted_planes: one run detection, one
    count column per bank (the reference's multibank k-mer matrices,
    PartitionsCommand.cpp:1855-2100, in one pass).

    weights: (B, N) int32 per-bank weights. Returns (out_planes,
    counts (B, cap_out) int32, n, overflow). On a CUDA tensor the
    ``run_reduce`` kernel, on a CPU tensor
    ``count_sorted_planes_multi_plain``."""
    x = as_planes(planes)
    if cap_out is None:
        cap_out = x.shape[1]
    if x.device.type == "cpu":
        return count_sorted_planes_multi_plain(x, inv, weights, cap_out)
    return run_reduce(x, inv, weights, cap_out)


def count_sorted_planes_multi_plain(planes, inv: torch.Tensor,
                                    weights: torch.Tensor,
                                    cap_out: int | None = None):
    """Plain version of ``count_sorted_planes_multi`` on any device."""
    x = as_planes(planes)
    if cap_out is None:
        cap_out = x.shape[1]
    _, _, n, is_end = _run_stats(x, inv)
    out_planes, cwes = _compact_ends(x, _cumw(inv[None, :], weights),
                                     is_end, cap_out)
    live = torch.arange(cap_out, device=x.device) < n
    return out_planes, _diff_counts(cwes, live[None, :]), n, n > cap_out


def _pad_table_to(p: torch.Tensor, c: torch.Tensor, cap: int):
    """Pad (W, C) planes with sentinel rows and (..., C) counts with zeros
    up to ``cap`` rows."""
    pad = cap - p.shape[1]
    if pad:
        p = torch.cat([p, torch.full((p.shape[0], pad), SENTINEL, dtype=I32,
                                     device=p.device)], dim=1)
        c = torch.cat([c.to(I32), torch.zeros(c.shape[:-1] + (pad,),
                                              dtype=I32, device=c.device)],
                      dim=-1)
    return p, c


def merge_tables_planes_multi(pa, ca: torch.Tensor, na, pb, cb: torch.Tensor,
                              nb, cap_out: int):
    """merge_tables_planes with B per-bank count columns ((B, C) tensors)
    riding the merge as extra least-significant key planes (each column is
    summed per run downstream, so the order within equal-k-mer runs is
    irrelevant). Returns (planes, counts (B, cap_out), n, overflow)."""
    pa, pb = as_planes(pa), as_planes(pb)
    cap = _next_pow2(max(pa.shape[1], pb.shape[1]))
    pa, ca = _pad_table_to(pa, ca, cap)
    pb, cb = _pad_table_to(pb, cb, cap)
    w = pa.shape[0]
    cat = torch.cat([torch.cat([pa, pb], dim=1),
                     torch.cat([ca.to(I32), cb.to(I32)], dim=1)])
    cat = merge_sorted_runs(cat, cap)
    inv = torch.arange(2 * cap, device=cat.device) >= (na + nb)
    return count_sorted_planes_multi(cat[:w], inv, cat[w:], cap_out=cap_out)


def _encode_invalid(planes: torch.Tensor, valid: torch.Tensor,
                    spare_bits: bool):
    """Sentinel-encode invalid rows for the sort: with spare bits the
    all-ones k-mer is impossible, so invalid rows become all-ones keys;
    otherwise a leading validity plane is prepended (0 = valid).
    Returns (new (P or P+1, N) planes, number of extra planes)."""
    x = as_planes(planes)
    if spare_bits:
        return torch.where(valid[None, :], x,
                           torch.full_like(x, SENTINEL)), 0
    vkey = torch.where(valid, 0, SENTINEL).to(I32)
    return torch.cat([vkey[None, :], x]), 1


def sort_planes(planes, tile_log2: int | None = None) -> torch.Tensor:
    """Sort power-of-two limb planes ascending (sentinels to the tail).
    Returns the sorted tensor; a (P, N) argument is used as scratch and
    its contents are given up.

    Every plane is a key: payload planes (the JAX ``n_keys`` split) ride
    as least-significant keys, so callers may only pass payloads whose
    order within equal-key runs is irrelevant (counts are summed
    downstream)."""
    return sort_u32_limbs(planes, tile_log2=tile_log2)


def count_planes(planes, valid: torch.Tensor,
                 weights: torch.Tensor | None = None,
                 spare_bits: bool = False, cap_out: int | None = None):
    """Sort + reduce limb planes into a distinct table.

    planes: (P, N) int32 (N a power of two); valid: (N,) bool; weights:
    optional per-row counts. Returns (out_planes, counts, n, overflow).
    """
    enc, extra = _encode_invalid(planes, valid, spare_bits)
    n_keys = enc.shape[0]
    if weights is not None:
        enc = torch.cat([enc, weights.to(I32)[None, :]])
    enc = sort_planes(enc)
    if extra:
        inv = enc[0] != 0
        kplanes = enc[1:n_keys]
    else:
        idx = torch.arange(enc.shape[1], device=enc.device)
        inv = idx >= valid.sum()
        kplanes = enc[:n_keys]
    w_ = enc[n_keys] if weights is not None else None
    return count_sorted_planes(kplanes, inv, weights=w_, cap_out=cap_out)


def count_planes_multibank(planes, valid: torch.Tensor,
                           bank_ids: torch.Tensor, nb_banks: int,
                           spare_bits: bool = False,
                           cap_out: int | None = None):
    """One-pass multibank sort + reduce: k-mers from all banks sort
    together with their bank id riding as the least significant key plane;
    the reduce yields one count column per bank (reference per-bank k-mer
    matrices, PartitionsCommand.cpp:1855-2100, in ONE pass over the union).
    Returns (out_planes, counts (nb_banks, cap_out), n, overflow)."""
    enc, extra = _encode_invalid(planes, valid, spare_bits)
    n_keys = enc.shape[0]
    enc = torch.cat([enc, bank_ids.to(I32)[None, :]])
    enc = sort_planes(enc)
    if extra:
        inv = enc[0] != 0
        kplanes = enc[1:n_keys]
    else:
        inv = torch.arange(enc.shape[1], device=enc.device) >= valid.sum()
        kplanes = enc[:n_keys]
    banks = torch.arange(nb_banks, dtype=I32, device=enc.device)
    weights = (enc[n_keys][None, :] == banks[:, None]).to(I32)
    return count_sorted_planes_multi(kplanes, inv, weights, cap_out=cap_out)


def pad_planes_pow2(planes, counts: torch.Tensor | None = None,
                    min_cap: int = 256):
    """Pad (P, n) planes to the next power of two with sentinel rows
    (all-ones keys, zero counts). Returns (planes, counts, n)."""
    x = as_planes(planes)
    P, n = x.shape
    cap = _next_pow2(max(n, min_cap))
    pad = cap - n
    if pad:
        x = torch.cat([x, torch.full((P, pad), SENTINEL, dtype=I32,
                                     device=x.device)], dim=1)
        if counts is not None:
            counts = torch.cat([counts.to(I32), torch.zeros(
                (pad,), dtype=I32, device=counts.device)])
    return x, counts, n


def merge_tables_planes(pa, ca: torch.Tensor, na, pb, cb: torch.Tensor, nb,
                        cap_out: int):
    """Merge two sorted distinct-key tables into one.

    pa/pb: (W, Ca)/(W, Cb) int32 planes (power-of-two capacities,
    sentinel tails); ca/cb: int32 counts; na/nb: live rows (ints or 0-d
    tensors). One merge level with the counts riding as the least
    significant key (distinct keys inside each table make the order
    total), then the distinct reduce. Returns (planes, counts, n,
    overflow) at capacity cap_out.
    """
    pa, pb = as_planes(pa), as_planes(pb)
    cap = _next_pow2(max(pa.shape[1], pb.shape[1]))
    pa, ca = _pad_table_to(pa, ca, cap)
    pb, cb = _pad_table_to(pb, cb, cap)
    w = pa.shape[0]
    cat = torch.empty((w + 1, 2 * cap), dtype=I32, device=pa.device)
    cat[:w, :cap] = pa
    cat[:w, cap:] = pb
    cat[w, :cap] = ca
    cat[w, cap:] = cb
    cat = merge_sorted_runs(cat, cap)
    idx = torch.arange(2 * cap, device=cat.device)
    inv = idx >= (na + nb)
    return count_sorted_planes(cat[:w], inv, weights=cat[w],
                               cap_out=cap_out)


# ---------------------------------------------------------------------------
# Rank / membership of rows in a sorted table (the graph half of the JAX
# module, sortops.py:825-966).
#
# Every postsolid stage (debloom's 8 probes per solid k-mer, the adjacency
# precompute, batched membership) needs rank-in-sorted-table for large query
# batches. The JAX package has two ways to it, a co-sort of table and
# queries (``rank_join``) and a gather loop (``method="binsearch"``), and a
# dispatcher between them, because on its device a gather is slow. Here
# there is ONE search, ``ops/rank_search.rank_rows``: a hand-written CUDA
# kernel on a CUDA tensor, its plain version on a CPU tensor. The three
# names of the JAX module stay and all call it.
# ---------------------------------------------------------------------------


def rank_join_traced(table: torch.Tensor, queries: torch.Tensor, n_table,
                     index=None):
    """Rank + membership of query rows in a sorted distinct-key table.

    table: (C, W) limbs ascending (int32 storage, or int64 zero-extended);
    rows >= n_table are padding. queries: (Q, W), any order; the all-ones
    row is never found. Returns (rank (Q,) int32: index in the table, -1
    if absent; found (Q,) bool), in the original query order. ``n_table``
    is an int or a 0-d tensor (the kernel takes it at run time, so no
    padded capacity is needed). ``index``: the table's
    ``rank_search.RankIndex``, held by callers that search one table many
    times (the table is then its int32 rows)."""
    from .rank_search import as_rows, rank_rows

    return rank_rows(as_rows(table), as_rows(queries), int(n_table),
                     index=index)


rank_join = rank_join_traced


def rank_limbs(table: torch.Tensor, queries: torch.Tensor, n_table: int,
               method: str = "auto", index=None):
    """Same contract as ``rank_join``. ``method`` is kept for name parity
    with the JAX module and accepts "auto", "join" and "binsearch": all
    three run the same search (``rank_search.rank_rows``)."""
    if method not in ("auto", "join", "binsearch"):
        raise ValueError(f"unknown rank method {method!r}")
    return rank_join_traced(table, queries, n_table, index=index)


def pad_rows_pow2(table):
    """Host helper: pad a sorted (N, W) uint32 row table (numpy) to the
    next power-of-two capacity with all-ones sentinel rows. Returns
    (table, N). Nothing on the port's postsolid path needs it (the search
    takes the live row count at run time); kept for callers that hand a
    padded table on."""
    import numpy as np

    n, w = table.shape if table.ndim == 2 else (0, 1)
    cap = _next_pow2(max(n, 1))
    if cap == n:
        return table, n
    out = np.full((cap, w), 0xFFFFFFFF, np.uint32)
    out[:n] = table
    return out, n


def sweep_chunk(n: int, parts: int = 1, lo: int = 4096,
                hi: int = 1 << 21) -> int:
    """Query-chunk size for table sweeps: about ``parts`` chunks per sweep,
    clamped to [lo, hi] and rounded up to a power of two. A chunk bounds
    the device memory of one step (8 candidates per node, their hashes and
    the dedup sort) and nothing else: the result of a sweep does not depend
    on it."""
    return _next_pow2(max(lo, min(hi, -(-max(n, 1) // parts))))


def shrink(table: CountTable, capacity: int) -> CountTable:
    """Shrink or grow a table to the given capacity (>= n); rows past n
    are all-ones padding with zero counts."""
    n = int(table.n)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < live rows {n}")
    dev = table.kmers.device
    kmers = torch.full((capacity, table.width), SENTINEL, dtype=I32,
                       device=dev)
    counts = torch.zeros((capacity,), dtype=I32, device=dev)
    kmers[:n] = _rows_i32(table.kmers)[:n]
    counts[:n] = table.counts[:n]
    return CountTable(kmers, counts, torch.tensor(n, dtype=I32, device=dev))

"""Multi-rank postsolid and unitig stages over a mesh.

Port of gatb_core_tpu/parallel/postsolid.py: the debloom 8-probe sweep
(DebloomAlgorithm.cpp:270-300), the adjacency precompute
(Graph.cpp:3508-3610) and the unitig list ranking (bcalm_algo.cpp:592-680,
bglue_algo.cpp:824-880) sharded over the ranks of a mesh.

- The solid table is range-sharded (``shard_table``): rank d owns a
  contiguous slice of the sorted table, and the split keys are the routing
  bounds. Every rank holds the whole table on its device (the graph's one
  copy) and slices its shard there; at one rank the shard is the table,
  searched through the caller's held ``RankIndex``.
- Every stage asks the rank and membership of candidate rows in the table.
  Sharded (``exchange_rank``), each query row goes to the owner of its key
  range through fixed send windows (an all-to-all), the owner answers with
  the port's ``rank_rows`` kernel on its shard (one ``RankIndex`` per shard
  and stage, or the caller's at one rank), and the answers come back through the inverse all-to-all to
  the query's slot. A window too small for the routing skew sets a flag
  summed over every rank, and every rank retries the stage with windows
  twice as large (``retries`` counts them), as in the JAX package.
- At one rank there are no windows (JAX's ``ndev == 1`` branch), and the
  sweep goes in chunks of ``sweep_chunk`` rows, as the single-device stages
  do.
- The pointer-doubling rounds are all-gather rounds: each rank gathers the
  parent and rank arrays and chases its own slice.

Every function returns the global result on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.neighbor_ops import neighbor_candidates
from ..ops.rank_search import RankIndex, as_rows, held_index, rank_rows
from ..ops.sortops import SENTINEL, _next_pow2, sweep_chunk
from .mesh import DATA_AXIS
from .superbatch import _ge_bound

I32 = torch.int32
I64 = torch.int64
_ONES = np.uint32(0xFFFFFFFF)
# stage sweeps replayed after a send window overflowed
retries = {"postsolid": 0}


def _rows_ge(rows: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """(Q, W) int32 rows >= (W,) bound: the counting exchange's compare
    on the rows' planes."""
    return _ge_bound(rows.T, bound)


def shard_table(table: np.ndarray, ndev: int):
    """Contiguous row split of the sorted solid table.

    Returns (padded (ndev, cap, W) uint32, all-ones tail rows;
    n_loc (ndev,) int32; base (ndev,) int32 global rank of each shard's
    first row; bounds (ndev-1, W) uint32 split keys: rank d owns keys in
    [bounds[d-1], bounds[d]) )."""
    n, w = table.shape if table.ndim == 2 else (0, 1)
    cap = max(1, -(-n // ndev))
    padded = np.full((ndev, cap, w), _ONES, np.uint32)
    n_loc = np.zeros(ndev, np.int32)
    base = np.zeros(ndev, np.int32)
    bounds = np.full((max(ndev - 1, 1), w), _ONES, np.uint32)
    for d in range(ndev):
        lo, hi = d * cap, min((d + 1) * cap, n)
        if lo < hi:
            padded[d, :hi - lo] = table[lo:hi]
        n_loc[d] = max(hi - lo, 0)
        base[d] = min(lo, n)
        if d < ndev - 1 and hi < n:
            bounds[d] = table[hi]
            # else: all-ones bound, nothing routes past the last live row
    if ndev == 1:
        bounds = np.zeros((0, w), np.uint32)
    return padded, n_loc, base, bounds[:ndev - 1] if ndev > 1 else bounds


def exchange_rank(mesh, queries: torch.Tensor, table_loc: torch.Tensor,
                  n_loc: int, base: int, bounds: torch.Tensor,
                  cap_send: int, index: RankIndex | None = None):
    """Distributed rank and membership, called by every rank of ``mesh``.

    queries: (Q, W) int32 rows of this rank (all-ones is never found);
    table_loc: (cap_t, W) this rank's sorted shard, n_loc live rows, the
    first at global rank ``base``; bounds: (ndev-1, W) int32 split keys;
    ``index``: the shard's RankIndex. Returns (grank (Q,) int32 global rank
    or -1, found (Q,) bool, n_over 0-d: rows the send windows dropped;
    retry with larger windows when it is set on any rank).

    The routing is the counting exchange's: a stable sort by owner, ndev
    contiguous windows of cap_send rows, the all-to-all, the owner's
    ``rank_rows``, the inverse all-to-all. Each answer goes back to its
    query's slot by the query's id, which occurs once, so the order of the
    windows reaches no result. Slots past a window's count hold the next
    segment's rows and are masked on both sides."""
    ndev = mesh.shape[DATA_AXIS]
    dev = queries.device
    q, w = queries.shape
    if ndev == 1:
        rank, found = rank_rows(table_loc, queries, n_loc, index=index)
        return (torch.where(found, rank + base, -1).to(I32), found,
                torch.zeros((), dtype=I64, device=dev))

    owner = torch.zeros(q, dtype=I64, device=dev)
    for j in range(ndev - 1):
        owner += _rows_ge(queries, bounds[j])
    order = torch.sort(owner, stable=True).indices
    cnt = torch.zeros(ndev, dtype=I64, device=dev).index_add_(
        0, owner, torch.ones_like(owner))
    starts = torch.cumsum(cnt, 0) - cnt
    send_cnt = torch.clamp(cnt, max=cap_send)
    n_over = (cnt - send_cnt).sum()

    # the sorted rows and their query ids, a sentinel tail behind them
    pad = torch.full((q + cap_send, w + 1), SENTINEL, dtype=I32, device=dev)
    pad[:q, :w] = queries[order]
    pad[:q, w] = order.to(I32)
    slot = torch.arange(cap_send, device=dev)
    send = pad[starts[:, None] + slot]               # (ndev, cap_send, w+1)
    recv = mesh.all_to_all(send[..., :w])
    recv_cnt = mesh.all_to_all(send_cnt.reshape(ndev, 1)).reshape(ndev)

    rvalid = (slot[None, :] < recv_cnt[:, None]).reshape(-1)
    rq = torch.where(rvalid[:, None], recv.reshape(-1, w), SENTINEL)
    rank, found = rank_rows(table_loc, rq, n_loc, index=index)
    grank = torch.where(found, rank + base, -1).to(I32)
    back = mesh.all_to_all(torch.stack(
        [grank, found.to(I32)], dim=-1).reshape(ndev, cap_send, 2))

    sent = (slot[None, :] < send_cnt[:, None]).reshape(-1)
    ids = send[..., w].reshape(-1)[sent].long()
    back = back.reshape(-1, 2)[sent]
    granks = torch.full((q,), -1, dtype=I32, device=dev)
    founds = torch.zeros((q,), dtype=torch.bool, device=dev)
    granks[ids] = back[:, 0]
    founds[ids] = back[:, 1] != 0
    return granks, founds, n_over


class _Shard:
    """This rank's slice of a range-sharded table, cut from the whole
    table on its device (``shard_table``'s split, all-ones tail rows).
    ``index``: the table's held ``RankIndex``, searched at one rank, where
    the shard is the table; several ranks index their own shards."""

    def __init__(self, mesh, solid_limbs, index: RankIndex | None = None):
        from ..kmer.debloom import rows_to_device

        table = rows_to_device(solid_limbs, mesh.device)
        n, w = table.shape
        self.ndev = mesh.shape[DATA_AXIS]
        me = mesh.coords[DATA_AXIS]
        self.cap = max(1, -(-n // self.ndev))
        self.n_loc = [max(min((d + 1) * self.cap, n) - d * self.cap, 0)
                      for d in range(self.ndev)]
        self.base = min(me * self.cap, n)
        self.live = self.n_loc[me]
        if self.ndev == 1:
            self.rows = table
            self.bounds = table[:0]
            self.index = held_index(table, n, index)
            return
        self.rows = torch.full((self.cap, w), SENTINEL, dtype=I32,
                               device=table.device)
        self.rows[:self.live] = table[self.base:self.base + self.live]
        # the first key of every next shard; all-ones past the last row
        first = torch.arange(1, self.ndev, device=table.device) * self.cap
        self.bounds = torch.where((first < n)[:, None],
                                  table[first.clamp(max=n - 1)], SENTINEL)
        self.index = RankIndex(self.rows, self.live)

    def chunks(self):
        """(first row, rows) of each step of a stage: the whole shard when
        there are windows to size, else ``sweep_chunk`` rows at a time."""
        step = self.cap if self.ndev > 1 else sweep_chunk(self.cap)
        for i in range(0, self.cap, step):
            yield i, self.rows[i:i + step]

    def gather(self, mesh, x: torch.Tensor) -> torch.Tensor:
        """(cap, ...) per-rank rows -> (N, ...) global rows in rank
        order."""
        allx = mesh.all_gather(x, DATA_AXIS)
        return torch.cat([allx[d, :self.n_loc[d]]
                          for d in range(self.ndev)])


def _sweep_dispatch(mesh, shard: _Shard, k: int, cap_send: int, stage):
    """One attempt of a stage's sweep: ``stage(i, rows, cands, grank,
    found)`` over the shard's rows (from row i) with the global ranks of
    their 8 neighbour candidates. Returns (the stage's per-chunk results,
    whether any rank's windows overflowed)."""
    outs, n_over = [], 0
    for i, rows in shard.chunks():
        cands = neighbor_candidates(rows, k)             # (R, 8, W) int64
        flat = as_rows(cands.reshape(-1, cands.shape[-1]))
        grank, found, over = exchange_rank(
            mesh, flat, shard.rows, shard.live, shard.base, shard.bounds,
            cap_send, shard.index)
        n_over = n_over + over
        outs.append(stage(i, rows, cands, grank.reshape(-1, 8),
                          found.reshape(-1, 8)))
    flag = (torch.as_tensor(n_over) > 0).to(I64).reshape(1)
    return outs, bool(mesh.pmax(flag.to(mesh.device)))


def _retrying(shard: _Shard, capacity_factor: float, dispatch):
    """Run ``dispatch(cap_send)`` until no send window overflows, doubling
    the windows after each overflow (the routing skew). Returns its
    results."""
    cap_send = _next_pow2(max(64, int(shard.cap * 8 / shard.ndev
                                      * capacity_factor)))
    while True:
        outs, ovf = dispatch(cap_send)
        if not ovf:
            return outs
        retries["postsolid"] += 1
        cap_send *= 2


def _adjacency_dispatch(mesh, shard: _Shard, k: int, cap_send: int):
    weights = 1 << torch.arange(8, dtype=I32, device=mesh.device)
    return _sweep_dispatch(
        mesh, shard, k, cap_send, lambda i, rows, cands, grank, found:
        (found.to(I32) * weights).sum(1).to(torch.uint8))


def distributed_adjacency(mesh, solid_limbs, k: int,
                          capacity_factor: float = 2.0,
                          index: RankIndex | None = None) -> np.ndarray:
    """Mesh-parallel precomputeAdjacency (Graph.cpp:3508-3610): the 8-bit
    neighbour mask of every solid k-mer, equal to the single-device
    ``debruijn.graph._adjacency_kernel`` sweep. ``solid_limbs``: the
    sorted (N, W) uint32 table (numpy, or limb rows); ``index``: its held
    ``RankIndex``, walked at one rank (as in every stage below)."""
    if len(solid_limbs) == 0:
        return np.zeros(0, np.uint8)
    shard = _Shard(mesh, solid_limbs, index)
    masks = _retrying(shard, capacity_factor, lambda cap_send:
                      _adjacency_dispatch(mesh, shard, k, cap_send))
    return shard.gather(mesh, torch.cat(masks)).cpu().numpy()


def _debloom_dispatch(mesh, shard: _Shard, k: int, cap_send: int, bloom):
    from ..collections.bloom import _bloom_contains

    words = bloom.words.to(mesh.device)
    w = shard.rows.shape[1]

    def stage(i, rows, cands, grank, found):
        flat = as_rows(cands.reshape(-1, w))
        hit = _bloom_contains(words, flat, bloom.size_bits, bloom.n_hash,
                              bloom.user_seed, bloom.kind, k).reshape(-1, 8)
        live = torch.arange(i, i + rows.shape[0],
                            device=rows.device) < shard.live
        return flat[(hit & ~found & live[:, None]).reshape(-1)]

    return _sweep_dispatch(mesh, shard, k, cap_send, stage)


def distributed_debloom_probe(mesh, solid_limbs, k: int, bloom,
                              capacity_factor: float = 2.0,
                              index: RankIndex | None = None) -> np.ndarray:
    """Mesh-parallel cFP candidate sweep (DebloomAlgorithm.cpp:270-300):
    the 8 neighbour extensions of every solid k-mer probed against the
    Bloom, minus true solids. Returns the (C, W) uint32 sorted distinct
    cFP rows, equal to the single-device ``kmer.debloom.build_debloom``
    sweep. The Bloom's words are on every rank's device (a few bits per
    k-mer, small beside the table)."""
    from ..kmer.debloom import _dedup_rows, rows_to_numpy

    n = len(solid_limbs)
    w = solid_limbs.shape[1] if n else 1
    if n == 0:
        return np.zeros((0, w), np.uint32)
    shard = _Shard(mesh, solid_limbs, index)
    hits = torch.cat(_retrying(shard, capacity_factor, lambda cap_send:
                               _debloom_dispatch(mesh, shard, k, cap_send,
                                                 bloom)))
    # every rank's hits, padded to the largest, then one sorted dedup
    sizes = mesh.all_gather(torch.tensor([hits.shape[0]],
                                         device=mesh.device)).reshape(-1)
    buf = torch.full((int(sizes.max()), w), SENTINEL, dtype=I32,
                     device=mesh.device)
    buf[:hits.shape[0]] = hits
    allh = mesh.all_gather(buf)
    allh = torch.cat([allh[d, :int(s)] for d, s in enumerate(sizes)])
    if allh.shape[0] == 0:
        return np.zeros((0, w), np.uint32)
    out_p, n_out, _ = _dedup_rows(
        allh, torch.ones(allh.shape[0], dtype=torch.bool,
                         device=allh.device), allh.shape[0])
    return rows_to_numpy(out_p[:, :int(n_out)].T)


def _cand_rank_dispatch(mesh, shard: _Shard, k: int, cap_send: int):
    from ..debruijn.unitigs import _cand_flips

    return _sweep_dispatch(
        mesh, shard, k, cap_send, lambda i, rows, cands, grank, found:
        torch.cat([grank, _cand_flips(rows, cands, k).to(I32)], dim=1))


def distributed_cand_ranks(mesh, solid_limbs, k: int,
                           capacity_factor: float = 2.0,
                           index: RankIndex | None = None):
    """Mesh-parallel neighbour ranks and strand flips for unitig
    construction (the ``unitigs.cand_sweep`` of the port: bcalm2's
    candidate lookups, bcalm_algo.cpp:592-680). Returns (ranks (N, 8)
    int32 GLOBAL table ranks or -1, flips (N, 8) int8), tensors on the
    mesh's device."""
    n = len(solid_limbs)
    if n == 0:
        return (torch.zeros((0, 8), dtype=I32, device=mesh.device),
                torch.zeros((0, 8), dtype=torch.int8, device=mesh.device))
    shard = _Shard(mesh, solid_limbs, index)
    parts = _retrying(shard, capacity_factor, lambda cap_send:
                      _cand_rank_dispatch(mesh, shard, k, cap_send))
    both = shard.gather(mesh, torch.cat(parts))
    return both[:, :8].contiguous(), both[:, 8:].to(torch.int8)


def _doubling_dispatch(mesh, par_loc: torch.Tensor, aux_loc: torch.Tensor,
                       rounds: int, op: str):
    """Pointer-doubling rounds as all-gather + local chase (bglue's
    union-find as label propagation over the mesh). ``op`` 'rank'
    accumulates chain ranks; 'min' propagates minima (cycle cuts)."""
    par, ax = par_loc, aux_loc
    for _ in range(rounds):
        full_par = mesh.all_gather(par, DATA_AXIS).reshape(-1)
        full_ax = mesh.all_gather(ax, DATA_AXIS).reshape(-1)
        nxt = full_ax[par.long()]
        ax = ax + nxt if op == "rank" else torch.minimum(ax, nxt)
        par = full_par[par.long()]
    return par, ax


def _pad_ids(arr: torch.Tensor, ndev: int, fill_self: bool):
    """Pad (m,) ids to a multiple of ndev: the padding ids point to
    themselves (``fill_self``) or are 0. Returns (padded, m)."""
    m = arr.shape[0]
    cap = max(1, -(-m // ndev)) * ndev
    out = torch.empty(cap, dtype=arr.dtype, device=arr.device)
    out[:m] = arr
    out[m:] = torch.arange(m, cap, dtype=arr.dtype, device=arr.device) \
        if fill_self else 0
    return out, m


def _rounds(m: int) -> int:
    return max(1, int(np.ceil(np.log2(max(m, 2)))) + 1)


def _local(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slice of a padded (ndev * c,) array."""
    c = x.shape[0] // mesh.shape[DATA_AXIS]
    me = mesh.coords[DATA_AXIS]
    return x[me * c:(me + 1) * c]


def _ids_on(mesh, parent) -> torch.Tensor:
    if not isinstance(parent, torch.Tensor):
        parent = torch.from_numpy(np.asarray(parent))
    return parent.to(mesh.device, I32)


def distributed_pointer_double(mesh, parent):
    """Distributed ``unitigs._pointer_double``: (root, rank) of every
    oriented node after full doubling; parent[v] == v marks a head.
    ``parent``: numpy or a tensor; returns int32 tensors on the mesh's
    device."""
    par, m = _pad_ids(_ids_on(mesh, parent), mesh.shape[DATA_AXIS],
                      fill_self=True)
    ids = torch.arange(par.shape[0], dtype=I32, device=par.device)
    rank0 = (par != ids).to(I32)
    roots, rank = _doubling_dispatch(mesh, _local(mesh, par),
                                     _local(mesh, rank0), _rounds(m), "rank")
    return (mesh.all_gather(roots, DATA_AXIS).reshape(-1)[:m],
            mesh.all_gather(rank, DATA_AXIS).reshape(-1)[:m])


def distributed_cut_cycles(mesh, parent):
    """Distributed ``unitigs._cut_cycles``: cut each pure cycle at its
    minimal member. Returns (parent', cut mask) tensors on the mesh's
    device."""
    parent = _ids_on(mesh, parent)
    m = parent.shape[0]
    par, _ = _pad_ids(parent, mesh.shape[DATA_AXIS], fill_self=True)
    minid0 = torch.arange(par.shape[0], dtype=I32, device=par.device)
    roots, minid = _doubling_dispatch(mesh, _local(mesh, par),
                                      _local(mesh, minid0), _rounds(m),
                                      "min")
    roots = mesh.all_gather(roots, DATA_AXIS).reshape(-1)[:m]
    minid = mesh.all_gather(minid, DATA_AXIS).reshape(-1)[:m]
    ids = torch.arange(m, dtype=I32, device=parent.device)
    is_head = parent == ids
    cut = ~is_head[roots.long()] & (minid == ids)
    return torch.where(cut, ids, parent), cut

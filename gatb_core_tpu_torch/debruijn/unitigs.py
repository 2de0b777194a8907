"""Unitig construction on the device: a BCALM2 equivalent.

Port of gatb_core_tpu/debruijn/unitigs.py. Reference: bcalm2/bcalm_algo.cpp
(minimizer-bucket compaction) + bglue_algo.cpp (union-find glue across
buckets) + LinkTigs.cpp (unitig links). Those structures exist to bound
memory on a CPU; here the whole solid-k-mer set is resident on the device,
so unitig compaction is the classic parallel list-ranking problem:

  1. oriented nodes: each canonical k-mer i yields (i,+) and (i,-)
  2. succ(u) = unique out-neighbor v of u with out-degree(u) == 1 and
     in-degree(v) == 1 (the BCALM compactable-edge rule)
  3. unitigs = maximal succ-chains, found by pointer doubling
     (O(log chain-length) gather rounds)
  4. cycles (isolated circular paths) are cut at their minimal oriented
     node, matching the reference's deterministic circular handling
     (bglue_algo.cpp:216-330 determine_order_sequences handles circular)
  5. each unitig appears as two twin (RC) chains; the canonical
     representative is kept

Candidate ranks come from one rank search per sweep chunk
(``ops/rank_search.rank_rows``, the hand-written kernel); the successor
rule, the cycle cut and the list ranking are torch ops on the device, the
doubling rounds a fixed count with no host sync inside the loop. The JAX
package pads every chain array to a power of two so its programs compile
once per capacity; nothing here compiles, so nothing is padded, and the
round count ``ceil(log2(m)) + 1`` over m entries equals the padded one.

Outputs unitig sequences, per-unitig k-mer counts / mean abundance (the
``km:f:`` FASTA annotation, bglue_algo.cpp output convention) and
node->unitig position maps used for links and the unitig graph, as numpy
arrays with the JAX package's dtypes. With a ``mesh`` the candidate sweep,
the cycle cut and the list ranking run over its ranks
(parallel/postsolid.py), with the same result.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..kmer.debloom import rows_to_device
from ..ops.bitpack import as_u32_i64
from ..ops.neighbor_ops import (neighbor_candidates, revcomp_limbs, shl2_or,
                                shr2_or_top)

I32 = torch.int32
I64 = torch.int64


@dataclass
class UnitigSet:
    """Compact unitig representation.

    sequences: list of unitig strings (length >= k)
    mean_abundance: (U,) float32 per-unitig mean k-mer count
    kmer_counts: (U,) int32 number of k-mers per unitig
    node_unitig: (N,) int32 unitig id of every solid k-mer
    node_pos: (N,) int32 position of the k-mer within its unitig
    node_strand: (N,) int8 0 if the k-mer's canonical form appears forward
                 in the unitig, 1 if reversed
    """

    sequences: list
    mean_abundance: np.ndarray
    kmer_counts: np.ndarray
    node_unitig: np.ndarray
    node_pos: np.ndarray
    node_strand: np.ndarray

    @property
    def nb_unitigs(self) -> int:
        return len(self.sequences)


def _popcount4(x: torch.Tensor) -> torch.Tensor:
    """Popcount of the low 4 bits of an integer tensor."""
    x = x & 0x0F
    x = (x & 0x55) + ((x >> 1) & 0x55)
    return (x & 0x33) + ((x >> 2) & 0x33)


def _oriented_succ(adj: torch.Tensor, cand_ranks: torch.Tensor,
                   cand_flip: torch.Tensor) -> torch.Tensor:
    """The successor array over oriented nodes.

    adj: (N,) uint8 adjacency masks (bits 0-3 out by nt, 4-7 in by nt)
    cand_ranks: (N, 8) int32 rank of each neighbor candidate (-1 if absent)
    cand_flip: (N, 8) int8 1 if the neighbor is entered in reverse strand
    Returns succ: (2N,) int32 oriented successor or -1.

    Oriented id: 2*i + s (s=0: canonical forward, s=1: reverse).
    out-neighbors of (i,0) are adjacency bits 0-3 (candidate slots 0-3);
    out-neighbors of (i,1) are the reverse strand's extensions, which are
    the in-candidates with complemented nucleotide: slot 4 + (nt^2). A
    candidate absent from the table (rank -1) gives no successor.
    """
    adj = adj.to(I32)
    n = adj.shape[0]
    out_bits = adj & 0x0F
    in_bits = (adj >> 4) & 0x0F
    outdeg_f = _popcount4(out_bits)
    outdeg_r = _popcount4(in_bits)
    ranks = cand_ranks.to(I32)
    flips = cand_flip.to(I32)
    succ_f = torch.full((n,), -1, dtype=I32, device=adj.device)
    succ_r = torch.full((n,), -1, dtype=I32, device=adj.device)
    for nt in range(4):
        # forward orientation: the unique out nt (when outdeg == 1)
        sel = (outdeg_f == 1) & (out_bits == (1 << nt))
        succ_f = torch.where(sel & (ranks[:, nt] >= 0),
                             2 * ranks[:, nt] + flips[:, nt], succ_f)
        # reverse orientation: out-extension with nt == in-candidate slot
        # nt^2, entered in the opposite sense of that candidate
        slot = 4 + (nt ^ 2)
        sel_r = (outdeg_r == 1) & (in_bits == (1 << (nt ^ 2)))
        succ_r = torch.where(sel_r & (ranks[:, slot] >= 0),
                             2 * ranks[:, slot] + (1 - flips[:, slot]),
                             succ_r)
    return torch.stack([succ_f, succ_r], dim=1).reshape(2 * n)


def _indegree_oriented(adj: torch.Tensor) -> torch.Tensor:
    """True graph in-degree of every oriented node, from adjacency bits:
    indeg of (i,+) = popcount(in bits); indeg of (i,-) = popcount(out
    bits) (an in-edge of the reverse orientation is an out-edge of the
    forward). Returns (2N,) int32."""
    adj = adj.to(I32)
    return torch.stack([_popcount4(adj >> 4), _popcount4(adj)],
                       dim=1).reshape(-1)


def _rounds(m: int) -> int:
    """Doubling rounds over m entries: ceil(log2(m)) + 1 (at least 2), the
    count of the JAX package's power-of-two padded arrays."""
    return max(1, (max(m, 2) - 1).bit_length()) + 1


def _pointer_double(parent: torch.Tensor):
    """List ranking: returns (root, rank) after full pointer doubling.

    parent[v] == v marks a head. Cycles must have been cut beforehand.
    int32 in, int32 out, on the parent's device."""
    par = parent.to(I32)
    m = par.shape[0]
    ids = torch.arange(m, dtype=I32, device=par.device)
    rank = (par != ids).to(I32)
    for _ in range(_rounds(m)):
        rank = rank + rank.index_select(0, par)
        par = par.index_select(0, par)
    return par, rank


def _cut_cycles(parent: torch.Tensor):
    """Cut each pure cycle at its minimal member (deterministic). Returns
    (parent with the cut members made heads, cut mask)."""
    par = parent.to(I32)
    m = par.shape[0]
    ids = torch.arange(m, dtype=I32, device=par.device)
    roots, minid = _min_double(par, ids)
    # a node is in a cycle iff its final root is not a head
    is_head = par == ids
    cut = ~is_head[roots.to(I64)] & (minid == ids)
    return torch.where(cut, ids, par), cut


def _min_double(par: torch.Tensor, ids: torch.Tensor):
    """Pointer doubling carrying the minimum id seen along each path."""
    mn = ids
    for _ in range(_rounds(par.shape[0])):
        mn = torch.minimum(mn, mn.index_select(0, par))
        par = par.index_select(0, par)
    return par, mn


def _chain_parents(ranks, flips, adj, n) -> torch.Tensor:
    """Oriented successors (BCALM compactable-edge rule) turned into
    predecessor links: pred(v) = twin(succ(twin(v))), kept only where the
    successor relation is symmetric; a chain's head and every row >= 2n
    points to itself. Returns (2C,) int32."""
    C = adj.shape[0]
    succ = _oriented_succ(adj, ranks, flips)
    ids = torch.arange(2 * C, dtype=I32, device=adj.device)
    twin = ids ^ 1
    indeg = _indegree_oriented(adj)
    tgt_ok = succ >= 0
    tgtc = succ.clamp(0, 2 * C - 1).to(I64)
    bad = tgt_ok & ((indeg[tgtc] != 1) | (succ == ids) | (succ == twin))
    succ = torch.where(bad, torch.full_like(succ, -1), succ)
    succ_twin = succ.reshape(C, 2).flip(1).reshape(2 * C)
    pred = torch.where(succ_twin >= 0, succ_twin ^ 1, ids)
    has_pred = pred != ids
    sym_ok = succ[pred.clamp(0, 2 * C - 1).to(I64)] == ids
    pred = torch.where(has_pred & ~sym_ok, ids, pred)
    return torch.where(ids >= 2 * int(n), ids, pred)


def _succ_cut_rank(ranks, flips, adj, n, mark=None, mesh=None):
    """Successor rule + predecessor chains + cycle cutting + full
    pointer-doubling list ranking, all on the device of the inputs.

    ranks/flips: (C, 8) int32/int8 candidate ranks and strand flips;
    adj: (C,) uint8 adjacency masks; n: live row count (rows >= n are
    padding, as in the JAX package's padded tables); ``mark``: called with
    each step's name as it is enqueued (``_StepClock``); ``mesh``: the
    cycle cut and the ranking run over its ranks (parallel/postsolid.py).
    Returns (roots (2C,) int32, rank (2C,) int32, cut (2C,) bool);
    rows >= 2n are self-loops."""
    mark = mark or (lambda name: None)
    pred = _chain_parents(ranks, flips, adj, n)
    mark("successor_rule")
    if mesh is None:
        parent, cut = _cut_cycles(pred)
        mark("cycle_cut")
        roots, rank = _pointer_double(parent)
    else:
        from ..parallel.postsolid import (distributed_cut_cycles,
                                          distributed_pointer_double)

        parent, cut = distributed_cut_cycles(mesh, pred)
        mark("cycle_cut")
        roots, rank = distributed_pointer_double(mesh, parent)
    mark("list_ranking")
    return roots, rank, cut


class _StepClock:
    """Time of each step of a build, into ``out`` (milliseconds by step
    name): CUDA events on a card, read once at ``done`` (no sync between
    steps), the host clock on the CPU. With ``out`` None it records
    nothing."""

    def __init__(self, device: torch.device, out: dict | None):
        self._out = out
        self._cuda = device.type == "cuda"
        self._marks = []
        self("start")

    def __call__(self, name: str) -> None:
        if self._out is None:
            return
        if self._cuda:
            stamp = torch.cuda.Event(enable_timing=True)
            stamp.record()
        else:
            stamp = time.perf_counter()
        self._marks.append((name, stamp))

    def done(self) -> None:
        if self._out is None:
            return
        if self._cuda:
            torch.cuda.synchronize()
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            self._out[name] = a.elapsed_time(b) if self._cuda \
                else (b - a) * 1e3


def _on(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A numpy array or a tensor as a tensor of ``dtype`` on ``dev``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=dev, dtype=dtype)


def cand_sweep(table: torch.Tensor, n: int, k: int,
               chunk: int | None = None, index=None):
    """``_cand_ranks_flips`` of every row of a device table: (ranks (n, 8)
    int32, flips (n, 8) int8) on its device. One ``rank_rows`` launch per
    chunk: the whole table up to 2^22 rows, else chunks of ``sweep_chunk``
    rows (of ``chunk`` rows where given), which bound the 8C-row search and
    its candidates on giant tables; the result does not depend on it.
    Every chunk walks one ``RankIndex`` of the table: ``index`` where the
    caller holds it, else one built here."""
    from ..ops.rank_search import held_index
    from ..ops.sortops import sweep_chunk

    csize = chunk or (n if n <= 1 << 22 else sweep_chunk(n))
    index = held_index(table, n, index)
    ranks = torch.empty((n, 8), dtype=I32, device=table.device)
    flips = torch.empty((n, 8), dtype=torch.int8, device=table.device)
    for i in range(0, n, csize):
        ranks[i:i + csize], flips[i:i + csize] = _cand_ranks_flips(
            table[i:i + csize], table, n, k, index)
    return ranks, flips


def build_unitigs(solid_limbs, solid_counts, adjacency, k: int,
                  chunk: int | None = None, mesh=None, device="cuda",
                  timings: dict | None = None, precomputed=None,
                  lazy_sequences: bool = False, index=None) -> UnitigSet:
    """Compact the solid-k-mer graph into unitigs (bcalm2+bglue+links
    equivalent, UnitigsConstructionAlgorithm.cpp:90-117) on ``device``.
    ``solid_limbs`` is the sorted (N, W) uint32 table (numpy, or limb rows
    already on the device); ``solid_counts`` and ``adjacency`` numpy arrays
    or tensors. The candidates are ranked by ``cand_sweep`` unless
    ``precomputed`` gives them: (N, 8) int32 ranks and int8 flips as device
    tensors (Simplifications' remapped sweep). ``lazy_sequences`` defers
    the emit to the first access of a sequence (``LazySequences``).
    ``timings``: a dict that receives the milliseconds of each step
    (``candidate_ranks``, ``successor_rule``, ``cycle_cut``,
    ``list_ranking``, ``node_maps``, ``emit``; ``_StepClock``).
    ``index``: the table's ``RankIndex`` for the sweep, where the caller
    holds one. With ``mesh``, the candidate sweep and the list ranking run
    over its ranks (parallel/postsolid.py: ``distributed_cand_ranks``
    unless ``precomputed`` is given, ``distributed_cut_cycles``,
    ``distributed_pointer_double``), with the same result."""
    table = rows_to_device(solid_limbs, device)
    n = table.shape[0]
    if n == 0:
        return UnitigSet([], np.zeros(0, np.float32), np.zeros(0, np.int32),
                         np.zeros(0, np.int32), np.zeros(0, np.int32),
                         np.zeros(0, np.int8))
    dev = table.device
    adj = _on(adjacency, torch.uint8, dev)
    clock = _StepClock(dev, timings)

    # --- oriented chains ------------------------------------------------
    if precomputed is not None:
        ranks, flips = precomputed
    elif mesh is not None:
        from ..parallel.postsolid import distributed_cand_ranks

        ranks, flips = distributed_cand_ranks(mesh, table, k, index=index)
    else:
        ranks, flips = cand_sweep(table, n, k, chunk, index)
    clock("candidate_ranks")
    roots, rank, cycle_cut = _succ_cut_rank(ranks, flips, adj, n, clock,
                                            mesh)
    del ranks, flips
    ids = torch.arange(2 * n, dtype=I64, device=dev)
    twin = ids ^ 1

    # --- chains + twin dedup ------------------------------------------
    # chain id = root oriented node; the twin (RC) chain's root is the
    # twin of this chain's tail. Keep one representative per twin pair.
    uniq_roots, root_index, counts_per_chain = torch.unique(
        roots.to(I64), sorted=True, return_inverse=True, return_counts=True)
    chain_len = counts_per_chain[root_index]
    is_tail = rank.to(I64) == chain_len - 1
    twin_root_of = torch.zeros_like(uniq_roots)
    twin_root_of[root_index[is_tail]] = twin[is_tail]
    # chains cut from cycles: the twin chain is the twin cycle cut at the
    # twin of OUR head (see _cut_cycles minima argument), not twin(tail)
    cyclic_chain = cycle_cut[uniq_roots]
    twin_root_of = torch.where(cyclic_chain, uniq_roots ^ 1, twin_root_of)
    keep_chain = uniq_roots <= twin_root_of

    # --- per-node unitig assignment ------------------------------------
    kept_ids = torch.cumsum(keep_chain.to(I64), 0) - 1
    sel = keep_chain[root_index]
    base_ids = ids[sel] >> 1
    node_unitig = torch.full((n,), -1, dtype=I32, device=dev)
    node_pos = torch.zeros((n,), dtype=I32, device=dev)
    node_strand = torch.zeros((n,), dtype=torch.int8, device=dev)
    node_unitig[base_ids] = kept_ids[root_index[sel]].to(I32)
    node_pos[base_ids] = rank[sel].to(I32)
    node_strand[base_ids] = (ids[sel] & 1).to(torch.int8)

    # --- abundance: a float64 sum over integer counts (exact), the mean
    # cast to float32 as in the JAX package ------------------------------
    lengths = counts_per_chain[keep_chain]
    nb_unitigs = lengths.shape[0]
    valid = node_unitig >= 0
    uid = node_unitig[valid].to(I64)
    kmer_counts = torch.zeros((nb_unitigs,), dtype=I64, device=dev)
    kmer_counts.index_add_(0, uid, torch.ones_like(uid))
    sum_ab = torch.zeros((nb_unitigs,), dtype=I64, device=dev)
    counts = _on(solid_counts, I64, dev)
    sum_ab.index_add_(0, uid, counts[valid])
    mean_ab = (sum_ab.to(torch.float64)
               / kmer_counts.clamp(min=1).to(torch.float64)).to(torch.float32)

    clock("node_maps")

    # --- emit sequences -------------------------------------------------
    if lazy_sequences:
        # the emit reads its own copies of the node maps, on the device:
        # on the CPU the UnitigSet's arrays below share memory with them
        maps = (node_unitig.clone(), node_pos.clone(), node_strand.clone())
        seqs = LazySequences(
            lambda: _emit_sequences(table, k, *maps, nb_unitigs, lengths),
            lengths.cpu().numpy() + k - 1)
    else:
        seqs = _emit_sequences(table, k, node_unitig, node_pos, node_strand,
                               nb_unitigs, lengths)
    clock("emit")
    clock.done()
    return UnitigSet(seqs, mean_ab.cpu().numpy(),
                     kmer_counts.to(I32).cpu().numpy(),
                     node_unitig.cpu().numpy(), node_pos.cpu().numpy(),
                     node_strand.cpu().numpy())


def _cand_ranks_flips(nodes, table, n_table, k: int, index=None):
    """Rank of each of the 8 neighbor candidates of every node in the
    table (-1 if absent) and its strand flip: (ranks (C, 8) int32, flips
    (C, 8) int8). One ``rank_rows`` search over the 8C candidates (through
    the table's ``index`` where the caller holds one)."""
    from ..ops.sortops import rank_join_traced

    cands = neighbor_candidates(nodes, k)   # (C, 8, W)
    c, _, w = cands.shape
    pos, found = rank_join_traced(table, cands.reshape(c * 8, w), n_table,
                                  index=index)
    ranks = torch.where(found, pos, torch.full_like(pos, -1)).reshape(c, 8)
    return ranks.to(I32), _cand_flips(nodes, cands, k)


def _cand_flips(nodes, cands, k: int) -> torch.Tensor:
    """(C, 8) int8 strand flips of the neighbor candidates ``cands``
    (C, 8, W) of ``nodes``: the candidate equals its canonical form iff
    the extension's forward form is canonical; flip=1 otherwise.
    Out-candidates (slots 0-3): fwd ext = (f<<2)|nt; in-candidates
    (slots 4-7): fwd ext = (f>>2)|nt<<2(k-1)."""
    f = as_u32_i64(nodes)
    flips = torch.empty((f.shape[0], 8), dtype=torch.int8, device=f.device)
    for nt in range(4):
        flips[:, nt] = (shl2_or(f, nt, k) != cands[:, nt]).any(dim=-1)
        flips[:, 4 + nt] = (shr2_or_top(f, nt, k)
                            != cands[:, 4 + nt]).any(dim=-1)
    return flips


class PackedSequences:
    """2-bit packed unitig store (the reference's packed_unitigs blob +
    dag_vector offsets, GraphUnitigs.cpp:520-660): ~4x+ less RAM than
    Python strings, decoded to str lazily on access. Duck-types a list of
    strings (len / index / iterate). Host numpy, as in the JAX package."""

    _DECODE = np.frombuffer(b"ACTG", dtype=np.uint8)

    def __init__(self, packed: np.ndarray, byte_offsets: np.ndarray,
                 lengths: np.ndarray):
        self._packed = packed            # (B,) uint8, 4 codes/byte
        self._byte_offsets = byte_offsets  # (U+1,) byte offset per unitig
        self._lengths = lengths          # (U,) base lengths

    @classmethod
    def from_ascii_buffer(cls, chars: np.ndarray,
                          offsets: np.ndarray) -> "PackedSequences":
        lengths = np.diff(offsets).astype(np.int64)
        code = np.zeros(256, np.uint8)
        code[ord("C")] = 1
        code[ord("T")] = 2
        code[ord("G")] = 3
        codes = code[chars]
        nbytes = (lengths + 3) // 4
        byte_offsets = np.zeros(len(lengths) + 1, np.int64)
        byte_offsets[1:] = np.cumsum(nbytes)
        # scatter each base to its byte-aligned position in the blob
        total = int(lengths.sum())
        within = np.arange(total, dtype=np.int64) \
            - np.repeat(offsets[:-1].astype(np.int64), lengths)
        dest = np.repeat(byte_offsets[:-1] * 4, lengths) + within
        padded = np.zeros(int(byte_offsets[-1]) * 4, np.uint8)
        padded[dest] = codes
        q = padded.reshape(-1, 4)
        packed = ((q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2)
                  | q[:, 3]).astype(np.uint8)
        return cls(packed, byte_offsets, lengths)

    def lengths(self) -> np.ndarray:
        return self._lengths

    def nbytes(self) -> int:
        return self._packed.nbytes + self._byte_offsets.nbytes \
            + self._lengths.nbytes

    def __len__(self) -> int:
        return len(self._lengths)

    def __getitem__(self, i: int) -> str:
        if isinstance(i, (slice, list, np.ndarray)):
            idx = range(*i.indices(len(self))) if isinstance(i, slice) \
                else np.atleast_1d(i)
            return [self[int(j)] for j in idx]
        b = self._packed[self._byte_offsets[i]:self._byte_offsets[i + 1]]
        codes = np.empty(len(b) * 4, np.uint8)
        codes[0::4] = b >> 6
        codes[1::4] = (b >> 4) & 3
        codes[2::4] = (b >> 2) & 3
        codes[3::4] = b & 3
        return self._DECODE[codes[:self._lengths[i]]].tobytes() \
            .decode("ascii")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        return list(self) == list(other)


class LazySequences:
    """Deferred ``_emit_sequences``: serves lengths at once (a unitig's
    base length is nk + k - 1, no decode needed) and spells the
    PackedSequences on first element access. Simplify's tip, EC and bulge
    passes never spell a sequence, so their recompactions skip the emit."""

    def __init__(self, emit, lengths):
        self._emit = emit
        self._lengths = np.asarray(lengths, np.int64)
        self._mat = None

    def _materialize(self):
        if self._mat is None:
            self._mat = self._emit()
            self._emit = None
        return self._mat

    def lengths(self) -> np.ndarray:
        return self._lengths

    def __len__(self) -> int:
        return len(self._lengths)

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __eq__(self, other):
        return list(self) == list(other)


def _emit_sequences(table, k, node_unitig, node_pos, node_strand,
                    nb_unitigs, lengths):
    """Spell the unitigs on the device from per-node assignments, then pack
    them on the host.

    The last character of each node's *oriented* k-mer comes from the limb
    rows directly (low 2 bits for forward strand, complemented top 2 bits
    for reverse); only the U head k-mers (pos == 0) are decoded in full.
    All arguments are tensors on the table's device (``lengths``: the
    k-mers of each kept unitig)."""
    if nb_unitigs == 0:
        return PackedSequences(np.zeros(0, np.uint8),
                               np.zeros(1, np.int64), np.zeros(0, np.int64))
    dev = table.device
    lengths = lengths.to(I64)
    offsets = torch.zeros((nb_unitigs + 1,), dtype=I64, device=dev)
    offsets[1:] = torch.cumsum(lengths + k - 1, 0)
    chars = torch.zeros((int(offsets[-1]),), dtype=torch.uint8, device=dev)
    nts = torch.tensor(list(b"ACTG"), dtype=torch.uint8, device=dev)

    valid = node_unitig >= 0
    uids = node_unitig[valid].to(I64)
    poss = node_pos[valid].to(I64)
    strands = node_strand[valid]
    limbs = as_u32_i64(table[valid])

    # last char of the oriented k-mer
    low2 = limbs[:, -1] & 3
    bitpos = 2 * k - 2
    jtop = limbs.shape[1] - 1 - bitpos // 32
    top2 = (limbs[:, jtop] >> (bitpos % 32)) & 3
    last = torch.where(strands == 0, low2, top2 ^ 2)

    ext = poss > 0
    chars[offsets[uids[ext]] + k - 1 + poss[ext]] = nts[last[ext]]

    # heads: full oriented k-mer decode, k steps over all heads at once
    head = poss == 0
    hl = limbs[head]
    rc = revcomp_limbs(hl, k)
    ol = torch.where(strands[head][:, None] == 0, hl, rc)
    base = offsets[uids[head]]
    w32 = ol.shape[1]
    for i in range(k):
        bitpos = 2 * (k - 1 - i)
        code = (ol[:, w32 - 1 - bitpos // 32] >> (bitpos % 32)) & 3
        chars[base + i] = nts[code]
    # packed 2-bit store (no Python string per unitig, decoded lazily)
    return PackedSequences.from_ascii_buffer(chars.cpu().numpy(),
                                             offsets.cpu().numpy())

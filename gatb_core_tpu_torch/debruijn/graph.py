"""De Bruijn graph over the solid k-mer set (GraphTemplate equivalent).

Port of gatb_core_tpu/debruijn/graph.py (reference: debruijn/impl/
Graph.hpp:540 / Graph.cpp).

The reference's node membership is (Bloom AND not-cFP), which by
construction of the cFP set equals exact membership in the solid set for
every query on the traversal path (neighbors of contained nodes). Here
membership is exact by design: a rank search over the sorted solid table
(collections/sortedset, the ``rank_rows`` kernel of ops/rank_search.py),
with the Bloom + cFP oracle as a second mode, so graph topology is
identical to the reference's for the same solid set.

Node identity: canonical k-mer value, represented as (W,) uint32 big-endian
limbs. Node index (nodeMPHFIndex, Graph.hpp:924) = rank in the sorted solid
table, always answered by the rank search: the MPHF stage builds and saves
the BooPHF (whose codes are the same ranks), but its query is the slower of
the two on the device. Per-node arrays (abundance, state, adjacency) are
indexed by it.

The build is the reference's state machine (Graph.cpp build_visitor_solid +
build_visitor_postsolid): configuration -> counting -> [mphf -> bloom ->
debloom -> branching], persisted stage-by-stage into HDF5 storage
(Graph.hpp:1010-1030 state bits); ``Graph.load`` resumes after the
completed stages.

The solid table, the MPHF, the Bloom words and the cFP sets live on
``device`` (default ``"cuda"``; nothing falls back to the CPU). Queries
take and return numpy arrays, as in the JAX package. With a ``mesh``
(parallel/mesh.py) the postsolid stages (adjacency, debloom, unitig
construction, the simplification sweeps) run range-sharded over its ranks
(parallel/postsolid.py) on the mesh's device, with the same results.
"""

from __future__ import annotations

import numpy as np
import torch

from ..collections.abundance import dediscretize, discretize
from ..collections.sortedset import SortedKmerSet
from ..kmer.counting import CountConfig, SortingCount
from ..kmer.debloom import (BloomCfpContainer, CascadeCFP, DebloomResult,
                            build_debloom, rows_to_device)
from ..kmer.model import canonical, kmer_to_string, string_to_kmer
from ..misc import time_info
from ..ops.kmer_ops import kmers_to_py, nb_limbs, py_to_limbs
from ..ops.neighbor_ops import neighbor_candidates, neighbor_masks
from ..ops.rank_search import as_rows
from ..storage import hdf5 as storage_mod
from ..storage.hdf5 import (STATE_ADJACENCY_DONE, STATE_BLOOM_DONE,
                            STATE_BRANCHING_DONE, STATE_DEBLOOM_DONE,
                            STATE_MPHF_DONE, STATE_SORTING_COUNT_DONE,
                            Storage)


def _adjacency_kernel(nodes: torch.Tensor, table: torch.Tensor, k: int,
                      n_table=None, index=None) -> torch.Tensor:
    """8-bit adjacency masks for a batch of nodes against the solid table:
    the membership of each node's 8 neighbour candidates, packed
    (``ops.neighbor_ops.neighbor_masks``: one kernel launch on the card,
    through the table's ``index`` where the caller holds one). The
    reference probes its membership oracle per neighbor
    (Graph.cpp:3508-3610). nodes: (N, W) limbs; table: (C, W) limbs, the
    first ``n_table`` rows live. Returns (N,) uint8 on the nodes' device."""
    if n_table is None:
        n_table = table.shape[0]
    return neighbor_masks(as_rows(nodes), as_rows(table), n_table, k,
                          index=index)


class Graph:
    """Node-centric de Bruijn graph (batched, device-resident queries)."""

    def __init__(self, kmer_size: int, solid_limbs: np.ndarray,
                 solid_counts: np.ndarray, storage: Storage | None = None,
                 info: dict | None = None, mesh=None, device="cuda"):
        self.kmer_size = kmer_size
        #: optional parallel.mesh.Mesh: the postsolid stages run
        #: range-sharded over its ranks; None = single-device sweeps
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else torch.device(device)
        self._k = kmer_size
        self._w = nb_limbs(kmer_size)
        self.solid_limbs = np.asarray(solid_limbs, np.uint32)
        if self.solid_limbs.ndim != 2:
            self.solid_limbs = self.solid_limbs.reshape(-1, self._w)
        self.solid_counts = np.asarray(solid_counts, np.int32)
        # the one device copy of the solid table, (N, W) int32 storage
        self._set = SortedKmerSet(
            rows_to_device(self.solid_limbs, self.device),
            len(self.solid_limbs))
        self.storage = storage
        self.info = dict(info or {})
        n = len(self.solid_limbs)
        # per-node maps (indexed by rank): abundance (8-bit discretized),
        # state byte (bit0: deleted, bits1+: user marks), adjacency cache
        self.abundance_codes = discretize(self.solid_counts)
        self.node_state = np.zeros(n, np.uint8)
        self._adjacency: np.ndarray | None = None
        self._branching: np.ndarray | None = None
        self._mphf = None             # BooPHF of the MPHF stage
        self._debloom = None          # DebloomResult (bloom + cFP)
        self._container = None        # BloomCfpContainer membership oracle
        self.membership_mode = "exact"  # or "bloom_cfp"

    # ------------------------------------------------------------------
    # creation / loading
    # ------------------------------------------------------------------
    @classmethod
    def create(cls, bank=None, kmer_size: int = 31, abundance_min=2,
               abundance_max=2**31 - 1, minimizer_size: int = 10,
               output: str | None = None, histo_max: int = 10000,
               batch_reads: int = 1024, batch_len: int = 256,
               build_branching: bool = True, nb_passes: int = 1,
               bloom_kind: str = "neighbor", debloom_kind: str = "cascading",
               mphf_kind: str = "boophf",
               repartition: bool = True,
               superbatch_rows: int | None = None, mesh=None,
               table_budget_bytes: int | None = None,
               device: str = "cuda") -> "Graph":
        """Graph build from a bank (Graph::create equivalent):
        config -> repartitor -> DSK (build_visitor_solid, Graph.cpp:286-433),
        each stage persisted + state-bit-stamped, then the postsolid stages
        (build_visitor_postsolid, Graph.cpp:433-605). Kind defaults mirror
        the reference enums (misc/api/Enums.hpp:73-271); 'none' skips a
        stage. With ``mesh`` the count runs on the mesh's device of every
        rank and the postsolid stages run sharded, as in the JAX
        package."""
        if mesh is not None:
            device = mesh.device
        cfg = CountConfig(kmer_size=kmer_size, abundance_min=abundance_min,
                          abundance_max=abundance_max,
                          minimizer_size=minimizer_size, histo_max=histo_max,
                          batch_reads=batch_reads, batch_len=batch_len,
                          nb_passes=nb_passes, device=device)
        if superbatch_rows is not None:
            cfg.superbatch_rows = superbatch_rows
        if table_budget_bytes is not None:
            cfg.table_budget_bytes = table_budget_bytes
        # RepartitorAlgorithm (Graph.cpp:384) -> /minimizers: the census
        # over a bank sample runs on a background thread CONCURRENTLY with
        # the counting below
        rep_thread = rep_box = None
        if output is not None and repartition:
            import threading

            from ..kmer.repartition import build_repartitor

            rep_box = [None, None]

            def _rep():
                try:
                    nb_parts = max(1, _plan_partitions(
                        bank, kmer_size, minimizer_size))
                    rep_box[0] = build_repartitor(bank, kmer_size,
                                                  nb_parts,
                                                  minimizer_size,
                                                  device=device)
                except BaseException as e:
                    rep_box[1] = e

            rep_thread = threading.Thread(target=_rep, daemon=True)
            rep_thread.start()

        # Algorithm contract: run() wraps execute() with exec_time + the
        # stopwatch tree (executeAlgorithm, Graph.cpp:242-262)
        dsk = SortingCount(cfg)
        result = dsk.run(bank)
        result.info.update({k: v for k, v in dsk.get_info().items()
                            if k == "exec_time"})

        storage = None
        if output is not None:
            storage = Storage(output, "w")
            storage_mod.save_config(storage, result.info)
            storage_mod.save_solid(storage, result.solid_kmers,
                                   result.solid_counts, kmer_size)
            storage_mod.save_histogram(storage, result.histogram)
            if rep_thread is not None:
                rep_thread.join()
                if rep_box[1] is not None:
                    raise rep_box[1]
                rep_box[0].save(storage)

        with time_info.span("graph.build", sync=True) as sp:
            graph = cls(kmer_size, result.solid_kmers, result.solid_counts,
                        storage, result.info, mesh=mesh, device=device)
            sp.count(limbs=graph._w, nodes=graph.nb_nodes)
            graph.build_postsolid(bloom_kind=bloom_kind,
                                  debloom_kind=debloom_kind,
                                  mphf_kind=mphf_kind,
                                  build_branching=build_branching)
        if storage is not None:
            storage.flush()
        return graph

    def build_postsolid(self, bloom_kind: str = "neighbor",
                        debloom_kind: str = "cascading",
                        mphf_kind: str = "boophf",
                        build_branching: bool = True) -> None:
        """build_visitor_postsolid (Graph.cpp:433-605): MPHF -> Bloom ->
        Debloom -> Branching, persisting each stage. Per-stage wall
        times land in `info` as reference-style `time.` properties
        (the getInfo 'time' tree each Algorithm emits,
        Algorithm.cpp:56-62 pattern), also when every stage is 'none'.
        'boophf' and 'emphf' both build the BooPHF, as in the JAX
        package."""
        ti = time_info.TimeInfo()
        if mphf_kind != "none":
            with ti.section("mphf", span="graph.mphf"):
                self.build_mphf()  # MPHFAlgorithm (Graph.cpp:488-498)
                if self.storage is not None:
                    storage_mod.save_mphf(self.storage, self._mphf,
                                          self.abundance_codes,
                                          solid_limbs=self.solid_limbs,
                                          kmer_size=self._k)
        if bloom_kind != "none" and debloom_kind != "none":
            # BloomAlgorithm + DebloomAlgorithm (Graph.cpp:517-556)
            with ti.section("debloom", span="graph.debloom"):
                deb = build_debloom(self._padded_table(), self._k,
                                    cascading=debloom_kind == "cascading",
                                    bloom_kind=bloom_kind, mesh=self.mesh,
                                    device=self.device,
                                    index=self._sweep_index())
                self._debloom = deb
                self._container = BloomCfpContainer(deb)
                self.info.update(deb.info)
                if self.storage is not None:
                    storage_mod.save_bloom(self.storage, deb.bloom)
                    storage_mod.save_debloom(self.storage, deb.cfp,
                                             self._k, kind=deb.kind,
                                             cascade=deb.cascade)
        if build_branching:
            with ti.section("branching", span="graph.branching"):
                # BranchingAlgorithm (Graph.cpp:572-582)
                self.branching_nodes()
        self.info.update(ti.get_properties("postsolid_time"))

    @classmethod
    def load(cls, uri: str, device="cuda") -> "Graph":
        """Reopen a persisted graph (either package's file, or the
        reference's layout); resumes after completed stages
        (configure_visitor equivalent, Graph.cpp:766-802). The table, the
        MPHF and the Bloom words go to ``device``."""
        storage = Storage(uri, "a")
        if not storage.check_state(STATE_SORTING_COUNT_DONE):
            raise ValueError(f"{uri}: no completed counting stage")
        limbs, counts = storage_mod.load_solid(storage)
        k = storage_mod.prop_int(storage, "kmer_size")
        graph = cls(k, limbs, counts, storage, device=device)
        if storage.check_state(STATE_BRANCHING_DONE):
            # a plain dataset read, as in the JAX package: at k > 32 a
            # reference file's int128 value field does not map to numpy
            # (ROADMAP C)
            rec = storage.group("branching").get_dataset("nodes")
            if rec is not None:
                graph._branching = storage_mod.words64_to_limbs(
                    rec["value"], graph._w)
                graph._branching_counts = \
                    rec["abundance"].astype(np.int32)
        if storage.check_state(STATE_ADJACENCY_DONE):
            adj = storage.group("adjacency").get_dataset("masks")
            if adj is not None:
                graph._adjacency = adj
        if storage.check_state(STATE_MPHF_DONE):
            # a reference-layout file (only the /dsk/mphf stream) leaves
            # _mphf None: node_index is the rank search either way
            mphf, abund = storage_mod.load_mphf(storage, device=device)
            graph._mphf = mphf
            if abund is not None:
                graph.abundance_codes = abund
        if storage.check_state(STATE_BLOOM_DONE) \
                and storage.check_state(STATE_DEBLOOM_DONE):
            bloom = storage_mod.load_bloom(storage, device)
            cfp = storage_mod.load_debloom(storage, graph._w)
            if bloom is not None and cfp is not None:
                g = storage.group("debloom")
                kind = storage_mod.prop_str(g, "kind", "original")
                cascade = None
                if kind == "cascading" and "cascading" in g:
                    cg = g.group("cascading")
                    blooms = [storage_mod.load_bloom_group(
                        cg.group(f"bloom{i}"), device) for i in (2, 3, 4)]
                    t4 = cg.get_dataset("t4")
                    t4 = storage_mod.words64_to_limbs(t4, graph._w) \
                        if t4 is not None and len(t4) else \
                        np.zeros((0, graph._w), np.uint32)
                    cascade = CascadeCFP(blooms, t4)
                elif kind == "cascading" and "bloom2" in g:
                    # reference dbgh5 layout: /debloom/bloom{2,3,4} raw
                    # datasets with string attrs; cfp dataset holds T4
                    blooms = [storage_mod.load_bloom_dataset(
                        g._g[f"bloom{i}"], device) for i in (2, 3, 4)]
                    cascade = CascadeCFP(blooms, cfp)
                deb = DebloomResult(bloom, cfp, len(cfp), {}, kind, cascade)
                graph._debloom = deb
                graph._container = BloomCfpContainer(deb)
        return graph

    # ------------------------------------------------------------------
    # basic accessors
    # ------------------------------------------------------------------
    @property
    def nb_nodes(self) -> int:
        return len(self.solid_limbs)

    def iter_nodes(self, chunk: int = 1 << 16):
        """Yield (limbs_chunk, counts_chunk) over all nodes in sorted order."""
        for i in range(0, self.nb_nodes, chunk):
            yield self.solid_limbs[i:i + chunk], \
                self.solid_counts[i:i + chunk]

    def build_node(self, seq: str) -> np.ndarray:
        """Node from a k-mer string (Graph::buildNode): canonical limbs
        (W,)."""
        if len(seq) != self._k:
            raise ValueError(f"need a {self._k}-mer, got {len(seq)}")
        v = canonical(string_to_kmer(seq), self._k)
        return py_to_limbs([v], self._k)[0]

    def node_to_string(self, node: np.ndarray) -> str:
        return kmer_to_string(kmers_to_py(np.asarray(node)[None])[0], self._k)

    # ------------------------------------------------------------------
    # membership / index / abundance (batched)
    # ------------------------------------------------------------------
    def _as_batch(self, nodes) -> np.ndarray:
        nodes = np.asarray(nodes, np.uint32)
        if nodes.ndim == 1:
            nodes = nodes[None]
        return nodes

    def contains(self, nodes, mode: str | None = None) -> np.ndarray:
        """(N, W) or (W,) -> bool array.

        mode 'exact' (default): rank search in the sorted solid table.
        mode 'bloom_cfp': the reference's Bloom AND NOT cFP oracle
        (ContainerNode.hpp:60-90 / :109-190 cascading), exact for every
        query in the 1-neighborhood of solid k-mers, i.e. the closure
        traversal operates in; requires a completed debloom stage."""
        batch = self._as_batch(nodes)
        mode = mode or self.membership_mode
        if mode == "bloom_cfp":
            if self._container is None:
                raise ValueError("no debloom stage: bloom_cfp unavailable")
            return self._container.contains(batch)
        return self._set.contains(
            rows_to_device(batch, self.device)).cpu().numpy()

    def set_membership_mode(self, mode: str) -> None:
        if mode not in ("exact", "bloom_cfp"):
            raise ValueError(f"unknown membership mode {mode!r}")
        if mode == "bloom_cfp" and self._container is None:
            raise ValueError("no debloom stage: bloom_cfp unavailable")
        self.membership_mode = mode

    def build_mphf(self) -> None:
        """Build the BooPHF node index on the device (MPHFAlgorithm
        equivalent, kmer/impl/MPHFAlgorithm.cpp:150-330), for the file and
        for callers of ``BooPHF.rank``. Its codes are the sorted ranks
        that node_index answers through the rank search."""
        from ..collections.boophf import BooPHF

        self._mphf = BooPHF.build(self._padded_table(), self.nb_nodes)

    @time_info.spanned("graph.node_index")
    def node_index(self, nodes) -> np.ndarray:
        """nodeMPHFIndex (Graph.hpp:924): rank in sorted table, -1 if
        absent. The JAX package answers through the BooPHF once built,
        with the same result; on the device the rank search (``rank_rows``)
        is many times faster than the BooPHF's query (``chip_smoke.py``
        phase 10 times both), so it answers always."""
        with time_info.span("query.staging"):
            q = rows_to_device(self._as_batch(nodes), self.device)
        ranks = self._set.rank(q)
        with time_info.span("query.fetch"):
            return ranks.cpu().numpy()

    def query_abundance(self, nodes) -> np.ndarray:
        """Discretized abundance (queryAbundance, Graph.hpp:900)."""
        idx = self.node_index(nodes)
        out = dediscretize(self.abundance_codes[np.maximum(idx, 0)])
        return np.where(idx >= 0, out, 0)

    # ---- node state map (queryNodeState/setNodeState, Graph.hpp:904-913)
    def set_node_state(self, nodes, value: int) -> None:
        idx = self.node_index(nodes)
        self.node_state[idx[idx >= 0]] = np.uint8(value << 1) | \
            (self.node_state[idx[idx >= 0]] & 1)

    def query_node_state(self, nodes) -> np.ndarray:
        idx = self.node_index(nodes)
        return (self.node_state[np.maximum(idx, 0)] >> 1) * (idx >= 0)

    def delete_node(self, nodes) -> None:
        idx = self.node_index(nodes)
        self.node_state[idx[idx >= 0]] |= 1

    def delete_nodes_by_index(self, idx: np.ndarray) -> None:
        self.node_state[idx] |= 1

    def reset_node_state(self) -> None:
        """Clear every node's deletion and marks, and drop the kept
        ``Simplifications`` instance, so that ``simplify()`` and
        ``contigs()`` assemble the graph again as built. The port's own
        addition: the JAX package has no such method."""
        self.node_state[:] = 0
        self._simplifications = None

    def is_node_deleted(self, nodes) -> np.ndarray:
        idx = self.node_index(nodes)
        return (self.node_state[np.maximum(idx, 0)] & 1).astype(bool) \
            & (idx >= 0)

    # ------------------------------------------------------------------
    # adjacency / neighbors
    # ------------------------------------------------------------------
    def _padded_table(self) -> torch.Tensor:
        """The device copy of the solid table that every stage shares:
        (N, W) int32 storage. The name is the JAX package's, whose copy is
        padded to a power of two; the rank search takes the live row count
        at run time, so this one carries no padding. Every sweep over it
        walks the one ``RankIndex`` of ``self._set``."""
        return self._set.limbs

    def _sweep_index(self):
        """The held ``RankIndex`` a stage's sweep walks: the graph's own,
        unless a mesh of several ranks shards the table (each shard then
        indexes itself)."""
        if self.mesh is not None and self.mesh.size > 1:
            return None
        return self._set.index

    @time_info.spanned("graph.adjacency_masks")
    def adjacency_masks(self, nodes) -> np.ndarray:
        """8-bit neighbor mask per node: bits 0-3 out by nt, 4-7 in by nt."""
        with time_info.span("query.staging"):
            q = rows_to_device(self._as_batch(nodes), self.device)
        with time_info.span("query.candidates"):
            masks = neighbor_masks(q, self._padded_table(), self._set.n,
                                   self._k, index=self._set.index)
        with time_info.span("query.fetch"):
            return masks.cpu().numpy()

    def neighbors(self, node) -> dict:
        """Scalar convenience: {'out': [limbs...], 'in': [limbs...]}."""
        batch = self._as_batch(node)
        cands = neighbor_candidates(rows_to_device(batch, self.device),
                                    self._k).cpu().numpy().astype(np.uint32)
        mask = self.adjacency_masks(batch)[0]
        out = [cands[0, i] for i in range(4) if mask & (1 << i)]
        inn = [cands[0, 4 + i] for i in range(4) if mask & (1 << (4 + i))]
        return {"out": out, "in": inn}

    def out_degree(self, nodes) -> np.ndarray:
        m = self.adjacency_masks(nodes)
        return _popcount4(m & 0x0F)

    def in_degree(self, nodes) -> np.ndarray:
        m = self.adjacency_masks(nodes)
        return _popcount4(m >> 4)

    def precompute_adjacency(self, chunk: int | None = None) -> np.ndarray:
        """Cache the 8-bit mask for every node (precomputeAdjacency,
        Graph.cpp:3508-3610): a sweep over the device table in chunks of
        ``sweep_chunk`` nodes (at most ``chunk`` where given), or over the
        graph's mesh."""
        if self._adjacency is None:
            from ..ops.sortops import sweep_chunk

            ti = time_info.TimeInfo()
            with ti.section("adjacency", span="graph.adjacency"):
                if self.mesh is not None and self.nb_nodes:
                    from ..parallel.postsolid import distributed_adjacency

                    self._adjacency = distributed_adjacency(
                        self.mesh, self._padded_table(), self._k,
                        index=self._sweep_index())
                else:
                    table = self._padded_table()
                    step = sweep_chunk(self.nb_nodes)
                    if chunk:   # caller-imposed device-memory bound
                        step = max(1, min(step, chunk))
                    masks = torch.empty((self.nb_nodes,), dtype=torch.uint8,
                                        device=self.device)
                    for i in range(0, self.nb_nodes, step):
                        masks[i:i + step] = _adjacency_kernel(
                            table[i:i + step], table, self._k, self._set.n,
                            self._set.index)
                    self._adjacency = masks.cpu().numpy()
            self.info.update(ti.get_properties("postsolid_time", total=False))
            self._store_adjacency()
        return self._adjacency

    def _store_adjacency(self) -> None:
        if self.storage is not None:
            g = self.storage.group("adjacency")
            g.set_dataset("masks", self._adjacency)
            self.storage.set_state_bit(STATE_ADJACENCY_DONE)

    # ------------------------------------------------------------------
    # branching (BranchingAlgorithm, debruijn/impl/BranchingAlgorithm.cpp)
    # ------------------------------------------------------------------
    def branching_nodes(self) -> np.ndarray:
        """Sorted branching nodes (indegree != 1 or outdegree != 1)."""
        if self._branching is None:
            adj = self.precompute_adjacency()
            outd = _popcount4(adj & 0x0F)
            ind = _popcount4(adj >> 4)
            mask = (outd != 1) | (ind != 1)
            self._branching = self.solid_limbs[mask]
            self._branching_counts = self.solid_counts[mask]
            if self.storage is not None:
                g = self.storage.group("branching")
                words = storage_mod.limbs_to_words64(self._branching)
                rec = np.zeros(len(self._branching),
                               dtype=storage_mod.count_dtype(words.shape[1]))
                rec["value"] = words
                rec["abundance"] = self._branching_counts
                g.set_dataset("nodes", rec)
                g.set_property("nb_branching", np.uint64(len(rec)))
                g.set_property("checksum_branching",
                               self.checksum_branching())
                self.storage.set_state_bit(STATE_BRANCHING_DONE)
        return self._branching

    def checksum_branching(self) -> str:
        """Sum of branching k-mer values mod 2^(64*words), printed exactly
        like LargeInt::operator<< (LargeInt.hpp:630-648): 64-bit hex words
        high-to-low, '.'-separated, leading zero words skipped
        (BranchingAlgorithm.cpp:263-314)."""
        nodes = self.branching_nodes()
        words = max(1, (self._k + 31) // 32)
        # the sum of N values below 2^(32 W) is the limb columns' sums,
        # each shifted to its limb's place
        cols = nodes.astype(np.uint64).sum(axis=0, dtype=np.uint64) \
            if len(nodes) else np.zeros(self._w, np.uint64)
        total = 0
        for j in range(self._w):
            total += int(cols[j]) << (32 * (self._w - 1 - j))
        total %= 1 << (64 * words)
        ws = [(total >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
              for i in range(words)]
        i = words - 1
        while i >= 0 and ws[i] == 0:
            i -= 1
        if i < 0:
            return ""  # reference prints nothing for an all-zero value
        return ".".join(f"{ws[j]:x}" for j in range(i, -1, -1))

    # ------------------------------------------------------------------
    # simplification / unitigs / contigs
    # ------------------------------------------------------------------
    def simplify(self, verbose: int = 0):
        """Run the full tip/bulge/EC simplification (Graph::simplify,
        Graph.hpp:796 / Simplifications.cpp:112-215) on the device;
        deletions land in ``node_state``."""
        from .simplifications import Simplifications

        ti = time_info.TimeInfo()
        with ti.section("simplify", span="simplify", sync=True):
            simp = Simplifications(self, verbose=verbose)
            stats = simp.simplify()
            time_info.current().count(
                passes=stats.passes, tips=stats.tips_removed,
                bulges=stats.bulges_removed, ecs=stats.ec_removed,
                deleted=int((self.node_state & 1).sum()),
                walker=simp.walked, fallbacks=simp.fallbacks)
        # keep the instance: its full-table candidate sweep and final
        # compaction serve the Monument engine (assemble_contigs) with no
        # second sweep
        self._simplifications = simp
        self.info.update(ti.get_properties("postsolid_time", total=False))
        return stats

    def contigs(self, min_contig_len: int | None = None,
                traversal: str = "simple"):
        """Batched contig construction — the scalable equivalent of
        looping gatb-core's Traversal over all unmarked nodes with a
        Terminator (the Minia assembly loop, Traversal.cpp:68-160). Run
        `simplify()` first for cleaned contigs.

        traversal='simple' (default): every maximal simple path of the
        LIVE graph, as one compaction over unitigs. Returns (sequences,
        mean_abundances).

        traversal='monument': bubble-tolerant Monument assembly
        (Traversal.cpp:376-724) on the unitig-jumping engine
        (traversal.UnitigJumpTraversal, host walk). Returns (sequences,
        None): Monument contigs span bubbles, so a single mean abundance
        is not well-defined.

        min_contig_len defaults to 2k+1, Minia's contig length filter."""
        if min_contig_len is None:
            min_contig_len = 2 * self._k + 1
        if traversal == "monument":
            from .traversal import assemble_contigs

            ti = time_info.TimeInfo()
            with ti.section("contigs", span="contigs", sync=True):
                seqs = assemble_contigs(self, traversal="monument",
                                        min_contig_len=min_contig_len,
                                        engine="fast")
            self.info.update(ti.get_properties("postsolid_time",
                                               total=False))
            return seqs, None
        ug = self.unitig_graph()
        lens = np.asarray(ug.unitig_lengths())
        keep = lens >= min_contig_len
        seqs = [s for s, k_ in zip(ug.sequences, keep) if k_]
        return seqs, np.asarray(ug.mean_abundance)[keep]

    def unitig_graph(self):
        """Compact the (live) graph into unitigs with links (GraphUnitigs /
        UnitigsConstructionAlgorithm equivalent) on the device; a graph
        with deleted nodes through a fresh Simplifications' compaction, as
        in the JAX package."""
        from .graph_unitigs import build_unitig_graph

        ti = time_info.TimeInfo()
        with ti.section("unitigs", span="unitigs.build", sync=True):
            if not (self.node_state & 1).any():
                adj = self.precompute_adjacency()
                ug = build_unitig_graph(self._padded_table(),
                                        self.solid_counts, adj, self._k,
                                        mesh=self.mesh, device=self.device,
                                        index=self._sweep_index())
            else:
                from .simplifications import Simplifications

                simp = Simplifications(self)
                _, ug = simp._compact(*simp._rows(simp._live()))
        self.info.update(ti.get_properties("postsolid_time", total=False))
        return ug

    def get_info(self) -> dict:
        info = dict(self.info)
        info.update({
            "kmer_size": self._k,
            "nb_solid_kmers": self.nb_nodes,
        })
        if self._branching is not None:
            info["nb_branching"] = len(self._branching)
            info["checksum_branching"] = self.checksum_branching()
        return info


def _plan_partitions(bank, kmer_size: int, minimizer_size: int) -> int:
    """Partition count from the configuration plan (the reference sizes
    the repartitor from it, Graph.cpp:366-384)."""
    from ..bank.fasta import open_bank
    from ..kmer.configuration import compute_plan

    try:
        n, total, mx = open_bank(bank).estimate()
        plan = compute_plan(n, total, mx, kmer_size,
                            minimizer_size=minimizer_size)
        return max(1, plan.nb_partitions)
    except (ValueError, OSError):
        return 1


def _popcount4(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint8)
    x = (x & 0x55) + ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x & 0x0F) + (x >> 4)

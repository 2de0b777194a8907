"""De Bruijn graph over the solid k-mer set: the counting stage.

Counting-stage port of gatb_core_tpu/debruijn/graph.py (reference:
debruijn/impl/Graph.hpp:540 / Graph.cpp). The build is the reference's
state machine (Graph.cpp build_visitor_solid + build_visitor_postsolid):
configuration -> counting -> [mphf -> bloom -> debloom -> branching],
persisted stage-by-stage into HDF5 storage (Graph.hpp:1010-1030 state
bits). This module runs the first half: the repartitor census, DSK
counting on the device, and the /configuration, /dsk/solid, /histogram and
/minimizers groups. The postsolid stages (MPHF, Bloom, debloom,
branching), node queries, adjacency and ``Graph.load`` are not ported yet:
``build_postsolid`` raises ``NotImplementedError`` naming the stage for any
kind other than ``none``.

Node identity: canonical kmer value, represented as (W,) uint32 big-endian
limbs, in the sorted solid table.
"""

from __future__ import annotations

import numpy as np

from ..collections.abundance import discretize
from ..kmer.counting import CountConfig, SortingCount
from ..ops.kmer_ops import nb_limbs
from ..storage import hdf5 as storage_mod
from ..storage.hdf5 import Storage


class Graph:
    """Node-centric de Bruijn graph: the solid table and its build info."""

    def __init__(self, kmer_size: int, solid_limbs: np.ndarray,
                 solid_counts: np.ndarray, storage: Storage | None = None,
                 info: dict | None = None):
        self.kmer_size = kmer_size
        self._k = kmer_size
        self._w = nb_limbs(kmer_size)
        self.solid_limbs = np.asarray(solid_limbs, np.uint32)
        self.solid_counts = np.asarray(solid_counts, np.int32)
        self.storage = storage
        self.info = dict(info or {})
        # per-node abundance map (8-bit discretized)
        self.abundance_codes = discretize(self.solid_counts)
        self._branching: np.ndarray | None = None

    # ------------------------------------------------------------------
    # creation
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
               superbatch_rows: int | None = None,
               table_budget_bytes: int | None = None,
               device: str = "cuda") -> "Graph":
        """Graph build from a bank (Graph::create equivalent):
        config -> repartitor -> DSK (build_visitor_solid, Graph.cpp:286-433),
        each stage persisted + state-bit-stamped, then the postsolid stages
        (build_visitor_postsolid, Graph.cpp:433-605). Kind defaults mirror
        the reference enums (misc/api/Enums.hpp:73-271); 'none' skips a
        stage, and every other kind raises until those stages are ported
        (see build_postsolid)."""
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

        graph = cls(kmer_size, result.solid_kmers, result.solid_counts,
                    storage, result.info)
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
        Debloom -> Branching. None of these stages is ported yet, so a
        stage that is asked for raises (it is never skipped silently);
        with every kind 'none' and no branching there is nothing to do."""
        if mphf_kind != "none":
            raise NotImplementedError(
                f"postsolid stage 'mphf' ({mphf_kind}) is not ported yet: "
                "pass mphf_kind='none' (dbgh5: -mphf none)")
        if bloom_kind != "none" and debloom_kind != "none":
            raise NotImplementedError(
                f"postsolid stage 'bloom/debloom' ({bloom_kind}, "
                f"{debloom_kind}) is not ported yet: pass bloom_kind='none'"
                " or debloom_kind='none' (dbgh5: -bloom none -debloom none)")
        if build_branching:
            raise NotImplementedError(
                "postsolid stage 'branching' is not ported yet: pass "
                "build_branching=False (dbgh5: -branching-nodes none)")

    # ------------------------------------------------------------------
    # basic accessors
    # ------------------------------------------------------------------
    @property
    def nb_nodes(self) -> int:
        return len(self.solid_limbs)

    def get_info(self) -> dict:
        info = dict(self.info)
        info.update({
            "kmer_size": self._k,
            "nb_solid_kmers": self.nb_nodes,
        })
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

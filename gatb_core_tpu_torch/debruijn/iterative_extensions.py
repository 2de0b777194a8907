"""IterativeExtensions: targeted contig extension from a seed kmer.

Port of gatb_core_tpu/debruijn/iterative_extensions.py. Reference:
gatb-core IterativeExtensions (debruijn/impl/
IterativeExtensions.cpp, used by MindTheGap / Mapsembler): from a seed
sequence, repeatedly extend with the graph traversal until a maximum
depth or until the target kmer is reached, emitting the traversed
sequence(s). The neighbor table is built on the graph's device
(``traversal.NodeGraphView``), the walk is host Python.
"""

from __future__ import annotations

from dataclasses import dataclass

from .traversal import (
    NodeGraphView, Terminator, MonumentTraversal, SimplePathsTraversal,
    NUCLEOTIDES,
)
from ..kmer.model import canonical, string_to_kmer


@dataclass
class ExtensionResult:
    sequence: str
    reached_target: bool
    nb_nucleotides: int


class IterativeExtensions:
    """Extend from a seed kmer toward (optionally) a target kmer."""

    def __init__(self, graph, traversal_kind: str = "monument",
                 max_depth: int = 10000):
        self.graph = graph
        self.k = graph.kmer_size
        self.view = NodeGraphView(graph)
        self.traversal_kind = traversal_kind
        self.max_depth = max_depth

    def _oriented_seed(self, seed: str):
        k = self.k
        if len(seed) < k:
            raise ValueError(f"seed shorter than k={k}")
        kmer_str = seed[-k:]
        fwd = string_to_kmer(kmer_str)
        canon = canonical(fwd, k)
        idx = self.graph.node_index(self.graph.build_node(kmer_str))[0]
        if idx < 0:
            return None
        strand = 0 if fwd == canon else 1
        return 2 * int(idx) + strand

    def extend(self, seed: str, target: str | None = None) \
            -> ExtensionResult:
        """Extend rightward from the last kmer of ``seed``; stop at
        max_depth, a dead end, or when the target kmer is reached."""
        oid = self._oriented_seed(seed)
        if oid is None:
            return ExtensionResult(seed, False, 0)

        terminator = Terminator(self.view)
        cls = MonumentTraversal if self.traversal_kind == "monument" \
            else SimplePathsTraversal
        trav = cls(self.view, terminator)

        target_canon = None
        if target is not None:
            target_canon = canonical(string_to_kmer(target[:self.k]), self.k)

        path = []
        cur = oid
        prev = None
        reached = False
        k = self.k
        cur_val_fwd = string_to_kmer(seed[-k:])
        mask = (1 << (2 * k)) - 1
        while len(path) < self.max_depth:
            ext = trav.avance(cur, prev)
            if not ext:
                break
            stop = False
            for nt, nxt in ext:
                path.append(nt)
                prev, cur = cur, nxt
                terminator.mark(nxt)
                cur_val_fwd = ((cur_val_fwd << 2) | nt) & mask
                if target_canon is not None \
                        and canonical(cur_val_fwd, k) == target_canon:
                    reached = True
                    stop = True
                    break
            if stop:
                break
        seq = seed + "".join(NUCLEOTIDES[nt] for nt in path)
        return ExtensionResult(seq, reached, len(path))

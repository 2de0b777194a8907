"""Contig assembly traversal: SimplePaths and Monument (bubble-tolerant).

Port of gatb_core_tpu/debruijn/traversal.py. Reference: gatb-core
debruijn/impl/Traversal.cpp, Frontline.cpp (BFS frontier with branching
stop conditions) and Terminator.cpp (node marking). Constants are
reproduced exactly:

  defaultMaxDepth=500, defaultMaxBreadth=20 (Traversal.hpp:169-170)
  consensuses_identity=80%               (Traversal.hpp:368)
  needleman-wunsch match=10, mismatch=-5, gap=-5 (Traversal.cpp:188-241)
  validate: mean<=max_depth; single-consensus deadends <= k+1;
            stdev<=mean/5; pairwise identity >= 80%  (Traversal.cpp:679-750)

Design: the neighbor ranks and strands of ALL nodes come from one sweep on
the device (``unitigs.cand_sweep``, the ``rank_rows`` kernel, or the one
Simplifications already made), the oriented neighbor table is built there
with torch and brought to the host once; the walks themselves are host
Python over numpy arrays, copied from the JAX package: the per-contig walk
is sequential in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .unitigs import cand_sweep

NUCLEOTIDES = "ACTG"


class NodeGraphView:
    """Host-side oriented-node adjacency view over a Graph's solid set.

    Oriented id: 2*i + s (s=0 canonical forward). The out-neighbor table
    comes from the ranks and entering strands of all 8 candidate slots of
    every node: ``precomputed`` (N, 8) int32 / int8 device tensors (e.g.
    Simplifications' sweep), else one sweep over the graph's device table.
    """

    def __init__(self, graph, precomputed=None):
        self.graph = graph
        self.k = graph.kmer_size
        n = graph.nb_nodes
        self.n = n
        self.counts = graph.solid_counts
        self.alive = ~(graph.node_state & 1).astype(bool)
        # vectorized oriented out-neighbor table (2N, 4): neighbor oid per
        # nucleotide or -1, built on the device
        out_nbr = torch.full((2 * max(n, 1), 4), -1, dtype=torch.int64,
                             device=graph.device)
        if n:
            r, f = precomputed if precomputed is not None else cand_sweep(
                graph._padded_table(), n, self.k)
            alive = torch.from_numpy(self.alive).to(graph.device)
            for nt in range(4):
                # forward strand: out-slot nt; reverse strand: in-slot
                # nt^2, entered in the opposite sense
                for s, slot in ((0, nt), (1, 4 + (nt ^ 2))):
                    j = r[:, slot].to(torch.int64)
                    ok = (j >= 0) & alive[j.clamp(min=0)]
                    fl = f[:, slot].to(torch.int64)
                    out_nbr[s::2, nt] = torch.where(
                        ok, 2 * j + (fl if s == 0 else 1 - fl), -1)
            # dead nodes have no out-edges either
            out_nbr[(~alive).repeat_interleave(2)] = -1
        self.out_nbr = out_nbr.cpu().numpy()
        self.out_deg_arr = (out_nbr >= 0).sum(dim=1).cpu().numpy()

    def out_neighbors(self, oid: int):
        """[(neighbor_oid, nucleotide)] out-edges of an oriented node."""
        row = self.out_nbr[oid]
        return [(int(row[nt]), nt) for nt in range(4) if row[nt] >= 0]

    def in_degree(self, oid: int) -> int:
        return int(self.out_deg_arr[oid ^ 1])

    def out_degree(self, oid: int) -> int:
        return int(self.out_deg_arr[oid])

    def node_string(self, oid: int) -> str:
        from ..kmer.model import kmer_to_string, revcomp
        from ..ops.kmer_ops import kmers_to_py

        i, s = oid >> 1, oid & 1
        v = kmers_to_py(self.graph.solid_limbs[i][None])[0]
        if s:
            v = revcomp(v, self.k)
        return kmer_to_string(v, self.k)


class Terminator:
    """Node marking (Terminator.cpp MPHFTerminator flavor): one mark bit
    per node, strand-agnostic."""

    def __init__(self, view: NodeGraphView):
        self.view = view
        self.marks = np.zeros(view.n, bool)

    def mark(self, oid: int) -> None:
        self.marks[oid >> 1] = True

    def is_marked(self, oid: int) -> bool:
        return bool(self.marks[oid >> 1])


class Frontline:
    """BFS frontier (Frontline.cpp:94-150): advances all frontier nodes one
    depth, de-duplicating via already_frontlined; MARKED stop when hitting
    a terminator-marked node."""

    NONE, MARKED, IN_BRANCHING_DEPTH, IN_BRANCHING_BREADTH, \
        IN_BRANCHING_OTHER = range(5)

    def __init__(self, view: NodeGraphView, terminator, start_oid: int,
                 previous_oid: int | None = None, involved: set | None = None,
                 check_in_branching: bool = True):
        self.view = view
        self.terminator = terminator
        self.frontier = [start_oid]
        self.already = {start_oid >> 1}
        if previous_oid is not None:
            self.already.add(previous_oid >> 1)
        self.depth = 0
        self.involved = involved
        self.stopped_reason = self.NONE
        self.check_in_branching = check_in_branching

    def size(self) -> int:
        return len(self.frontier)

    def go_next_depth(self) -> bool:
        new = []
        for oid in self.frontier:
            if self.depth > 0 and self.check_in_branching \
                    and not self._check(oid):
                return False
            for nb, _nt in self.view.out_neighbors(oid):
                if (nb >> 1) in self.already:
                    continue
                if self.terminator is not None \
                        and self.terminator.is_marked(nb):
                    self.stopped_reason = self.MARKED
                    return False
                new.append(nb)
                self.already.add(nb >> 1)
                if self.involved is not None:
                    self.involved.add(nb)
        self.frontier = new
        self.depth += 1
        return True

    def _check(self, oid: int) -> bool:
        """FrontlineBranching::check (Frontline.cpp:197-240): refuse large
        in-branching into the bubble from outside."""
        for nb, _nt in self.view.out_neighbors(oid ^ 1):
            if (nb >> 1) in self.already:
                continue
            # explore the in-branching path backwards a bit; if it is deep,
            # this is not a clean bubble (reference uses a nested frontline
            # bounded by depth brute-force)
            inner = Frontline(self.view, None, nb ^ 1,
                              check_in_branching=False)
            while inner.depth < 5:
                if not inner.go_next_depth():
                    break
                if inner.size() == 0:
                    break
                if inner.depth > 3:
                    self.stopped_reason = self.IN_BRANCHING_DEPTH
                    return False
        return True


@dataclass
class TraversalStats:
    ended_traversals: int = 0
    bubbles_popped: int = 0
    couldnt_validate: int = 0


class Traversal:
    """Base traversal (TraversalTemplate): iteratively extend a path from a
    starting node in one direction."""

    def __init__(self, view: NodeGraphView, terminator: Terminator,
                 max_depth: int = 500, max_breadth: int = 20):
        self.view = view
        self.terminator = terminator
        self.max_depth = max_depth
        self.max_breadth = max_breadth
        self.stats = TraversalStats()

    def avance(self, oid, previous_oid):
        raise NotImplementedError

    def traverse(self, start_oid: int, max_len: int = 1_000_000):
        """Extend from start; returns (nucleotides, last_oid)."""
        path = []
        cur = start_oid
        prev = None
        while len(path) < max_len:
            ext = self.avance(cur, prev)
            if not ext:
                break
            for (nt, nxt) in ext:
                path.append(nt)
                prev = cur
                cur = nxt
                self.terminator.mark(nxt)
        return path, cur


class SimplePathsTraversal(Traversal):
    """Stop at any ambiguity (SimplePathsTraversal, Traversal.cpp:376)."""

    def avance(self, oid, previous_oid):
        out = self.view.out_neighbors(oid)
        if len(out) != 1:
            self.stats.ended_traversals += 1
            return []
        nxt, nt = out[0]
        if self.view.in_degree(nxt) != 1:
            self.stats.ended_traversals += 1
            return []
        if self.terminator.is_marked(nxt):
            return []
        return [(nt, nxt)]


class MonumentTraversal(Traversal):
    """Bubble-tolerant traversal (MonumentTraversal, Traversal.cpp:376-724)."""

    consensuses_identity = 80  # Traversal.hpp:368

    def avance(self, oid, previous_oid):
        # try simple first
        out = self.view.out_neighbors(oid)
        if len(out) == 1:
            nxt, nt = out[0]
            if self.view.in_degree(nxt) == 1 \
                    and not self.terminator.is_marked(nxt):
                return [(nt, nxt)]
        if len(out) == 0:
            return []
        return self.explore_branching(oid, previous_oid)

    # -- explore_branching (Traversal.cpp:425-470) ----------------------
    def explore_branching(self, oid, previous_oid):
        involved = set()
        res = self.find_end_of_branching(oid, previous_oid, involved)
        if not res:
            self.stats.ended_traversals += 1
            return []
        end_oid, depth = res
        consensuses, success = self.all_consensuses_between(
            oid, end_oid, depth + 1)
        if not success:
            return []
        consensus = self.validate_consensuses(consensuses, oid)
        if consensus is None:
            self.stats.couldnt_validate += 1
            return []
        # rebuild (nt, oid) steps along the chosen consensus (a string)
        steps = []
        cur = oid
        for ch in consensus:
            nt = NUCLEOTIDES.index(ch)
            for nb, nbt in self.view.out_neighbors(cur):
                if nbt == nt:
                    steps.append((nt, nb))
                    cur = nb
                    break
            else:
                return []
        # the consensuses agree: mark all the involved alternative
        # extensions so they are never traversed again
        for x in involved:
            self.terminator.mark(x)
        self.stats.bubbles_popped += 1
        return steps

    def find_end_of_branching(self, start, previous, involved):
        """Frontline BFS until single-node frontier
        (find_end_of_branching, Traversal.cpp:476-520)."""
        fl = Frontline(self.view, self.terminator, start, previous, involved)
        while True:
            if not fl.go_next_depth():
                return None
            if fl.depth > self.max_depth:
                return None
            if fl.size() > self.max_breadth:
                return None
            if fl.size() == 0:
                return None
            if fl.size() == 1:
                return fl.frontier[0], fl.depth

    def all_consensuses_between(self, start, end, depth):
        """All paths start->end within depth (recursive DFS,
        Traversal.cpp all_consensuses_between)."""
        out = set()
        nb_paths = [0]

        def dfs(cur, path, used):
            if nb_paths[0] > 50:  # breadth guard like max_breadth usage
                return False
            if len(path) > depth:
                return True
            if cur == end:
                out.add("".join(path))
                nb_paths[0] += 1
                return True
            ok = True
            for nb, nt in self.view.out_neighbors(cur):
                if (nb >> 1) in used:
                    continue
                ok &= dfs(nb, path + [NUCLEOTIDES[nt]],
                          used | {nb >> 1})
            return ok

        success = dfs(start, [], {start >> 1})
        return out, success and len(out) > 0

    # -- validation (Traversal.cpp:679-750) -----------------------------
    def validate_consensuses(self, consensuses, start_oid):
        if not consensuses:
            return None
        sizes = [len(c) for c in consensuses]
        mean = sum(sizes) // len(sizes)
        stdev = (sum((s - mean) ** 2 for s in sizes) / len(sizes)) ** 0.5
        if mean > self.max_depth:
            return None
        if len(consensuses) == 1 and mean > self.view.k + 1:
            return None
        if stdev > mean / 5:
            return None
        if not self.all_consensuses_almost_identical(consensuses):
            return None
        # choose the most abundant consensus (most_abundant_consensus —
        # abundance map is always available in this engine)
        return self.most_abundant_consensus(consensuses, start_oid)

    def all_consensuses_almost_identical(self, consensuses):
        cl = list(consensuses)
        for a in range(len(cl)):
            for b in range(a + 1, len(cl)):
                if needleman_wunsch_identity(cl[a], cl[b]) * 100 \
                        < self.consensuses_identity:
                    return False
        return True

    def most_abundant_consensus(self, consensuses, start_oid):
        """Pick the path with max mean node abundance
        (most_abundant_consensus, Traversal.cpp)."""
        best, best_cov = None, -1.0
        for c in consensuses:
            cov = self._path_coverage(c, start_oid)
            if cov > best_cov:
                best, best_cov = c, cov
        return best

    def _path_coverage(self, consensus, start_oid):
        """Mean abundance of the nodes along a nucleotide path."""
        cur = start_oid
        covs = []
        for ch in consensus:
            nt = NUCLEOTIDES.index(ch)
            found = False
            for nb, nbt in self.view.out_neighbors(cur):
                if nbt == nt:
                    covs.append(float(self.view.counts[nb >> 1]))
                    cur = nb
                    found = True
                    break
            if not found:
                return -1.0
        return float(np.mean(covs)) if covs else -1.0


def needleman_wunsch_identity(a: str, b: str) -> float:
    """Bit-exact port of TraversalTemplate::needleman_wunch
    (Traversal.cpp:188-241): match 10, mismatch/gap -5, identity
    normalized by max(len_a, len_b)."""
    gap, mismatch, match = -5.0, -5.0, 10.0
    na, nb = len(a), len(b)
    score = np.zeros((na + 1, nb + 1), np.float32)
    score[:, 0] = gap * np.arange(na + 1)
    score[0, :] = gap * np.arange(nb + 1)
    for i in range(1, na + 1):
        s_match = np.where(np.frombuffer(a[i - 1].encode(), np.uint8)
                           == np.frombuffer(b.encode(), np.uint8),
                           match, mismatch)
        for j in range(1, nb + 1):
            score[i, j] = max(score[i - 1, j - 1] + s_match[j - 1],
                              score[i - 1, j] + gap,
                              score[i, j - 1] + gap)
    i, j = na, nb
    identity = 0
    while i > 0 and j > 0:
        sm = match if a[i - 1] == b[j - 1] else mismatch
        if score[i, j] == score[i - 1, j - 1] + sm:
            if a[i - 1] == b[j - 1]:
                identity += 1
            i -= 1
            j -= 1
        elif score[i, j] == score[i - 1, j] + gap:
            i -= 1
        elif score[i, j] == score[i, j - 1] + gap:
            j -= 1
        else:
            break
    return identity / max(na, nb) if max(na, nb) else 1.0


class UnitigJumpTraversal(MonumentTraversal):
    """Monument traversal that advances whole UNITIGS at a time on the
    simple-path stretches (the scalable engine VERDICT r3 item 5 asks
    for): inside a unitig every kmer has out==1/in==1, so the oracle's
    per-kmer avance is a deterministic chain — replaced by one array
    slice (bases appended in bulk, marks set in bulk). Only unitig
    EXITS (possible branchings) and mark collisions drop to the
    per-kmer Monument logic, which is inherited UNCHANGED — so bubble
    decisions, stats, and contig output match the per-node oracle
    exactly (asserted by tests/test_traversal_batched.py)."""

    def __init__(self, view: NodeGraphView, terminator: Terminator,
                 us, ug, **kw):
        super().__init__(view, terminator, **kw)
        self.us = us
        self.ug = ug
        # CSR: node ids of each unitig in position order
        nu = us.node_unitig
        valid = nu >= 0
        order = np.lexsort((us.node_pos[valid], nu[valid]))
        self._unodes = np.nonzero(valid)[0][order]
        self._uoff = np.zeros(us.nb_unitigs + 1, np.int64)
        np.add.at(self._uoff, nu[valid] + 1, 1)
        self._uoff = np.cumsum(self._uoff)
        self._seq_cache = {}

    def _useq(self, u: int) -> str:
        s = self._seq_cache.get(u)
        if s is None:
            s = self.ug.sequences[u]
            if len(self._seq_cache) > 4096:
                self._seq_cache.clear()
            self._seq_cache[u] = s
        return s

    _COMP = str.maketrans("ACGT", "TGCA")

    def traverse(self, start_oid: int, max_len: int = 1_000_000):
        """Unitig-jumping extension; returns (nucleotides, last_oid)."""
        path: list[int] = []
        cur = start_oid
        prev = None
        marks = self.terminator.marks
        us, k = self.us, self.view.k
        while len(path) < max_len:
            i, s = cur >> 1, cur & 1
            u = int(us.node_unitig[i])
            if u >= 0:
                nk = int(us.kmer_counts[u])
                pos = int(us.node_pos[i])
                fwd = (s == int(us.node_strand[i]))
                exit_pos = nk - 1 if fwd else 0
                if pos != exit_pos:
                    # nodes ahead inside the unitig, in travel order
                    span = self._unodes[self._uoff[u]:self._uoff[u + 1]]
                    ahead = span[pos + 1:] if fwd else span[pos - 1::-1]
                    # jump only within the max_len budget (the per-kmer
                    # oracle stops exactly at max_len on simple paths)
                    if len(path) + len(ahead) <= max_len \
                            and not marks[ahead].any():
                        seq = self._useq(u)
                        if fwd:
                            bases = seq[pos + k:]
                        else:
                            bases = seq[:pos].translate(self._COMP)[::-1]
                        path.extend(NUCLEOTIDES.index(c) for c in bases)
                        marks[ahead] = True

                        # travel-oriented oid of node j: 2j + strand[j],
                        # xor 1 when traveling against the unitig
                        def oid_of(j):
                            return 2 * int(j) + (int(us.node_strand[j])
                                                 ^ (0 if fwd else 1))

                        prev = oid_of(ahead[-2]) if len(ahead) > 1 else cur
                        cur = oid_of(ahead[-1])
                        continue
                    # a marked node ahead: oracle semantics per-kmer
            ext = self.avance(cur, prev)
            if not ext:
                break
            for (nt, nxt) in ext:
                path.append(nt)
                prev = cur
                cur = nxt
                self.terminator.mark(nxt)
        return path, cur


def assemble_contigs(graph, traversal: str = "monument",
                     min_contig_len: int = 0,
                     engine: str = "oracle") -> list[str]:
    """Assemble contigs from all unmarked starting nodes (the Minia-style
    assembly loop over the graph). ``engine='fast'`` uses the
    unitig-jumping Monument (same output, seconds at multimillion-node
    scale); 'oracle' is the per-kmer reference port."""
    if engine == "fast" and traversal == "monument":
        from .simplifications import Simplifications

        live = ~(graph.node_state & 1).astype(bool)
        # reuse the simplify run's instance: its full-table candidate
        # sweep (and usually its final compaction) make this a zero-sweep
        # call (graph.simplify stores it)
        simp = getattr(graph, "_simplifications", None) \
            or Simplifications(graph)
        us, ug = simp._compact(*simp._rows(simp._live()))
        # the compaction's full-table sweep doubles as the view's
        # neighbor table (same kernel — one device pass instead of two)
        pre = (simp._full_ranks, simp._full_flips) \
            if simp._full_ranks is not None else None
        view = NodeGraphView(graph, precomputed=pre)
        terminator = Terminator(view)
        # us indexes the LIVE subset; remap node arrays to the full table
        nu = np.full(view.n, -1, np.int32)
        npos = np.zeros(view.n, np.int32)
        nstr = np.zeros(view.n, np.int8)
        live_idx = np.nonzero(live)[0]
        nu[live_idx] = us.node_unitig
        npos[live_idx] = us.node_pos
        nstr[live_idx] = us.node_strand
        from dataclasses import replace

        us_full = replace(us, node_unitig=nu, node_pos=npos,
                          node_strand=nstr)
        trav = UnitigJumpTraversal(view, terminator, us_full, ug)
    else:
        view = NodeGraphView(graph)
        terminator = Terminator(view)
        cls = MonumentTraversal if traversal == "monument" \
            else SimplePathsTraversal
        trav = cls(view, terminator)

    # Start from path boundaries first (dead ends and branching nodes),
    # then interior nodes (cycles): starting inside a bubble would
    # fragment contigs, since popped-bubble extensions get marked.
    # (vectorized — the per-node Python degree loop was ~1/3 of the
    # reads3 assembly wall-clock)
    od = view.out_deg_arr[0::2]
    idg = view.out_deg_arr[1::2]
    is_boundary = view.alive & ((od != 1) | (idg != 1))
    boundary = np.nonzero(is_boundary)[0]
    interior = np.nonzero(view.alive & ~is_boundary)[0]

    contigs = []
    for i in np.concatenate([boundary, interior]):
        i = int(i)
        if terminator.marks[i] or not view.alive[i]:
            continue
        terminator.marks[i] = True
        right, _ = trav.traverse(2 * i)
        left, _ = trav.traverse(2 * i + 1)
        comp = {"A": "T", "C": "G", "T": "A", "G": "C"}
        left_seq = "".join(NUCLEOTIDES[nt] for nt in left)
        right_seq = "".join(NUCLEOTIDES[nt] for nt in right)
        start_str = view.node_string(2 * i)
        contig = ("".join(comp[c] for c in reversed(left_seq))
                  + start_str + right_seq)
        if len(contig) >= min_contig_len:
            contigs.append(contig)
    return contigs

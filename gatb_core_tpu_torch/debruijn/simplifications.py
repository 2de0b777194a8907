"""Graph simplification: tips, bulges, erroneous connections (ECs).

Port of gatb_core_tpu/debruijn/simplifications.py. Reference: gatb-core
Simplifications (debruijn/impl/Simplifications.cpp), whose SPAdes-derived
constants are reproduced exactly (Simplifications.cpp:93-105):

  tips:   topological length <= 2.5*k; RCTC length <= 10*k, cutoff 2
  bulges: max length max(3k, k+100); backtracking k+50; alt-cov mult 1.1
  ECs:    max length 9*k; RCTC cutoff 4
  cutoffEvents = max(nbNodes/10000, 1)   (Simplifications.cpp:85)

Each pass is a vectorized decision over *unitigs* (a simple path IS a
unitig), deletions are a mask, and the live graph is recompacted between
passes (the NodesDeleter + iterative-pass structure of the reference,
Simplifications.cpp:112-215). On the device: one candidate sweep over the
whole solid table (``unitigs.cand_sweep``, the ``rank_rows`` kernel) per
instance, kept as (N, 8) tensors; each recompaction remaps it through the
live index with torch gathers and hands it to ``build_unitigs`` /
``link_unitigs`` as ``precomputed``; the decision passes (CSR expansions,
the RCTC sums, the lockstep bulge walker) are torch ops. ``node_state``
stays the graph's host numpy array; the pass schedule and the bulge
search's backtracking recursion (``_hmcp_unitigs``, run only where the
walker flags a candidate) are host Python, as in the JAX package.

Float64 sums are taken in numpy's order: ``np.bincount`` adds a bin's
weights in array order from 0.0, and CUDA's scatter-adds add in no fixed
order, so each bin's contributions (at most 8) sit in a padded matrix
summed column by column (``_ordered_sum``). There is no ``mesh`` argument
(ROADMAP A9).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .unitigs import _on, build_unitigs, cand_sweep

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64


@dataclass
class SimplifyStats:
    tips_removed: int = 0
    bulges_removed: int = 0
    ec_removed: int = 0
    passes: int = 0


@dataclass
class _Arrays:
    """Device copies of what the passes read of one unitig graph."""

    deg: torch.Tensor      # (2U,) int64 out-degree of each oriented unitig
    nk: torch.Tensor       # (U,) int64 k-mers per unitig
    lens: torch.Tensor     # (U,) int64 base lengths
    chain: torch.Tensor    # (U,) float64 ``_chain_abundance``
    link_t: torch.Tensor   # (E + 4,) int64 link targets, then 4 x -1
    link_o: torch.Tensor   # (2U + 1,) int64 CSR offsets

    def window(self, src: torch.Tensor) -> torch.Tensor:
        """(len(src), 4) out-links of the oriented ids ``src`` in link
        order, -1 past each one's degree (a DNA out-degree is <= 4)."""
        j = torch.arange(4, device=src.device)
        t = self.link_t[self.link_o[src][:, None] + j]
        return torch.where(j < self.deg[src][:, None], t, -1)


def _ordered_sum(m: torch.Tensor) -> torch.Tensor:
    """Row sums of a (B, c) float64 matrix, left to right from 0.0: the
    order in which ``np.bincount`` adds a bin's weights (the zeros of the
    padding change nothing: x + 0.0 == x for the non-negative sums here)."""
    acc = torch.zeros(m.shape[0], dtype=F64, device=m.device)
    for j in range(m.shape[1]):
        acc = acc + m[:, j]
    return acc


class Simplifications:
    """Iterative tip/bulge/EC removal over the unitig graph."""

    # SPAdes-like constants (Simplifications.cpp:93-105)
    TIP_LEN_TOPO_KMULT = 2.5
    TIP_LEN_RCTC_KMULT = 10.0
    TIP_RCTC_CUTOFF = 2.0
    BULGE_LEN_KMULT = 3.0
    BULGE_LEN_KADD = 100
    BULGE_ALTPATH_KADD = 50
    BULGE_ALTPATH_COVMULT = 1.1
    EC_LEN_KMULT = 9.0
    EC_RCTC_CUTOFF = 4.0

    def __init__(self, graph, verbose: int = 0):
        """graph: debruijn.graph.Graph (node-centric, provides the solid
        set on its device and the deletion mask)."""
        self.graph = graph
        self.k = graph.kmer_size
        self.device = graph.device
        self.verbose = verbose
        self.stats = SimplifyStats()
        # per-op pass counters + removal report strings (the reference's
        # _nbTipRemovalPasses/... members and tipRemoval/bubbleRemoval/
        # ECRemoval "n + n + ..." strings, Simplifications.cpp:112-215)
        self.nb_tip_passes = 0
        self.nb_bulge_passes = 0
        self.nb_ec_passes = 0
        self.tip_removal = ""
        self.bubble_removal = ""
        self.ec_removal = ""
        self._full_ranks = self._full_flips = None   # (N, 8), the device
        self._compact_cache = None
        self._live_index = None
        self._counts = None
        self._arr = None

    # ------------------------------------------------------------------
    def _live(self) -> torch.Tensor:
        """(N,) bool on the device: the nodes not deleted."""
        return torch.from_numpy(self.graph.node_state & 1).to(
            self.device) == 0

    def _rows(self, live: torch.Tensor):
        """The live rows of the solid table and their counts, on the
        device (the port's ``solid_limbs[live]``, ``solid_counts[live]``)."""
        if self._counts is None:
            self._counts = torch.from_numpy(self.graph.solid_counts).to(
                self.device)
        return self.graph._padded_table()[live], self._counts[live]

    def _delete_unitigs(self, ug, which, us_node_unitig) -> None:
        """Mark all k-mers of the selected unitigs deleted in the base
        graph."""
        sel = _on(which, torch.bool, self.device)[
            _on(us_node_unitig, I64, self.device)]
        self.graph.node_state[self._live_index[sel].cpu().numpy()] |= 1
        self._compact_cache = None  # live set changed

    def _arrays(self, ug) -> _Arrays:
        """The device arrays of ``ug``, made once per compaction."""
        if self._arr is None or self._arr[0] is not ug:
            dev = self.device
            link_o = _on(ug.link_offsets, I64, dev)
            nk = _on(ug.kmer_counts, I64, dev)
            nkf = nk.to(F64)
            ab = _on(ug.mean_abundance, F64, dev)
            self._arr = (ug, _Arrays(
                deg=link_o[1:] - link_o[:-1], nk=nk,
                lens=_on(ug.unitig_lengths(), I64, dev),
                # JAX's order of operations: ab * nk / max(nk - 1, 1)
                chain=torch.where(
                    nk > 1, ab * nkf / torch.clamp(nkf - 1.0, min=1.0), ab),
                link_t=torch.cat([_on(ug.link_targets, I64, dev),
                                  torch.full((4,), -1, dtype=I64,
                                             device=dev)]),
                link_o=link_o))
        return self._arr[1]

    # ------------------------------------------------------------------
    def remove_tips(self) -> int:
        """One tip-removal pass (removeTips, Simplifications.cpp:408-610)."""
        k = self.k
        live = self._live()
        if not bool(live.any()):
            return 0
        us, ug = self._compact(*self._rows(live))
        a = self._arrays(ug)
        deg_f = a.deg[0::2]   # links out of forward end (tail side)
        deg_r = a.deg[1::2]   # links out of reverse end (head side)

        max_topo = int(k * self.TIP_LEN_TOPO_KMULT)
        max_rctc = int(k * self.TIP_LEN_RCTC_KMULT)

        # tip = unitig with exactly one dead end, and the other end connected
        one_dead = (deg_f == 0) ^ (deg_r == 0)
        short_topo = a.lens <= max_topo
        short_rctc = a.lens <= max_rctc
        cand = one_dead & (short_topo | short_rctc)

        is_tip = cand & short_topo
        # RCTC test for the rest; the path abundance is the reference's
        # simplePathMeanAbundance, i.e. the nk/(nk-1)-inflated chain mean
        # (GraphUnitigs.cpp:1507)
        rctc_cand = torch.nonzero(cand & ~short_topo & short_rctc)[:, 0]
        if len(rctc_cand):
            ends = torch.where(deg_f[rctc_cand] > 0, 2 * rctc_cand,
                               2 * rctc_cand + 1)
            ok = self._satisfy_rctc_batch(
                ug, ends, a.chain[rctc_cand], self.TIP_RCTC_CUTOFF)
            is_tip[rctc_cand[ok]] = True

        n_removed = int(is_tip.sum())
        # the count the reference's pass loops SEE: its simplePathDelete
        # marks a multi-kmer path's start unitig twice, so only
        # SINGLE-kMER tips increment nbTipsRemoved (GraphUnitigs.cpp:
        # 1612-1628; Simplifications.cpp:578-589)
        self._visible_tips = int((is_tip & (a.nk == 1)).sum())
        if n_removed:
            self._delete_unitigs(ug, is_tip, us.node_unitig)
        self.stats.tips_removed += n_removed
        self.nb_tip_passes += 1
        return n_removed

    def _compact(self, limbs, counts):
        # one recompaction per live-set change, keyed on the live count
        cache = self._compact_cache
        if cache is not None and cache[0] == len(limbs):
            self._live_index = torch.nonzero(self._live())[:, 0]
            return cache[1], cache[2]
        us, ug = self._compact_uncached(limbs, counts)
        self._compact_cache = (len(limbs), us, ug)
        return us, ug

    def _compact_uncached(self, limbs, counts):
        """Recompact the live subset (``limbs``, ``counts``: its rows, on
        the device or numpy) into a unitig graph.

        The candidate ranks/flips of EVERY node are swept ONCE over the
        full solid table; each recompaction derives the live-subset
        adjacency and ranks by remapping that sweep through the live index,
        on the device. Exact: the live table keeps the sorted order, so
        live-rank = old2new[full-rank], and a candidate is present iff it
        was present in the full table AND its row is live."""
        from .graph_unitigs import link_unitigs

        dev, k = self.device, self.k
        n = len(limbs)
        live = self._live()
        self._live_index = torch.nonzero(live)[:, 0]
        if n == 0:
            us = build_unitigs(limbs, counts, np.zeros(0, np.uint8), k,
                               device=dev)
            return us, link_unitigs(limbs, us, k, device=dev)
        if self._full_ranks is None:
            self._full_sweep()
        live_idx = self._live_index
        N = self.graph.nb_nodes
        old2new = torch.full((N,), -1, dtype=I32, device=dev)
        old2new[live_idx] = torch.arange(n, dtype=I32, device=dev)
        fr = self._full_ranks[live_idx]          # (n, 8) full-table ranks
        safe = fr.clamp(0, max(N - 1, 0))
        ranks = torch.where((fr >= 0) & live[safe], old2new[safe], -1)
        del fr, safe, old2new
        flips = self._full_flips[live_idx]
        weights = 1 << torch.arange(8, dtype=I32, device=dev)
        adj = ((ranks >= 0).to(I32) * weights).sum(1).to(torch.uint8)
        us = build_unitigs(limbs, counts, adj, k, device=dev,
                           precomputed=(ranks, flips), lazy_sequences=True)
        ug = link_unitigs(limbs, us, k, device=dev,
                          precomputed=(ranks, flips))
        return us, ug

    def _full_sweep(self) -> None:
        """One candidate-ranks/flips sweep over the FULL solid table
        (deleted rows included: liveness is applied at remap time), kept on
        the device."""
        self._full_ranks, self._full_flips = cand_sweep(
            self.graph._padded_table(), self.graph.nb_nodes, self.k)

    def _chain_abundance(self, ug) -> torch.Tensor:
        """(U,) simplePathMeanAbundance of each unitig entered at an
        extremity, on a maximal unitig graph (GraphUnitigs.cpp:1507-1521):
        the traversal's coverage sums mean*(nk) (the first kmer cannot be
        excluded) but seqLength counts nk-1 extensions, so multi-kmer
        unitigs report mean * nk/(nk-1); single-kmer unitigs hit the
        isLast&&isFirst special case and report the plain mean. float64 on
        the device."""
        return self._arrays(ug).chain

    def _satisfy_rctc_batch(self, ug, ends, path_abundance,
                            cutoff: float) -> torch.Tensor:
        """Vectorized satisfyRCTC over an array of oriented path ends
        (satisfyRCTC, Simplifications.cpp:325-372; the per-branching-node
        mean is getMeanAbundanceOfNeighbors, :216-247). Reference-exact
        semantics, as in the JAX package:

        - branching nodes = the entry extremities reached by out_links(e)
        - each branching entry f (into unitig v) contributes the mean of
          v's own chain INTO v (only when nk_v > 1, at the inflated chain
          mean) and of each external edge AT that extremity: the backward
          links out_links(f^1) and, for single-kmer v, also the forward
          links out_links(f), each at the target's chain mean, skipping
          the edge back to the path (target == e^1)
        - a branching node with ZERO contributions sinks the whole query
          (0/0 -> nan in the reference)
        - satisfied iff the mean over branching nodes > cutoff *
          path_abundance.

        ``ends``, ``path_abundance``: numpy arrays or device tensors.
        Returns (Q,) bool on the device."""
        a = self._arrays(ug)
        dev = a.deg.device
        ends = _on(ends, I64, dev)
        path_abundance = _on(path_abundance, F64, dev)
        q = ends.shape[0]
        win = a.window(ends)                      # (Q, 4) entries f
        has = win >= 0
        if not bool(has.any()):
            return torch.zeros(q, dtype=torch.bool, device=dev)
        excl = ends ^ 1                           # the edge back to the path
        qidx = torch.arange(q, device=dev)[:, None].expand(q, 4)[has]
        bflat = win[has]                          # (B,) in numpy's order
        multi = a.nk[bflat >> 1] > 1              # (B,) has a within edge
        sums = torch.where(multi, a.chain[bflat >> 1], 0.0)
        cnts = multi.to(I64)

        # level 2: backward links (columns 0-3), then forward links of a
        # single-kmer unitig (4-7): the array order of JAX's bincount
        t = torch.cat([a.window(bflat ^ 1),
                       torch.where(multi[:, None], -1, a.window(bflat))], 1)
        keep = (t >= 0) & (t != excl[qidx][:, None])
        sums = sums + _ordered_sum(
            torch.where(keep, a.chain[t.clamp(min=0) >> 1], 0.0))
        cnts = cnts + keep.sum(1)

        # nan semantics: any zero-contribution branching node sinks the
        # whole query
        has_zero = torch.zeros(q, dtype=I64, device=dev).index_add_(
            0, qidx, (cnts == 0).to(I64)) > 0
        mean_b = torch.zeros((q, 4), dtype=F64, device=dev)
        mean_b[has] = sums / cnts.clamp(min=1)    # (B,) per-branching mean
        mean_neighbors = _ordered_sum(mean_b) / has.sum(1)
        return ~has_zero & (mean_neighbors > cutoff * path_abundance)

    # ------------------------------------------------------------------
    def remove_erroneous_connections(self) -> int:
        """One EC pass (removeErroneousConnections,
        Simplifications.cpp:1639-1850): short unitig connected on both
        sides, with low relative coverage (RCTC cutoff 4)."""
        k = self.k
        live = self._live()
        if not bool(live.any()):
            return 0
        us, ug = self._compact(*self._rows(live))
        a = self._arrays(ug)
        deg, nk = a.deg, a.nk
        max_ec = int(k * self.EC_LEN_KMULT)
        u_all = torch.arange(ug.nb_unitigs, device=self.device)
        is_ec = torch.zeros(ug.nb_unitigs, dtype=torch.bool,
                            device=self.device)

        # evaluate each orientation p of each unitig: pathLen = nk-1 > 0,
        # k + pathLen <= 9k, a behind-node with out-branching toward the
        # path, and the doubly-connected end check on the FIRST
        # out-neighbor (the lexsorted link order)
        for flip in (0, 1):
            p_all = 2 * u_all + flip
            base = (nk > 1) & (a.lens <= max_ec) & (deg[p_all] > 0) \
                & (deg[p_all ^ 1] > 0)
            cidx = torch.nonzero(base)[:, 0]
            if not len(cidx):
                continue
            p = p_all[cidx]

            # candidacy from behind: some e in out_links(p^1) with
            # out-branching back toward the path (|out_links(e^1)| >= 2)
            # and a non-dead other side — Simplifications.cpp:1697-1704
            e = a.window(p ^ 1)
            e0 = e.clamp(min=0)
            qual = (e >= 0) & (deg[e0 ^ 1] >= 2) \
                & ((nk[e0 >> 1] > 1) | (deg[e0] >= 1))
            behind_ok = qual.any(1)

            # doubly-connected end (Simplifications.cpp:1777-1780)
            f0 = a.link_t[a.link_o[p]]
            dc = (deg[f0 ^ 1] > 1) & ((nk[f0 >> 1] > 1) | (deg[f0] >= 1))

            sidx = torch.nonzero(behind_ok & dc)[:, 0]
            if not len(sidx):
                continue
            ps = p[sidx]
            ab = a.chain[ps >> 1]
            # RCTC in EITHER direction removes the EC
            # (Simplifications.cpp:1790-1793, the |= of both calls)
            ok = self._satisfy_rctc_batch(ug, ps, ab, self.EC_RCTC_CUTOFF)
            ok |= self._satisfy_rctc_batch(ug, ps ^ 1, ab,
                                           self.EC_RCTC_CUTOFF)
            is_ec[cidx[sidx[ok]]] = True

        n_removed = int(is_ec.sum())
        if n_removed:
            self._delete_unitigs(ug, is_ec, us.node_unitig)
        self.stats.ec_removed += n_removed
        self.nb_ec_passes += 1
        return n_removed

    # ------------------------------------------------------------------
    def remove_bulges(self) -> int:
        """One bulge pass (removeBulges, Simplifications.cpp:1301-1630):
        a short unitig whose endpoints are also connected by an
        alternative, better-covered path.

        As in the JAX package: each oriented extremity `a` with >= 2
        out-links plays the reference's (node, dir), its links the
        neighbor paths; every candidate goes through the lockstep walker
        (`_hmcp_batch`), the per-candidate recursion only where it flags a
        fallback, and the FIRST accepted link of each `a` is the one
        deletion per (node, dir) (Simplifications.cpp:1552)."""
        k = self.k
        live = self._live()
        if not bool(live.any()):
            return 0
        us, ug = self._compact(*self._rows(live))
        a = self._arrays(ug)
        deg, nk, lens, chain = a.deg, a.nk, a.lens, a.chain
        max_bulge = max(int(k * self.BULGE_LEN_KMULT),
                        k + self.BULGE_LEN_KADD)
        backtrack = k + self.BULGE_ALTPATH_KADD

        is_bulge = torch.zeros(ug.nb_unitigs, dtype=torch.bool,
                               device=self.device)
        a_all = torch.nonzero(deg >= 2)[:, 0]
        win = a.window(a_all)
        has = win >= 0
        c_a = a_all[:, None].expand_as(win)[has]  # (C,) the branching node
        c_t = win[has]                            # (C,) neighbor path entry
        ui = c_t >> 1
        keep = (c_t != (c_a ^ 1)) & (nk[ui] > 1) & (lens[ui] <= max_bulge) \
            & (deg[c_t] > 0)
        c_a, c_t, ui = c_a[keep], c_t[keep], ui[keep]
        c_f0 = a.link_t[a.link_o[c_t]]            # outneighbors[0]
        keep = deg[c_f0 ^ 1] > 1                  # isDoublyConnected
        c_a, c_t, ui, c_f0 = c_a[keep], c_t[keep], ui[keep], c_f0[keep]

        if len(c_a):
            path_len = nk[ui] - 1
            maxlens = torch.maximum((path_len.to(F64) * 1.1).to(I64),
                                    path_len + 3)            # SPAdes
            alt, need_fb = self._hmcp_batch(ug, c_a, c_f0, c_t, maxlens,
                                            backtrack)
            fb = torch.nonzero(need_fb)[:, 0]
            if len(fb):
                got = [self._hmcp_unitigs(ug, s, t, avoid=v, maxlen=m,
                                          backtrack_limit=backtrack)
                       for s, t, v, m in torch.stack(
                           [c_a[fb], c_f0[fb], c_t[fb], maxlens[fb]], 1)
                       .tolist()]
                alt[fb] = torch.tensor(
                    [np.nan if x is None else x for x in got], dtype=F64,
                    device=self.device)
            # accept: bulge chain coverage <= alt coverage * 1.1
            # (Simplifications.cpp:1521-1525)
            accept = torch.nonzero(~torch.isnan(alt) & (
                chain[ui] <= alt * self.BULGE_ALTPATH_COVMULT))[:, 0]
            if len(accept):
                # one deletion per (node, dir): the first accepted link of
                # each a (c_a is ascending)
                _, cnt = torch.unique_consecutive(c_a[accept],
                                                  return_counts=True)
                is_bulge[ui[accept[torch.cumsum(cnt, 0) - cnt]]] = True

        n_removed = int(is_bulge.sum())
        if n_removed:
            self._delete_unitigs(ug, is_bulge, us.node_unitig)
        self.stats.bulges_removed += n_removed
        self.nb_bulge_passes += 1
        return n_removed

    def _hmcp_unitigs(self, ug, start: int, target: int, avoid: int,
                      maxlen: int, backtrack_limit: int):
        """Most-covered alternative path search, unitig flavor: the port
        of heuristic_most_covered_path_unitigs (Simplifications.cpp:
        1034-1230), host Python over host copies of the CSR arrays, copied
        from the JAX package: greedy descent in decreasing (truncated)
        chain abundance, loop abort per call, depth budget in extensions,
        the nbCalls backtracking limit (HMCP_MAX_DEPTH), and the
        length-weighted chain mean (unitigs_chain2abundance, :665-680).

        `start` is the oriented id whose out_links are the branching
        node's expansions; `target` the oriented entry to reach; `avoid`
        the bulge path's entry, skipped only at the top expansion. Returns
        the mean coverage of the found path, or None."""
        chain = self._chain_abundance(ug).cpu().numpy()
        nk = np.asarray(ug.kmer_counts)
        deg = np.diff(ug.link_offsets)
        state = {"calls": 0, "aborted": False}

        def wmean(lens_, covs_):
            total = sum(lens_)
            if total == 0:
                return None  # 0/0 -> nan in the reference: never accepted
            return sum(l * c for l, c in zip(lens_, covs_)) / total

        # visited tracks EXTREMITY identities as oriented ids (entry
        # extremity of oriented t <-> id t; its exit <-> t ^ 1)

        def expand(cur, depth, extra, visited, lens_, covs_, avoid_first):
            """Neighbor ordering + recursion at a branching/dead end
            (Simplifications.cpp:1155-1227)."""
            cand = []
            for t in ug.out_links(cur):
                t = int(t)
                if avoid_first is not None and t == avoid_first:
                    continue
                if t in visited:
                    return None              # HMCP_LOOP aborts this call
                cand.append(t)
            # ordered by abundance TRUNCATED TO INT, ties on the oriented id
            cand.sort(key=lambda t: (-int(chain[t >> 1]), t))
            for t in cand:
                got = rec(t, depth - extra, visited | {t}, lens_, covs_)
                if backtrack_limit > 0 and \
                        state["calls"] >= backtrack_limit:
                    # HMCP_MAX_DEPTH: checked BEFORE the found-end check
                    # (Simplifications.cpp:1216-1226)
                    state["aborted"] = True
                    return None
                if state["aborted"] or got is not None:
                    return got
            return None

        def rec(entry, depth, visited, lens_, covs_):
            """One level: `entry` was just entered at its head extremity."""
            if depth < -1:
                return None                  # HMCP_DIDNT_FIND_END
            if entry == target:
                return wmean(lens_, covs_)   # current_node == endNode
            extra = 1
            cur = entry
            while True:
                tl = int(nk[cur >> 1]) - 1
                if tl > 0:                   # traverse own simple path
                    lens_ = lens_ + [tl]
                    # unitigs_abundances is vector<int> in the reference
                    # (Simplifications.hpp:107): truncated to int
                    covs_ = covs_ + [float(int(chain[cur >> 1]))]
                    state["calls"] += tl + 1
                    extra += tl + 1
                    if (cur ^ 1) == target:  # processNode(lastNode)
                        return wmean(lens_, covs_)
                    if (cur ^ 1) in visited:
                        return None          # HMCP_LOOP
                    visited = visited | {cur ^ 1}
                if deg[cur] != 1:
                    break                    # dead end or out-branching
                nxt = int(ug.out_links(cur)[0])
                if deg[nxt ^ 1] <= 1:        # self-linked kmer oddity
                    return None              # (GraphUnitigs loop guard)
                state["calls"] += 1
                extra += 1
                if nxt == target:            # processNode(next)
                    return wmean(lens_, covs_)
                if nxt in visited:
                    return None              # HMCP_LOOP
                visited = visited | {nxt}
                cur = nxt
            return expand(cur, depth, extra, visited, lens_, covs_, None)

        # top level: start is a LAST node (pathLen 0) at a branching
        # extremity — straight to the avoidFirstNode-aware expansion
        if start == target:
            return None                      # empty chain -> nan
        return expand(start, maxlen, 1, {start}, [], [], avoid)

    def _hmcp_batch(self, ug, starts, targets, avoids, maxlens,
                    backtrack_limit: int):
        """Lockstep batch evaluation of `_hmcp_unitigs` over C candidates,
        torch on the device: the GREEDY FIRST-DESCENT of the recursion for
        all candidates at once, decision-exact by three invariants of the
        recursive search (the JAX package's docstring states them):
        success on the first descent is what the recursion returns; once
        ``calls >= backtrack_limit`` the answer is None; a first-descent
        failure with no untried sibling on the stack (``pending`` False)
        is a global failure. Only a failure with pending alternatives and
        an unspent budget needs the real backtracking recursion: those are
        flagged in ``need_fallback``. Returns (alt_cov float64 with nan for
        None, need_fallback bool), device tensors of the candidates'
        order."""
        a = self._arrays(ug)
        dev = a.deg.device
        starts, targets, avoids, maxlens = (
            _on(x, I64, dev) for x in (starts, targets, avoids, maxlens))
        C = starts.shape[0]
        chain_i = a.chain.to(I64)                 # truncated toward zero
        nk, deg, link_t, link_o = a.nk, a.deg, a.link_t, a.link_o
        twoU = 2 * ug.nb_unitigs + 2
        four = torch.arange(4, device=dev)

        REC, CHAIN, EXPAND = 0, 1, 2
        iter_max = max(4 * max(backtrack_limit, 1), 256)
        maxv = iter_max + 2

        res = torch.full((C,), float("nan"), dtype=F64, device=dev)
        need_fb = torch.zeros(C, dtype=torch.bool, device=dev)
        # state
        cur = starts.clone()
        depth = maxlens.clone()
        extra = torch.ones(C, dtype=I64, device=dev)
        calls = torch.zeros(C, dtype=I64, device=dev)
        wsum = torch.zeros(C, dtype=F64, device=dev)
        wtot = torch.zeros(C, dtype=I64, device=dev)
        pending = torch.zeros(C, dtype=torch.bool, device=dev)
        mode = torch.full((C,), EXPAND, dtype=I64, device=dev)
        first_expand = torch.ones(C, dtype=torch.bool, device=dev)
        vis = torch.full((C, maxv), -1, dtype=I64, device=dev)
        vis[:, 0] = cur
        vlen = torch.ones(C, dtype=I64, device=dev)
        active = starts != targets                # start==target -> nan

        def budget_blown(idx):
            if backtrack_limit <= 0:
                return torch.zeros(len(idx), dtype=torch.bool, device=dev)
            return calls[idx] >= backtrack_limit

        def fail(idx):
            # definitive None unless backtracking could have rescued it:
            # pending siblings AND budget unspent
            need_fb[idx[pending[idx] & ~budget_blown(idx)]] = True
            active[idx] = False

        def succeed(idx):
            ok = wtot[idx] > 0
            blown = budget_blown(idx)
            good = idx[ok & ~blown]
            res[good] = wsum[good] / wtot[good]
            # success with 0 total length -> nan (never accepted); with
            # blown budget -> unwind aborts it
            need_fb[idx[~ok & pending[idx] & ~blown]] = True
            active[idx] = False

        def visited_has(idx, x):
            return (vis[idx] == x[:, None]).any(1)

        def visit(idx, x):
            over = vlen[idx] >= maxv              # visited overflow
            need_fb[idx[over]] = True
            active[idx[over]] = False
            idx, x = idx[~over], x[~over]
            vis[idx, vlen[idx]] = x
            vlen[idx] += 1

        for _ in range(iter_max):
            if not bool(active.any()):
                break
            # ---- REC entry: depth check + target check ----------------
            idx = torch.nonzero(active & (mode == REC))[:, 0]
            if len(idx):
                bad = depth[idx] < -1
                fail(idx[bad])                # HMCP_DIDNT_FIND_END
                idx = idx[~bad]
                hit = cur[idx] == targets[idx]
                succeed(idx[hit])
                idx = idx[~hit]
                extra[idx] = 1
                mode[idx] = CHAIN

            # ---- CHAIN: process cur's unitig, then follow deg==1 ------
            idx = torch.nonzero(active & (mode == CHAIN))[:, 0]
            if len(idx):
                tl = nk[cur[idx] >> 1] - 1
                multi = tl > 0
                m_i = idx[multi]
                if len(m_i):
                    tli = tl[multi]
                    wsum[m_i] += tli.to(F64) * chain_i[cur[m_i] >> 1].to(F64)
                    wtot[m_i] += tli
                    calls[m_i] += tli + 1
                    extra[m_i] += tli + 1
                    rev = cur[m_i] ^ 1
                    hit = rev == targets[m_i]
                    succeed(m_i[hit])
                    m_i, rev = m_i[~hit], rev[~hit]
                    loop = visited_has(m_i, rev)
                    fail(m_i[loop])           # HMCP_LOOP
                    m_i, rev = m_i[~loop], rev[~loop]
                    visit(m_i, rev)
                idx = idx[active[idx]]
                branch = deg[cur[idx]] != 1
                mode[idx[branch]] = EXPAND
                s_i = idx[~branch]            # single out-link: step
                if len(s_i):
                    nxt = link_t[link_o[cur[s_i]]]
                    dead = deg[nxt ^ 1] <= 1  # self-linked kmer oddity
                    fail(s_i[dead])
                    s_i, nxt = s_i[~dead], nxt[~dead]
                    calls[s_i] += 1
                    extra[s_i] += 1
                    hit = nxt == targets[s_i]
                    succeed(s_i[hit])
                    s_i, nxt = s_i[~hit], nxt[~hit]
                    loop = visited_has(s_i, nxt)
                    fail(s_i[loop])
                    s_i, nxt = s_i[~loop], nxt[~loop]
                    visit(s_i, nxt)
                    cur[s_i] = nxt            # stay in CHAIN

            # ---- EXPAND: sorted-candidate descent (first child) -------
            idx = torch.nonzero(active & (mode == EXPAND))[:, 0]
            if len(idx):
                cand = link_t[link_o[cur[idx]][:, None] + four]  # (n, 4)
                valid = four < deg[cur[idx]][:, None]
                valid &= ~(first_expand[idx][:, None]
                           & (cand == avoids[idx][:, None]))
                # any (non-avoid) candidate already visited aborts the
                # whole expansion (HMCP_LOOP at Simplifications.cpp:1164)
                seen = (cand[:, :, None] == vis[idx][:, None, :]).any(2)
                fail(idx[(valid & seen).any(1)])
                live = active[idx]
                idx, cand, valid = idx[live], cand[live], valid[live]
                fail(idx[~valid.any(1)])      # no candidates: dead end
                live = active[idx]
                idx, cand, valid = idx[live], cand[live], valid[live]
                if len(idx):
                    # ascending by (-int(chain), t): the reference's
                    # candidate order (Simplifications.cpp:1160-1190)
                    key = chain_i[cand.clamp(min=0) >> 1] * -twoU + cand
                    key = torch.where(valid, key, torch.iinfo(I64).max)
                    t0 = cand[torch.arange(len(idx), device=dev),
                              torch.argmin(key, 1)]
                    pending[idx] |= valid.sum(1) > 1
                    depth[idx] -= extra[idx]
                    visit(idx, t0)
                    live = active[idx]
                    idx, t0 = idx[live], t0[live]
                    cur[idx] = t0
                    first_expand[idx] = False
                    mode[idx] = REC

        # anything still walking after iter_max steps: punt to recursion
        need_fb[active] = True
        return res, need_fb

    # ------------------------------------------------------------------
    def simplify(self, do_tips: bool = True, do_bulges: bool = True,
                 do_ec: bool = True) -> SimplifyStats:
        """Full orchestration — the reference's exact pass schedule
        (Simplifications::simplify, Simplifications.cpp:111-215): tip
        rounds to quiescence, ONE bulge round, ONE EC round, then bulge
        rounds, EC rounds, then mixed rounds — with the reference's
        per-stage loop conditions and the `n + n + ...` removal report
        strings. The loop counters replicate what the reference's passes
        SEE (only single-kmer tips; bulges and ECs always 0, so their loops
        run exactly 3 passes each); cutoffEvents divides the number of
        unitig EXTREMITIES (the JAX package's docstring explains both)."""
        _, ug0 = self._compact(*self._rows(self._live()))
        nk0 = np.asarray(ug0.kmer_counts)
        nb_extremities = int(2 * ug0.nb_unitigs - (nk0 == 1).sum())
        cutoff_events = max(nb_extremities // 10000, 1)

        def join(s, n):
            return (s + " + " if s else s) + str(n)

        tips = 0   # reference-visible counter
        if do_tips:
            while True:
                prev = tips
                self.remove_tips()
                tips = self._visible_tips
                self.stats.passes += 1
                self.tip_removal = join(self.tip_removal, tips)
                if not (((prev == 0 and tips > 0)
                         or (self.nb_tip_passes <= 2
                             or tips >= cutoff_events))
                        and self.nb_tip_passes < 20):
                    break

        # one bulge round then one EC round before looping each
        if do_bulges:
            self.remove_bulges()
            self.stats.passes += 1
            self.bubble_removal = join(self.bubble_removal, 0)
        if do_ec:
            self.remove_erroneous_connections()
            self.stats.passes += 1
            self.ec_removal = join(self.ec_removal, 0)

        if do_bulges:
            while True:  # visible count 0: runs until nb passes > 2
                self.remove_bulges()
                self.stats.passes += 1
                self.bubble_removal = join(self.bubble_removal, 0)
                if not (self.nb_bulge_passes <= 2
                        and self.nb_bulge_passes < 20):
                    break

        if do_ec:
            while True:
                self.remove_erroneous_connections()
                self.stats.passes += 1
                self.ec_removal = join(self.ec_removal, 0)
                if not (self.nb_ec_passes <= 2
                        and self.nb_ec_passes < 20):
                    break

        # final mixed rounds (Simplifications.cpp:186-214): the loop
        # continues only while a pass removes >= cutoffEvents single-kmer
        # tips
        if do_tips and do_bulges and do_ec:
            while True:
                self.remove_tips()
                tips = self._visible_tips
                self.remove_bulges()
                self.remove_erroneous_connections()
                self.stats.passes += 3
                self.tip_removal = join(self.tip_removal, tips)
                self.bubble_removal = join(self.bubble_removal, 0)
                self.ec_removal = join(self.ec_removal, 0)
                if not (tips >= cutoff_events
                        and self.nb_tip_passes < 30):
                    break
        return self.stats

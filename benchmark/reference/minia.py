"""Minia's assembly worked out again from the reference's own graph: the
simplification (tips, bulges, erroneous connections) and the Monument
contigs, in plain torch, numpy and Python.

It starts from ``dbg.Truth`` (the solid k-mers, ascending, and their
counts; k <= 31), builds its own oriented graph and compacts the live
graph into unitigs itself after every change. It imports nothing of the
program and nothing of JAX.

The graph. A node is a canonical k-mer; an oriented node is ``2i + s``
(``s = 1`` the reverse complement of node ``i``); its out-neighbour by
nucleotide ``nt`` (codes A=0, C=1, T=2, G=3) is the k-mer that drops the
first base and appends ``nt``, where it is a live node. A unitig is a
maximal chain of edges ``o -> p`` with out-degree(o) = in-degree(p) = 1,
``p`` neither ``o`` nor its twin; a cycle of such edges is cut before its
least oriented id. Of a chain and its twin chain the one whose head has
the smaller oriented id is kept, and unitigs are numbered in the order
of their heads. An oriented unitig is ``2u`` (as kept) or ``2u + 1``;
its links go to the oriented unitigs its last k-mer steps into, sorted
by target.

The simplification follows GATB's Simplifications.cpp (its constants,
:93-105) on the schedule of the JAX package's ``Simplifications.simplify``
(tip rounds to quiescence, one bulge and one EC round, bulge rounds, EC
rounds, then mixed rounds), with the quirks that the JAX package keeps
from GATB: a path's abundance is the chain mean inflated by nk/(nk-1);
the neighbours' mean counts a branching entry's own chain once and gives
nan (never satisfied) where an entry has no contribution; an EC is
removed if the relative-coverage test holds in either direction; at most
one bulge is deleted per (branching node, direction) and pass; the
alternative path search (HMCP) orders neighbours by abundances truncated
to integers and discards what it finds once its call budget is spent;
the loop counters see only single-k-mer tips, so the bulge and EC loops
run three passes each; ``cutoffEvents`` divides unitig extremities.

Where it departs from GATB, as the JAX package does: ties between equal
abundances fall to the smaller oriented unitig id (GATB's fall to its own
unitig numbering); float sums are taken in the JAX package's order (a
branching entry's own chain plus the left-to-right sum of its other
edges; a unitig's mean abundance is a float32 before it is inflated).

Monument (Traversal.cpp:376-724, with Frontline.cpp's breadth-first
frontier): contigs are walked from every unmarked live node, first the
boundary nodes (in- or out-degree other than 1), then the rest, each in
node order, to the right of the node and then to its left; a contig
shorter than 2k+1 is dropped. A step follows the only out-edge into a
node of in-degree 1 that is not marked; any other step explores the
branching: a frontier advanced to depth 500 and breadth 20 that stops at
a marked node or at an in-branching whose backward walk reaches depth 4,
every path of at most the end's depth + 1 to the node where the
frontier narrowed to one (at most 51 of them), validated (mean length at
most 500, a lone path at most k + 1 long, spread at most a fifth of the
mean, every two at least 80% identical by Needleman-Wunsch with match
10, mismatch and gap -5), the most abundant taken, and every node the
frontier saw marked. Departures, as in the program: of equal abundances
the first path in sorted order is taken; a walk stops at 1,000,000 bases.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from . import kmers as K

I64 = torch.int64
CHUNK = 1 << 22
NTS = b"ACTG"
LETTERS = NTS.decode()
_CHAR = bytes.maketrans(bytes(range(4)), NTS)
_COMP_CHAR = bytes.maketrans(bytes(range(4)), b"TGAC")

# GATB's constants (Simplifications.cpp:93-105; Traversal.hpp:169-170, 368)
TIP_TOPO_K, TIP_RCTC_K, TIP_CUTOFF = 2.5, 10.0, 2.0
BULGE_K, BULGE_ADD, BULGE_BACKTRACK, BULGE_COV = 3.0, 100, 50, 1.1
EC_K, EC_CUTOFF = 9.0, 4.0
MAX_DEPTH, MAX_BREADTH, IDENTITY, MAX_PATHS = 500, 20, 80, 50
MAX_LEN = 1_000_000


def out_table(nodes: torch.Tensor, k: int) -> torch.Tensor:
    """(2N, 4) int64: the oriented out-neighbour of every oriented node by
    nucleotide, -1 where that k-mer is not a node."""
    n = nodes.numel()
    mask = (1 << (2 * k)) - 1
    out = torch.full((2 * n, 4), -1, dtype=I64, device=nodes.device)
    for s in range(0, n, CHUNK):
        v = nodes[s:s + CHUNK]
        for strand, fwd in ((0, v), (1, K.revcomp(v, k))):
            rc = K.revcomp(fwd, k)
            for nt in range(4):
                w = ((fwd << 2) | nt) & mask
                w_rc = (rc >> 2) | ((nt ^ 2) << (2 * k - 2))
                c = torch.minimum(w, w_rc)
                j = K.rank(nodes, c)
                out[2 * s + strand:2 * (s + v.numel()):2, nt] = torch.where(
                    j >= 0, 2 * j + (w != c).to(I64), -1)
    return out


def _double_rounds(m: int) -> int:
    return max(1, (max(m, 2) - 1).bit_length()) + 1


class Compaction:
    """The live graph's unitigs and links; the unitig arrays on the host,
    the node arrays on the device."""

    def __init__(self, out: torch.Tensor, live: torch.Tensor,
                 counts: torch.Tensor, k: int):
        dev = out.device
        n2 = out.shape[0]
        ids = torch.arange(n2, device=dev)
        live_o = live.repeat_interleave(2)
        tgt = out.clamp(min=0)
        lo = torch.where((out >= 0) & live[tgt >> 1] & live_o[:, None],
                         out, -1)
        deg = (lo >= 0).sum(1)
        indeg = deg.reshape(-1, 2).flip(1).reshape(-1)
        self.lo, self.deg_o = lo, deg
        # the internal edges, and each one's reverse as a pointer
        nxt = lo.max(1).values
        inner = (deg == 1) & (indeg[nxt.clamp(min=0)] == 1) & (nxt != ids) \
            & (nxt != (ids ^ 1))
        par = ids.clone()
        par[nxt[inner]] = ids[inner]
        rounds = _double_rounds(n2)
        # cut each cycle before its least member
        up, least = par.clone(), ids.clone()
        for _ in range(rounds):
            least = torch.minimum(least, least[up])
            up = up[up]
        par = torch.where((par[up] != up) & (least == ids), ids, par)
        dist = (par != ids).to(I64)
        up = par
        for _ in range(rounds):
            dist = dist + dist[up]
            up = up[up]
        root = up
        keep = live_o & (root <= root[root ^ 1])
        heads, u_of, nk = torch.unique(root[keep], sorted=True,
                                       return_inverse=True,
                                       return_counts=True)
        u_count = heads.numel()
        o_kept = ids[keep]
        node = o_kept >> 1
        n = live.numel()
        self.node_u = torch.full((n,), -1, dtype=I64, device=dev)
        self.node_u[node] = u_of
        self.node_pos = torch.zeros((n,), dtype=I64, device=dev)
        self.node_pos[node] = dist[keep]
        self.node_strand = torch.zeros((n,), dtype=I64, device=dev)
        self.node_strand[node] = o_kept & 1
        tails = torch.zeros((u_count,), dtype=I64, device=dev)
        last = dist[keep] == nk[u_of] - 1
        tails[u_of[last]] = o_kept[last]
        sums = torch.zeros((u_count,), dtype=I64, device=dev)
        sums.index_add_(0, u_of, counts[node])
        mean = (sums.to(torch.float64) / nk.to(torch.float64)) \
            .to(torch.float32)
        # links: the last k-mer of 2u is the tail, of 2u+1 the head's
        # twin; they enter 2v at v's head, 2v+1 at the twin of v's tail
        entry = torch.full((n2,), -1, dtype=I64, device=dev)
        uu = torch.arange(u_count, device=dev)
        entry[heads] = 2 * uu
        entry[tails ^ 1] = 2 * uu + 1
        src_last = torch.stack([tails, heads ^ 1], 1).reshape(-1)
        t = lo[src_last]
        t = torch.where(t >= 0, entry[t.clamp(min=0)], -1)
        src = torch.arange(2 * u_count, device=dev)[:, None].expand_as(t)
        ok = t >= 0
        key = torch.sort(src[ok] * (2 * u_count) + t[ok]).values
        link_t = key % max(2 * u_count, 1)
        link_o = torch.zeros((2 * u_count + 1,), dtype=I64, device=dev)
        link_o[1:] = torch.cumsum(torch.bincount(
            key // max(2 * u_count, 1), minlength=2 * u_count), 0)
        self.u_count = u_count
        self.nk = nk.cpu().numpy()
        self.lens = self.nk + k - 1
        mean64 = mean.cpu().numpy().astype(np.float64)
        nkf = self.nk.astype(np.float64)
        self.chain = np.where(self.nk > 1,
                              mean64 * nkf / np.maximum(nkf - 1.0, 1.0),
                              mean64)
        self.link_o = link_o.cpu().numpy()
        self.link_t = link_t.cpu().numpy()
        self.deg = np.diff(self.link_o)
        self._pad = np.concatenate([self.link_t, np.full(4, -1, np.int64)])

    def window(self, a: np.ndarray) -> np.ndarray:
        """(len(a), 4) out-links of the oriented unitigs ``a`` in link
        order, -1 past each one's degree."""
        j = np.arange(4)
        t = self._pad[self.link_o[a][:, None] + j]
        return np.where(j < self.deg[a][:, None], t, -1)

    def first_link(self, a: np.ndarray) -> np.ndarray:
        return self._pad[self.link_o[a]]

    def delete(self, live: torch.Tensor, which: np.ndarray) -> None:
        """Delete every node of the unitigs ``which`` (bool (U,))."""
        sel = torch.from_numpy(which).to(live.device)
        u = self.node_u
        live[(u >= 0) & sel[u.clamp(min=0)]] = False


def _col_sum(m: np.ndarray) -> np.ndarray:
    """Row sums of a float64 matrix, left to right from 0.0."""
    acc = np.zeros(m.shape[0], np.float64)
    for j in range(m.shape[1]):
        acc = acc + m[:, j]
    return acc


def relative_coverage(c: Compaction, ends: np.ndarray, path_ab: np.ndarray,
                      cutoff: float) -> np.ndarray:
    """GATB's satisfyRCTC (Simplifications.cpp:216-372) for oriented path
    ends: the mean over the branching entries the end links to of each
    entry's mean neighbour abundance (its own chain where it has more
    than one k-mer, the links out of its far side but the one back to the
    path, and for a one-k-mer entry also its forward links) exceeds
    ``cutoff`` times the path's abundance."""
    q = len(ends)
    win = c.window(ends)
    has = win >= 0
    f = win.clip(min=0)
    v = f >> 1
    multi = c.nk[v] > 1
    own = np.where(multi, c.chain[v], 0.0)
    cnt = multi.astype(np.int64)
    back = c.window((f ^ 1).reshape(-1)).reshape(q, 4, 4)
    fwd = np.where(multi[:, :, None], -1,
                   c.window(f.reshape(-1)).reshape(q, 4, 4))
    t = np.concatenate([back, fwd], 2)
    keep = (t >= 0) & (t != (ends ^ 1)[:, None, None])
    other = _col_sum(np.where(keep, c.chain[t.clip(min=0) >> 1], 0.0)
                     .reshape(q * 4, 8)).reshape(q, 4)
    cnt = cnt + keep.sum(2)
    zero = (has & (cnt == 0)).any(1)
    mean_b = np.where(has, (own + other) / np.maximum(cnt, 1), 0.0)
    n_has = has.sum(1)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_n = _col_sum(mean_b) / n_has
    return (n_has > 0) & ~zero & (mean_n > cutoff * path_ab)


def most_covered_path(lists, start: int, target: int, avoid: int,
                      maxlen: int, budget: int):
    """GATB's heuristic_most_covered_path_unitigs (Simplifications.cpp:
    1034-1230): a depth-first descent from ``start``'s out-links (but
    ``avoid``) to ``target``, neighbours in decreasing truncated abundance
    (ties to the smaller id), a loop aborting the call it is found in,
    the depth counted in extensions, and the search given up once its
    calls reach ``budget``. ``lists``: the compaction's link offsets,
    link targets, k-mer counts and truncated chain abundances, as Python
    lists. Returns the found path's length-weighted mean truncated
    abundance, or None."""
    link_o, link_t, nk, chain_i = lists
    calls = [0]
    gave_up = [False]

    def links(a):
        return link_t[link_o[a]:link_o[a + 1]]

    def mean(lens, covs):
        total = sum(lens)
        if total == 0:
            return None
        return sum(x * y for x, y in zip(lens, covs)) / total

    def branch(cur, depth, extra, seen, lens, covs, skip):
        nbrs = []
        for t in links(cur):
            if t == skip:
                continue
            if t in seen:
                return None
            nbrs.append(t)
        nbrs.sort(key=lambda t: (-chain_i[t >> 1], t))
        for t in nbrs:
            got = descend(t, depth - extra, seen | {t}, lens, covs)
            if budget > 0 and calls[0] >= budget:
                gave_up[0] = True
                return None
            if gave_up[0] or got is not None:
                return got
        return None

    def descend(cur, depth, seen, lens, covs):
        if depth < -1:
            return None
        if cur == target:
            return mean(lens, covs)
        extra = 1
        while True:
            inner = nk[cur >> 1] - 1
            if inner > 0:
                lens = lens + [inner]
                covs = covs + [float(chain_i[cur >> 1])]
                calls[0] += inner + 1
                extra += inner + 1
                if cur ^ 1 == target:
                    return mean(lens, covs)
                if cur ^ 1 in seen:
                    return None
                seen = seen | {cur ^ 1}
            out = links(cur)
            if len(out) != 1:
                break
            nxt = out[0]
            if link_o[(nxt ^ 1) + 1] - link_o[nxt ^ 1] <= 1:
                return None
            calls[0] += 1
            extra += 1
            if nxt == target:
                return mean(lens, covs)
            if nxt in seen:
                return None
            seen = seen | {nxt}
            cur = nxt
        return branch(cur, depth, extra, seen, lens, covs, None)

    if start == target:
        return None
    return branch(start, maxlen, 1, {start}, [], [], avoid)


class Minia:
    """Simplify the graph of ``truth`` and assemble its Monument contigs."""

    def __init__(self, truth, no_ec: bool = False):
        self.k = truth.k
        self.nodes = truth.nodes
        self.counts = truth.counts.to(I64)
        self.out = out_table(self.nodes, self.k)
        self.live = torch.ones(self.nodes.numel(), dtype=torch.bool,
                               device=self.nodes.device)
        self.no_ec = no_ec
        self._c = None
        self.stats = {"tips_removed": 0, "bulges_removed": 0,
                      "ec_removed": 0, "passes": 0, "tip_removal": "",
                      "bubble_removal": "", "ec_removal": ""}
        self.passes = {"tips": 0, "bulges": 0, "ecs": 0}

    def compaction(self) -> Compaction:
        if self._c is None:
            self._c = Compaction(self.out, self.live, self.counts, self.k)
        return self._c

    def _delete(self, c: Compaction, which: np.ndarray) -> int:
        n = int(which.sum())
        if n:
            c.delete(self.live, which)
            self._c = None
        return n

    # ---- the three passes ------------------------------------------
    def tips(self) -> int:
        """One tip pass; returns the one-k-mer tips (what GATB's loop
        counters see)."""
        c, k = self.compaction(), self.k
        self.passes["tips"] += 1
        d_f, d_r = c.deg[0::2], c.deg[1::2]
        one_dead = (d_f == 0) ^ (d_r == 0)
        topo = c.lens <= int(k * TIP_TOPO_K)
        tip = one_dead & topo
        cand = np.nonzero(one_dead & ~topo
                          & (c.lens <= int(k * TIP_RCTC_K)))[0]
        if len(cand):
            ends = np.where(d_f[cand] > 0, 2 * cand, 2 * cand + 1)
            ok = relative_coverage(c, ends, c.chain[cand], TIP_CUTOFF)
            tip[cand[ok]] = True
        seen = int((tip & (c.nk == 1)).sum())
        self.stats["tips_removed"] += self._delete(c, tip)
        return seen

    def ecs(self) -> None:
        c, k = self.compaction(), self.k
        self.passes["ecs"] += 1
        if self.no_ec:
            return
        ec = np.zeros(c.u_count, bool)
        u = np.arange(c.u_count)
        for flip in (0, 1):
            p = 2 * u + flip
            cand = np.nonzero((c.nk > 1) & (c.lens <= int(k * EC_K))
                              & (c.deg[p] > 0) & (c.deg[p ^ 1] > 0))[0]
            if not len(cand):
                continue
            p = p[cand]
            e = c.window(p ^ 1)
            e0 = e.clip(min=0)
            behind = ((e >= 0) & (c.deg[e0 ^ 1] >= 2)
                      & ((c.nk[e0 >> 1] > 1) | (c.deg[e0] >= 1))).any(1)
            f0 = c.first_link(p)
            doubly = (c.deg[f0 ^ 1] > 1) & ((c.nk[f0 >> 1] > 1)
                                            | (c.deg[f0] >= 1))
            sel = np.nonzero(behind & doubly)[0]
            if not len(sel):
                continue
            ps = p[sel]
            ab = c.chain[ps >> 1]
            ok = relative_coverage(c, ps, ab, EC_CUTOFF) \
                | relative_coverage(c, ps ^ 1, ab, EC_CUTOFF)
            ec[cand[sel[ok]]] = True
        self.stats["ec_removed"] += self._delete(c, ec)

    def bulges(self) -> None:
        c, k = self.compaction(), self.k
        self.passes["bulges"] += 1
        longest = max(int(k * BULGE_K), k + BULGE_ADD)
        budget = k + BULGE_BACKTRACK
        a = np.nonzero(c.deg >= 2)[0]
        win = c.window(a)
        has = win >= 0
        c_a = np.broadcast_to(a[:, None], win.shape)[has]
        c_t = win[has]
        v = c_t >> 1
        ok = (c_t != (c_a ^ 1)) & (c.nk[v] > 1) & (c.lens[v] <= longest) \
            & (c.deg[c_t] > 0)
        c_a, c_t, v = c_a[ok], c_t[ok], v[ok]
        f0 = c.first_link(c_t)
        ok = c.deg[f0 ^ 1] > 1
        c_a, c_t, v, f0 = c_a[ok], c_t[ok], v[ok], f0[ok]
        plen = c.nk[v] - 1
        maxlen = np.maximum((plen.astype(np.float64) * 1.1).astype(np.int64),
                            plen + 3)
        lists = (c.link_o.tolist(), c.link_t.tolist(), c.nk.tolist(),
                 c.chain.astype(np.int64).tolist())
        bulge = np.zeros(c.u_count, bool)
        done = -1
        for i, (ai, ti, vi, fi, mi) in enumerate(zip(
                c_a.tolist(), c_t.tolist(), v.tolist(), f0.tolist(),
                maxlen.tolist())):
            if ai == done:
                continue          # one deletion per (node, direction)
            alt = most_covered_path(lists, ai, fi, ti, mi, budget)
            if alt is not None and c.chain[vi] <= alt * BULGE_COV:
                bulge[vi] = True
                done = ai
        self.stats["bulges_removed"] += self._delete(c, bulge)

    # ---- the schedule --------------------------------------------------
    def simplify(self) -> dict:
        c = self.compaction()
        cutoff = max(int(2 * c.u_count - (c.nk == 1).sum()) // 10000, 1)
        st, nb = self.stats, self.passes

        def note(key, n):
            st[key] = (st[key] + " + " if st[key] else "") + str(n)

        seen = 0
        while True:
            prev, seen = seen, self.tips()
            st["passes"] += 1
            note("tip_removal", seen)
            if not (((prev == 0 and seen > 0) or nb["tips"] <= 2
                     or seen >= cutoff) and nb["tips"] < 20):
                break
        for run in (self.bulges, self.ecs):
            run()
            st["passes"] += 1
            note("bubble_removal" if run == self.bulges else "ec_removal", 0)
        for run, key, name in ((self.bulges, "bulges", "bubble_removal"),
                               (self.ecs, "ecs", "ec_removal")):
            while True:
                run()
                st["passes"] += 1
                note(name, 0)
                if nb[key] > 2:
                    break
        while True:
            seen = self.tips()
            self.bulges()
            self.ecs()
            st["passes"] += 3
            note("tip_removal", seen)
            note("bubble_removal", 0)
            note("ec_removal", 0)
            if not (seen >= cutoff and nb["tips"] < 30):
                break
        return st

    def deleted(self) -> torch.Tensor:
        """The deleted nodes' k-mers, ascending."""
        return self.nodes[~self.live]

    # ---- Monument ------------------------------------------------------
    def contigs(self, min_len: int | None = None) -> list:
        return Monument(self, min_len).run()


class Monument:
    """The Monument walk over the live graph of a ``Minia``."""

    def __init__(self, m: Minia, min_len: int | None):
        c = m.compaction()
        self.k = m.k
        self.min_len = 2 * m.k + 1 if min_len is None else min_len
        self.lo = c.lo.cpu().numpy()
        self.deg = c.deg_o.cpu().numpy()
        self.counts = m.counts.cpu().numpy()
        self.nodes = m.nodes.cpu().numpy()
        self.live = m.live.cpu().numpy()
        n = self.live.size
        # each unitig's oriented nodes in order, and every node's place
        nu = c.node_u.cpu().numpy()
        pos = c.node_pos.cpu().numpy()
        strand = c.node_strand.cpu().numpy()
        have = np.nonzero(nu >= 0)[0]
        self.off = np.zeros(c.u_count + 1, np.int64)
        self.off[1:] = np.cumsum(np.bincount(nu[have], minlength=c.u_count))
        self.chain = np.empty(len(have), np.int64)
        self.chain[self.off[nu[have]] + pos[have]] = 2 * have + strand[have]
        self.nu, self.pos, self.strand = nu, pos, strand
        vals = torch.stack([m.nodes, K.revcomp(m.nodes, m.k)], 1) \
            .reshape(-1)
        self.last = (vals & 3).to(torch.uint8).cpu().numpy()
        self.marks = np.zeros(n, bool)

    def out(self, o: int) -> list:
        row = self.lo[o]
        return [(int(row[nt]), nt) for nt in range(4) if row[nt] >= 0]

    def indeg(self, o: int) -> int:
        return int(self.deg[o ^ 1])

    def run_ahead(self, o: int) -> np.ndarray:
        """The oriented nodes after ``o`` along its unitig, in travel
        order."""
        i = o >> 1
        u, p = self.nu[i], self.pos[i]
        a, b = self.off[u], self.off[u + 1]
        if (o & 1) == self.strand[i]:
            return self.chain[a + p + 1:b]
        return self.chain[a:a + p][::-1] ^ 1

    # ---- one step --------------------------------------------------
    def advance(self, o: int, prev):
        nb = self.out(o)
        if len(nb) == 1:
            x, nt = nb[0]
            if self.indeg(x) == 1 and not self.marks[x >> 1]:
                return [(nt, x)]
        if not nb:
            return []
        return self.bubble(o, prev)

    def bubble(self, o: int, prev):
        seen_all = set()
        end = self.frontier_end(o, prev, seen_all)
        if end is None:
            return []
        paths, ok = self.paths_between(o, end[0], end[1] + 1)
        if not ok:
            return []
        best = self.validate(paths, o)
        if best is None:
            return []
        steps, cur = [], o
        for ch in best:
            nt = LETTERS.index(ch)
            x = int(self.lo[cur][nt])
            if x < 0:
                return []
            steps.append((nt, x))
            cur = x
        for x in seen_all:
            self.marks[x >> 1] = True
        return steps

    def frontier_end(self, start: int, prev, seen_all):
        """Frontline.cpp: the frontier's breadth-first advance, depth by
        depth, until it narrows to one node; None where it stops."""
        frontier = [start]
        seen = {start >> 1}
        if prev is not None:
            seen.add(prev >> 1)
        depth = 0
        while True:
            new = []
            for o in frontier:
                if depth > 0 and not self.clean_entry(o, seen):
                    return None
                for x, _ in self.out(o):
                    if x >> 1 in seen:
                        continue
                    if self.marks[x >> 1]:
                        return None
                    new.append(x)
                    seen.add(x >> 1)
                    seen_all.add(x)
            frontier = new
            depth += 1
            if depth > MAX_DEPTH or len(frontier) > MAX_BREADTH \
                    or not frontier:
                return None
            if len(frontier) == 1:
                return frontier[0], depth

    def clean_entry(self, o: int, seen) -> bool:
        """No in-branching into ``o`` from outside the frontier whose walk
        from its entry reaches depth 4."""
        for x, _ in self.out(o ^ 1):
            if x >> 1 in seen:
                continue
            front = [x ^ 1]
            mine = {x >> 1}
            for depth in range(1, 5):
                new = []
                for y in front:
                    for z, _ in self.out(y):
                        if z >> 1 not in mine:
                            new.append(z)
                            mine.add(z >> 1)
                front = new
                if not front:
                    break
                if depth > 3:
                    return False
        return True

    def paths_between(self, start: int, end: int, depth: int):
        found = set()
        count = [0]

        def walk(cur, path, used):
            if count[0] > MAX_PATHS:
                return False
            if len(path) > depth:
                return True
            if cur == end:
                found.add(path)
                count[0] += 1
                return True
            ok = True
            for x, nt in self.out(cur):
                if x >> 1 in used:
                    continue
                ok &= walk(x, path + LETTERS[nt],
                           used | {x >> 1})
            return ok

        ok = walk(start, "", {start >> 1})
        return found, ok and bool(found)

    def validate(self, paths, start: int):
        sizes = [len(p) for p in paths]
        mean = sum(sizes) // len(sizes)
        spread = (sum((s - mean) ** 2 for s in sizes) / len(sizes)) ** 0.5
        if mean > MAX_DEPTH or (len(paths) == 1 and mean > self.k + 1) \
                or spread > mean / 5:
            return None
        ps = list(paths)
        for i in range(len(ps)):
            for j in range(i + 1, len(ps)):
                if identity(ps[i], ps[j]) * 100 < IDENTITY:
                    return None
        best, best_ab = None, -1.0
        for p in sorted(paths):
            ab = self.path_abundance(p, start)
            if ab > best_ab:
                best, best_ab = p, ab
        return best

    def path_abundance(self, p: str, start: int) -> float:
        cur, ab = start, []
        for ch in p:
            x = int(self.lo[cur][LETTERS.index(ch)])
            if x < 0:
                return -1.0
            ab.append(float(self.counts[x >> 1]))
            cur = x
        return float(np.mean(ab)) if ab else -1.0

    # ---- a walk and the contigs --------------------------------------
    def walk(self, start: int) -> bytearray:
        """The bases of the walk from oriented ``start``, as codes."""
        path = bytearray()
        cur, prev = start, None
        while len(path) < MAX_LEN:
            ahead = self.run_ahead(cur)
            if len(ahead):
                hit = self.marks[ahead >> 1]
                free = int(hit.argmax()) if hit.any() else len(ahead)
                take = min(free, MAX_LEN - len(path))
                if take:
                    seg = ahead[:take]
                    path += self.last[seg].tobytes()
                    self.marks[seg >> 1] = True
                    prev = int(seg[-2]) if take > 1 else cur
                    cur = int(seg[-1])
                    continue
            steps = self.advance(cur, prev)
            if not steps:
                break
            for nt, x in steps:
                path.append(nt)
                prev, cur = cur, x
                self.marks[x >> 1] = True
        return path

    def kmer(self, i: int) -> str:
        v = int(self.nodes[i])
        return "".join(chr(NTS[(v >> (2 * (self.k - 1 - j))) & 3])
                       for j in range(self.k))

    def run(self) -> list:
        live = self.live
        boundary = live & ((self.deg[0::2] != 1) | (self.deg[1::2] != 1))
        order = np.concatenate([np.nonzero(boundary)[0],
                                np.nonzero(live & ~boundary)[0]])
        out = []
        for i in order.tolist():
            if self.marks[i]:
                continue
            self.marks[i] = True
            right = self.walk(2 * i)
            left = self.walk(2 * i + 1)
            if len(left) + self.k + len(right) < self.min_len:
                continue
            out.append(bytes(left[::-1]).translate(_COMP_CHAR).decode()
                       + self.kmer(i) + bytes(right).translate(_CHAR)
                       .decode())
        return out


def identity(a: str, b: str) -> float:
    """Needleman-Wunsch identity (Traversal.cpp:188-241): match 10,
    mismatch and gap -5; the matches on the traceback (diagonal first,
    then up, then left) over the longer length."""
    na, nb = len(a), len(b)
    score = [[-5 * (i + j) if i == 0 or j == 0 else 0
              for j in range(nb + 1)] for i in range(na + 1)]
    for i in range(1, na + 1):
        for j in range(1, nb + 1):
            s = 10 if a[i - 1] == b[j - 1] else -5
            score[i][j] = max(score[i - 1][j - 1] + s, score[i - 1][j] - 5,
                              score[i][j - 1] - 5)
    i, j, same = na, nb, 0
    while i > 0 and j > 0:
        s = 10 if a[i - 1] == b[j - 1] else -5
        if score[i][j] == score[i - 1][j - 1] + s:
            same += a[i - 1] == b[j - 1]
            i, j = i - 1, j - 1
        elif score[i][j] == score[i - 1][j] - 5:
            i -= 1
        elif score[i][j] == score[i][j - 1] - 5:
            j -= 1
        else:
            break
    return same / max(na, nb) if max(na, nb) else 1.0


def canonical_contigs(seqs) -> Counter:
    """Each contig as the smaller of it and its reverse complement."""
    comp = str.maketrans("ACGT", "TGCA")
    return Counter(min(s, s.translate(comp)[::-1]) for s in seqs)


def contig_diff(a, b) -> int:
    """Size of the symmetric difference of two contig multisets."""
    ca, cb = canonical_contigs(a), canonical_contigs(b)
    return sum(((ca - cb) + (cb - ca)).values())

"""Unitig-centric de Bruijn graph (GraphUnitigs equivalent).

Port of gatb_core_tpu/debruijn/graph_unitigs.py. Reference:
debruijn/impl/GraphUnitigs.hpp/.cpp: unitigs in RAM with O(1) simple-path
ops, plus LinkTigs (impl/LinkTigs.cpp) computing inter-unitig links (GFA
``L`` records). Here links are derived directly from the k-mer-level
adjacency of unitig extremities: one candidate rank search over the
extremity k-mers (``unitigs._cand_ranks_flips``, the ``rank_rows``
kernel) replaces LinkTigs' 8-pass extremity hashing, and the link rule,
the sort and the CSR offsets run on the device. ``UnitigGraph`` itself
(queries, GFA / FASTA I/O) is host code, as in the JAX package.

Oriented unitig id: 2*u + s (s=0 forward as stored, s=1 reverse
complement). A link (a -> b) means: the last k-mer of oriented a extends
to the first k-mer of oriented b.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kmer.debloom import rows_to_device
from .unitigs import UnitigSet, _cand_ranks_flips, build_unitigs

I64 = torch.int64


@dataclass
class UnitigGraph:
    """CSR adjacency over oriented unitigs + per-unitig data."""

    k: int
    sequences: list
    mean_abundance: np.ndarray       # (U,)
    kmer_counts: np.ndarray          # (U,)
    # CSR over oriented unitig ids (2U): out-links of each oriented unitig
    link_offsets: np.ndarray         # (2U+1,)
    link_targets: np.ndarray         # (E,) oriented unitig ids

    @property
    def nb_unitigs(self) -> int:
        return len(self.sequences)

    def unitig_length(self, u) -> np.ndarray:
        return self.unitig_lengths()[np.atleast_1d(u)]

    def unitig_lengths(self) -> np.ndarray:
        """(U,) base lengths without decoding sequences."""
        if hasattr(self.sequences, "lengths"):
            return np.asarray(self.sequences.lengths())
        return np.asarray([len(s) for s in self.sequences])

    def out_links(self, oriented: int) -> np.ndarray:
        return self.link_targets[
            self.link_offsets[oriented]:self.link_offsets[oriented + 1]]

    def out_degree_oriented(self) -> np.ndarray:
        """(2U,) number of out-links of each oriented unitig."""
        return np.diff(self.link_offsets)

    def sequence_oriented(self, oriented: int) -> str:
        seq = self.sequences[oriented >> 1]
        if oriented & 1:
            comp = str.maketrans("ACGT", "TGCA")
            return seq.translate(comp)[::-1]
        return seq

    # ---- reference GraphUnitigs query API (GraphUnitigs.hpp:269-300) --
    def unitig_mean_abundance(self, u: int) -> float:
        return float(self.mean_abundance[u])

    def simple_path_avance(self, oriented: int):
        """One step along the unitig graph: the unique out-link if it is
        unambiguous on both sides (simplePathAvance), else None."""
        links = self.out_links(oriented)
        if len(links) != 1:
            return None
        t = int(links[0])
        back = self.out_links(t ^ 1)
        if len(back) != 1:
            return None
        return t

    def simple_path_longest(self, oriented: int) -> list[int]:
        """Longest unambiguous oriented-unitig chain from ``oriented``
        (simplePathLongest_avance): list of oriented unitig ids."""
        chain = [oriented]
        seen = {oriented >> 1}
        cur = oriented
        while True:
            nxt = self.simple_path_avance(cur)
            if nxt is None or (nxt >> 1) in seen:
                break
            chain.append(nxt)
            seen.add(nxt >> 1)
            cur = nxt
        return chain

    def path_sequence(self, chain: list[int]) -> str:
        """Spell the sequence of an oriented-unitig chain (k-1 overlaps)."""
        if not chain:
            return ""
        seq = self.sequence_oriented(chain[0])
        for t in chain[1:]:
            seq += self.sequence_oriented(t)[self.k - 1:]
        return seq

    # ---- GFA I/O (GraphUnitigs.cpp:669 loads GFA; writer added) -------
    def write_gfa(self, path: str) -> None:
        """GFA 1.0: S records with KC/km tags + L records with k-1 CIGAR
        overlaps."""
        with open(path, "w") as f:
            f.write("H\tVN:Z:1.0\n")
            for u, seq in enumerate(self.sequences):
                f.write(f"S\t{u}\t{seq}\tLN:i:{len(seq)}\t"
                        f"km:f:{self.mean_abundance[u]:.1f}\n")
            seen = set()
            for u in range(self.nb_unitigs):
                for s in (0, 1):
                    for t in self.out_links(2 * u + s):
                        key = (2 * u + s, int(t))
                        rkey = (int(t) ^ 1, (2 * u + s) ^ 1)
                        if rkey in seen:
                            continue
                        seen.add(key)
                        f.write(f"L\t{u}\t{'+' if s == 0 else '-'}\t"
                                f"{int(t) >> 1}\t"
                                f"{'+' if (int(t) & 1) == 0 else '-'}\t"
                                f"{self.k - 1}M\n")

    @classmethod
    def load_gfa(cls, path: str, k: int) -> "UnitigGraph":
        """Load a GFA 1.0 unitig graph (GraphUnitigs GFA load path)."""
        seqs: list[str] = []
        abund: list[float] = []
        links: list[tuple[int, int]] = []
        ids: dict[str, int] = {}
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if parts[0] == "S":
                    ids[parts[1]] = len(seqs)
                    seqs.append(parts[2])
                    km = 0.0
                    for tag in parts[3:]:
                        if tag.startswith("km:f:"):
                            km = float(tag[5:])
                    abund.append(km)
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if parts[0] == "L":
                    a = 2 * ids[parts[1]] + (0 if parts[2] == "+" else 1)
                    b = 2 * ids[parts[3]] + (0 if parts[4] == "+" else 1)
                    links.append((a, b))
                    links.append((b ^ 1, a ^ 1))
        u_count = len(seqs)
        links = sorted(set(links))
        src = np.asarray([a for a, _ in links], np.int64)
        dst = np.asarray([b for _, b in links], np.int64)
        offsets = np.zeros(2 * u_count + 1, np.int64)
        np.add.at(offsets, src + 1, 1)
        offsets = np.cumsum(offsets)
        counts = np.asarray([max(1, len(s) - k + 1) for s in seqs],
                            np.int32)
        return cls(k, seqs, np.asarray(abund, np.float32), counts,
                   offsets, dst)

    # GFA-ish dump (unitigs + L records), BCALM2-compatible headers
    def write_fasta(self, path: str) -> None:
        """Unitig FASTA with LN:i:, km:f: and L: link headers — the
        reference's final unitig file format (bglue_algo.cpp output +
        LinkTigs.cpp:55-120)."""
        with open(path, "w") as f:
            for u, seq in enumerate(self.sequences):
                links = []
                for s in (0, 1):
                    for t in self.out_links(2 * u + s):
                        links.append(
                            f"L:{'+' if s == 0 else '-'}:{t >> 1}:"
                            f"{'+' if (t & 1) == 0 else '-'}")
                header = (f">{u} LN:i:{len(seq)} "
                          f"km:f:{self.mean_abundance[u]:.1f}")
                if links:
                    header += " " + " ".join(links)
                f.write(header + "\n")
                f.write(seq + "\n")


def build_unitig_graph(solid_limbs, solid_counts: np.ndarray,
                       adjacency: np.ndarray, k: int,
                       device="cuda") -> UnitigGraph:
    """Unitigs + links from the solid k-mer set, on ``device``
    (``solid_limbs``: numpy rows or limb rows already there)."""
    table = rows_to_device(solid_limbs, device)
    us = build_unitigs(table, solid_counts, adjacency, k, device=device)
    return link_unitigs(table, us, k, device=device)


def link_unitigs(solid_limbs, us: UnitigSet, k: int, device="cuda",
                 precomputed=None) -> UnitigGraph:
    """Compute oriented unitig links from extremity-k-mer adjacency.
    ``precomputed``: (N, 8) candidate ranks and flips of ALL nodes as
    device tensors; the extremity rows are then gathered instead of
    re-swept."""
    u_count = us.nb_unitigs
    if u_count == 0:
        return UnitigGraph(k, [], np.zeros(0, np.float32),
                           np.zeros(0, np.int32), np.zeros(1, np.int64),
                           np.zeros(0, np.int64))
    table = rows_to_device(solid_limbs, device)
    n = table.shape[0]
    dev = table.device

    def up(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    node_unitig = up(us.node_unitig).to(I64)
    node_pos = up(us.node_pos).to(I64)
    node_strand = up(us.node_strand).to(I64)
    lengths = up(us.kmer_counts).to(I64)
    # oriented-unitig extremities: head k-mer of (u, 0) = node with pos 0;
    # tail = pos len-1; the tail's oriented k-mer (node, strand) extends
    # outward
    node_ids = torch.arange(n, device=dev)
    heads = torch.zeros((u_count,), dtype=I64, device=dev)
    tails = torch.zeros((u_count,), dtype=I64, device=dev)
    is_head = node_pos == 0
    heads[node_unitig[is_head]] = node_ids[is_head]
    is_tail = node_pos == lengths[node_unitig] - 1
    tails[node_unitig[is_tail]] = node_ids[is_tail]

    # for oriented unitig a = (u, s) its last k-mer is
    #   s=0: (tails[u], strand of tail)   s=1: (heads[u], flipped strand)
    last_nodes = torch.cat([tails, heads])           # (2U,) order: s=0|s=1
    last_strands = torch.cat([node_strand[tails], 1 - node_strand[heads]])
    ori_ids = torch.cat([2 * torch.arange(u_count, device=dev),
                         2 * torch.arange(u_count, device=dev) + 1])
    m = last_nodes.shape[0]
    if precomputed is None:
        ranks, flips = _cand_ranks_flips(table[last_nodes], table, n, k)
    else:
        ranks, flips = (x[last_nodes] for x in precomputed)

    # out-extensions of the oriented k-mer (node, s), over all 2U
    # extremities x 4 nucleotides (the reference does this with an 8-pass
    # hash join, LinkTigs.cpp:55-120): if the oriented k-mer is canonical
    # forward (s==0) its out-extensions are candidate slots 0-3, else slots
    # 4+(nt^2) entered in the flipped sense
    nts4 = torch.arange(4, device=dev)
    s_col = last_strands[:, None]
    slot = torch.where(s_col == 0, nts4[None, :], 4 + (nts4[None, :] ^ 2))
    j = torch.gather(ranks.to(I64), 1, slot)             # (m, 4) neighbor
    fl = torch.gather(flips.to(I64), 1, slot)
    enter = torch.where(s_col == 0, fl, 1 - fl)           # entering strand
    ok = j >= 0
    jj = j.clamp(min=0)
    v = node_unitig[jj]
    t = node_strand[jj]
    p = node_pos[jj]
    # same sense as stored: must enter at the head (pos 0) -> (v, fwd);
    # flipped sense: must enter at the tail -> (v, rev)
    c_fwd = ok & (enter == t) & (p == 0)
    c_rev = ok & (enter != t) & (p == lengths[v] - 1)
    ori_mat = ori_ids[:, None].expand(m, 4)
    src = torch.cat([ori_mat[c_fwd], ori_mat[c_rev]])
    dst = torch.cat([2 * v[c_fwd], 2 * v[c_rev] + 1])
    # sort by (src, dst): both below 2U, so one int64 key orders them
    order = torch.sort(src * (2 * u_count) + dst, stable=True).indices
    src, dst = src[order], dst[order]
    offsets = torch.zeros((2 * u_count + 1,), dtype=I64, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(src, minlength=2 * u_count),
                               0)
    return UnitigGraph(k, us.sequences, us.mean_abundance, us.kmer_counts,
                       offsets.cpu().numpy(), dst.cpu().numpy())

"""dbgcheck-equivalent CLI: whole-graph invariants and checksums.

Port of gatb_core_tpu/tools/dbgcheck.py. Mirrors reference
tools/dbgcheck.cpp:34-133 — loads (or builds) a graph and reports, over
ALL nodes: node-value checksum, successor count + successor checksum,
total abundance; over BRANCHING nodes: count, checksum, abundance.
Checksums are LargeInt sums mod 2^(64*words) printed high-word-first hex
('.'-separated), exactly like LargeInt::operator<< (LargeInt.hpp:630-648).

Device mapping: the reference's per-node Dispatcher loop over
graph.successors() becomes one sweep over the graph's device table in
``sweep_chunk`` chunks: the limb columns of the nodes, of their
out-neighbor candidates (ops/neighbor_ops.neighbor_candidates, masked by
the adjacency's out-bits) and of the branching nodes are summed on the
device in int64, and the host carries the per-chunk sums into Python
integers, so no value is ever summed node by node on the host.

Usage: python -m gatb_core_tpu_torch.tools.dbgcheck -in graph.h5
       python -m gatb_core_tpu_torch.tools.dbgcheck -in reads.fa -kmer-size 31
"""

from __future__ import annotations

import argparse
import sys
import time


def largeint_hex(total: int, words: int) -> str:
    """LargeInt::operator<< format: 64-bit hex words high->low, '.'
    separated, leading zero words skipped; empty string for zero."""
    total %= 1 << (64 * words)
    ws = [(total >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(words)]
    i = words - 1
    while i >= 0 and ws[i] == 0:
        i -= 1
    if i < 0:
        return ""
    return ".".join(f"{ws[j]:x}" for j in range(i, -1, -1))


def check_graph(graph) -> dict:
    """Gather dbgcheck's Stats over the whole graph, summed on the graph's
    device."""
    import torch

    from ..ops.bitpack import as_u32_i64
    from ..ops.neighbor_ops import neighbor_candidates
    from ..ops.sortops import sweep_chunk

    t0 = time.time()
    k, w, n = graph._k, graph._w, graph.nb_nodes
    words = max(1, (k + 31) // 32)
    dev = graph.device
    adj = torch.from_numpy(graph.precompute_adjacency()).to(dev)
    counts = torch.from_numpy(graph.solid_counts).to(dev)
    graph.branching_nodes()     # the branching stage, as in the JAX tool
    table = graph._padded_table()
    bit = torch.arange(8, device=dev)
    step = sweep_chunk(n)
    # per chunk: node, successor and branching limb columns (3 x W), then
    # abundance, branching abundance, successors and branching nodes
    parts = []
    for i in range(0, n, step):
        rows = as_u32_i64(table[i:i + step])
        bits = (adj[i:i + step].to(torch.int64)[:, None] >> bit) & 1
        outd = bits[:, :4].sum(dim=1)
        br = (outd != 1) | (bits[:, 4:].sum(dim=1) != 1)
        succ = bits[:, :4].bool()
        cands = neighbor_candidates(table[i:i + step], k)[:, :4]
        c = counts[i:i + step].to(torch.int64)
        parts.append(torch.cat([
            rows.sum(dim=0),
            cands.masked_fill(~succ[..., None], 0).sum(dim=(0, 1)),
            rows.masked_fill(~br[:, None], 0).sum(dim=0),
            torch.stack([c.sum(), c.masked_fill(~br, 0).sum(), outd.sum(),
                         br.sum()])]))
    # a chunk (at most 2^21 nodes) sums exactly in int64; the chunks' sums
    # are added on the host as Python integers
    sums = [sum(col) for col in zip(*torch.stack(parts).tolist())] \
        if parts else [0] * (3 * w + 4)

    def value(cols):
        return sum(int(s) << (32 * (w - 1 - j)) for j, s in enumerate(cols))

    abundance, abundance_br, nb_succ, nb_br = sums[3 * w:]
    return {
        "nbSolids": int(n),
        "nbSuccessors": int(nb_succ),
        "nbBranching": int(nb_br),
        "checkumNodes": largeint_hex(value(sums[:w]), words),
        "checksumSuccessors": largeint_hex(value(sums[w:2 * w]), words),
        "checksumBranching": largeint_hex(value(sums[2 * w:3 * w]), words),
        "abundance": int(abundance),
        "abundanceBranching": int(abundance_br),
        "time": time.time() - t0,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dbgcheck")
    p.add_argument("-in", dest="input", required=True,
                   help="graph .h5 or reads file")
    p.add_argument("-kmer-size", dest="kmer_size", type=int, default=31)
    p.add_argument("-abundance-min", dest="abundance_min", default="2")
    args = p.parse_args(argv)

    from ..debruijn.graph import Graph

    if args.input.endswith(".h5"):
        graph = Graph.load(args.input)
    else:
        amin = args.abundance_min if args.abundance_min == "auto" \
            else int(args.abundance_min)
        graph = Graph.create(args.input, kmer_size=args.kmer_size,
                             abundance_min=amin, build_branching=False)

    stats = check_graph(graph)
    print()
    for key in ("nbSolids", "nbSuccessors", "nbBranching", "checkumNodes",
                "checksumSuccessors", "checksumBranching", "abundance",
                "abundanceBranching", "time"):
        val = stats[key]
        if key == "time":
            val = f"{val:.3f}"
        print(f"{key:<18} = {val}  ")
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())

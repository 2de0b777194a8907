"""dbgtopology-equivalent CLI: in/out-degree topology matrix of a graph
(reference tools/dbgtopology.cpp, non-default build tool; the same
matrix the reference's BranchingAlgorithm can compute as the optional
topology histogram).

Port of gatb_core_tpu/tools/dbgtopology.py: the adjacency sweep runs on
the graph's device (Graph.precompute_adjacency), the histogram of its
masks on the host.

Usage: python -m gatb_core_tpu_torch.tools.dbgtopology -in graph.h5
       python -m gatb_core_tpu_torch.tools.dbgtopology -in reads.fa -kmer-size 31
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def topology_matrix(graph) -> np.ndarray:
    """(5, 5) matrix: [indegree][outdegree] node counts."""
    from ..debruijn.graph import _popcount4

    adj = graph.precompute_adjacency()
    outd = _popcount4(adj & 0x0F).astype(np.int64)
    ind = _popcount4(adj >> 4).astype(np.int64)
    return np.bincount(5 * ind + outd, minlength=25).reshape(5, 5)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dbgtopology")
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

    mat = topology_matrix(graph)
    print(f"nodes: {graph.nb_nodes}")
    print("in\\out " + " ".join(f"{j:>8}" for j in range(5)))
    for i in range(5):
        print(f"{i:>6} " + " ".join(f"{mat[i, j]:>8}" for j in range(5)))
    nb_branching = int(mat.sum() - mat[1, 1])
    print(f"branching (in!=1 or out!=1): {nb_branching}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

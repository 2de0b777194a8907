"""Contig assembly with the Monument traversal
(ref: examples/debruijn/traversal1.cpp)."""
from gatb_core_tpu_torch import Graph, assemble_contigs

from _common import device

dev = device()

graph = Graph.create("/root/reference/gatb-core/test/db/reads1.fa",
                     kmer_size=31, abundance_min=3, build_branching=False,
                     device=dev)
contigs = assemble_contigs(graph, traversal="monument")
print(len(contigs), "contigs; total",
      sum(len(c) for c in contigs), "nt; N50-ish longest:",
      max(len(c) for c in contigs))

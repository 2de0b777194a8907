"""Unitigs + links + simplification (ref: examples/debruijn/debruijn24.cpp)."""
import os
import tempfile
from gatb_core_tpu_torch import Graph

from _common import device

dev = device()

graph = Graph.create("/root/reference/gatb-core/test/db/reads1.fa",
                     kmer_size=31, abundance_min=3, build_branching=False,
                     device=dev)
ug = graph.unitig_graph()
print("unitigs:", ug.nb_unitigs,
      "longest:", max(len(s) for s in ug.sequences))
ug.write_fasta(os.path.join(tempfile.gettempdir(), "unitigs_example.fa"))
stats = graph.simplify()
print("simplify:", stats)

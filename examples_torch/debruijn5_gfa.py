"""Unitig graph to GFA and back (ref: GraphUnitigs GFA load,
debruijn/impl/GraphUnitigs.cpp:669)."""
import os
import tempfile
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.debruijn.graph import Graph
from gatb_core_tpu_torch.debruijn.graph_unitigs import UnitigGraph

from _common import device

dev = device()

rng = np.random.default_rng(2)
genome = "".join(rng.choice(list("ACGT"), size=800))
g = Graph.create(BankStrings(genome, genome[200:], genome[:500]),
                 kmer_size=15, abundance_min=1, build_branching=False,
                 device=dev)
ug = g.unitig_graph()
gfa = os.path.join(tempfile.gettempdir(), "example_unitigs.gfa")
ug.write_gfa(gfa)
back = UnitigGraph.load_gfa(gfa, 15)
print(f"{ug.nb_unitigs} unitigs round-tripped:",
      sorted(list(ug.sequences)) == sorted(list(back.sequences)))

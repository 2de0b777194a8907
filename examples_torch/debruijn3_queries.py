"""Graph node queries: membership, index, abundance, degree, state
(ref: examples/debruijn/debruijn4-10.cpp node API family)."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.debruijn.graph import Graph

from _common import device

dev = device()

rng = np.random.default_rng(4)
genome = "".join(rng.choice(list("ACGT"), size=600))
g = Graph.create(BankStrings(genome, genome), kmer_size=15,
                 abundance_min=1, build_branching=True, device=dev)
node = g.build_node(genome[:15])
print("contains:", bool(g.contains(node)[0]))
print("index:", int(g.node_index(node)[0]))
print("abundance:", int(g.query_abundance(node)[0]))
print("out/in degree:", int(g.out_degree(node)[0]), int(g.in_degree(node)[0]))
g.set_node_state(node, 1)
print("state:", int(g.query_node_state(node)[0]))
print("branching nodes:", len(g.branching_nodes()),
      "checksum:", g.checksum_branching())

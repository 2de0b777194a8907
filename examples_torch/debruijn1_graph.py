"""Graph build + node/neighbor queries
(ref: examples/debruijn/debruijn1.cpp)."""
from gatb_core_tpu_torch import Graph

from _common import device

dev = device()

graph = Graph.create("/root/reference/gatb-core/test/db/reads1.fa",
                     kmer_size=31, abundance_min=3, device=dev)
print("nodes:", graph.nb_nodes, "branching:", len(graph.branching_nodes()),
      "checksum:", graph.checksum_branching())
node = graph.solid_limbs[0]
print("node:", graph.node_to_string(node),
      "out:", int(graph.out_degree(node)[0]),
      "in:", int(graph.in_degree(node)[0]),
      "abundance:", int(graph.query_abundance(node)[0]))

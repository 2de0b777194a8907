"""MicroSNP proto (ref: examples/protos/MicroSNP.cpp): find the SNP
bubble in the bundled micro dataset via branching nodes + neighbors."""
from gatb_core_tpu_torch.debruijn.graph import Graph

from _common import device

dev = device()

g = Graph.create("/root/reference/gatb-core/test/db/microsnp.fa",
                 kmer_size=7, abundance_min=1, device=dev)
bn = g.branching_nodes()
print(f"{g.nb_nodes} nodes, {len(bn)} branching")
for node in bn:
    nb = g.neighbors(node)
    if len(nb["out"]) == 2:
        print("SNP fork at a node with 2 out-neighbors: found")
        break

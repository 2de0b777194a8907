"""Node states + membership queries (ref: examples/debruijn/
debruijn9-12.cpp — contains/neighbors + MPHF node state)."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.debruijn.graph import Graph

from _common import device

dev = device()

rng = np.random.default_rng(3)
genome = "".join(rng.choice(list("ACGT"), size=300))
reads = [genome[i:i + 60] for i in range(0, 240, 12)]
g = Graph.create(BankStrings(*reads), kmer_size=21, abundance_min=1,
                 device=dev)
node = g.build_node(genome[50:71])
print("contains:", bool(g.contains(node)[0]))
print("neighbors:", {k: len(v) for k, v in g.neighbors(node).items()})
g.set_node_state(node, 2)            # MPHF payload state (value bits)
print("queried state:", int(g.query_node_state(node)[0]))
g.delete_node(node)                  # deletion bit (bit 0)
print("deleted:", bool(g.node_state[g.node_index(node)[0]] & 1))

"""Branching nodes + reference checksum (ref: examples/debruijn/
debruijn5-7.cpp, BranchingAlgorithm)."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.debruijn.graph import Graph

from _common import device

dev = device()

rng = np.random.default_rng(5)
genome = "".join(rng.choice(list("ACGT"), size=600))
reads = [genome[i:i + 80] for i in range(0, 520, 20)]
reads.append(genome[100:140] + "T" + genome[141:180])  # a branch
g = Graph.create(BankStrings(*reads), kmer_size=21, abundance_min=1,
                 device=dev)
bn = g.branching_nodes()
print(f"{len(bn)} branching nodes, checksum {g.checksum_branching()!r}")

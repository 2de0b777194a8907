"""IterativeExtensions: seed-and-extend toward a target
(ref: debruijn/impl/IterativeExtensions.cpp, used by Minia's gap
filling)."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.debruijn.graph import Graph
from gatb_core_tpu_torch.debruijn.iterative_extensions import \
    IterativeExtensions

from _common import device

dev = device()

rng = np.random.default_rng(11)
genome = "".join(rng.choice(list("ACGT"), size=400))
reads = [genome[i:i + 60] for i in range(0, 340, 10)]
g = Graph.create(BankStrings(*reads), kmer_size=21, abundance_min=1,
                 device=dev)
ie = IterativeExtensions(g)
res = ie.extend(genome[:30], target=genome[200:221])
print(f"extended to {len(res.sequence)} nt, reached target:",
      res.reached_target)

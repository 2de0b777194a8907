"""Graph simplification: tips/bulges/EC removal then clean contigs
(ref: examples/debruijn/debruijn22.cpp + Minia's simplify-then-assemble)."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.debruijn.graph import Graph

from _common import device

dev = device()

rng = np.random.default_rng(9)
genome = "".join(rng.choice(list("ACGT"), size=1500))
reads = [genome[s:s+120] for s in rng.integers(0, 1380, size=220)]
for _ in range(6):  # sequencing-error tips/bulges
    s = int(rng.integers(0, 1380)); r = list(genome[s:s+120])
    r[60] = "ACGT"[int(rng.integers(4))]
    reads.append("".join(r))
g = Graph.create(BankStrings(*reads), kmer_size=17, abundance_min=2,
                 build_branching=False, device=dev)
before = g.nb_nodes
stats = g.simplify()
live = int((~(g.node_state & 1).astype(bool)).sum())
print(f"nodes {before} -> {live}; {stats}")
seqs, ab = g.contigs()
print(f"{len(seqs)} contigs after cleanup")

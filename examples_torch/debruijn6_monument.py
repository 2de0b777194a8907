"""Bubble-tolerant Monument assembly on the unitig-jumping engine
(ref: examples/debruijn/traversal2.cpp MonumentTraversal)."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.debruijn.graph import Graph

from _common import device

dev = device()

rng = np.random.default_rng(13)
genome = "".join(rng.choice(list("ACGT"), size=1200))
reads = [genome[s:s+110] for s in rng.integers(0, 1090, size=200)]
for _ in range(5):  # SNPs -> bubbles the traversal should pop
    s = int(rng.integers(0, 1090)); r = list(genome[s:s+110])
    r[55] = "ACGT"[int(rng.integers(4))]
    reads.append("".join(r))
g = Graph.create(BankStrings(*reads), kmer_size=15, abundance_min=1,
                 build_branching=False, device=dev)
seqs, _ = g.contigs(traversal="monument", min_contig_len=0)
print(f"{len(seqs)} monument contigs, longest {max(map(len, seqs))} nt")

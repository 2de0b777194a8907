"""Minimizer repartition table (ref: kmer/impl/RepartitorAlgorithm.cpp:
the /minimizers artifact routing kmers to partitions)."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.kmer.repartition import build_repartitor

from _common import device

rng = np.random.default_rng(8)
genome = "".join(rng.choice(list("ACGT"), size=3000))
reads = [genome[s:s+100] for s in rng.integers(0, 2900, size=200)]
rep = build_repartitor(BankStrings(*reads), kmer_size=21, nb_partitions=8,
                       device=device())
table = rep.table                 # a host array: the census comes back
print(f"{len(table)} minimizers -> 8 partitions;",
      "load:", np.bincount(table, minlength=8).tolist())

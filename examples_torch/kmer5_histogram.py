"""Abundance histogram + automatic cutoff (ref: kmer/impl/
HistogramAlgorithm + the cutoff smoothing in Histogram.cpp)."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.kmer.counting import count_kmers

from _common import device

rng = np.random.default_rng(5)
genome = "".join(rng.choice(list("ACGT"), size=2000))
reads = [genome[s:s+100] for s in rng.integers(0, 1900, size=600)]
for _ in range(40):  # error kmers -> low-abundance noise peak
    s = int(rng.integers(0, 1900)); r = list(genome[s:s+100])
    r[50] = "ACGT"[int(rng.integers(4))]
    reads.append("".join(r))
res = count_kmers(BankStrings(*reads), kmer_size=21, abundance_min="auto",
                  device=device())
h = res.histogram
print("auto cutoff:", h.cutoff, "| solid:", res.info["kmers_nb_solid"],
      "| first bins:", h.bins[1:6].tolist())

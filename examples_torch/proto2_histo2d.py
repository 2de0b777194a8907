"""2D abundance histogram over two banks (ref: examples/protos/
histo2D.cpp + Histogram2D)."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.kmer.counting import count_kmers_multibank
from gatb_core_tpu_torch.kmer.histogram import Histogram2D

from _common import device

rng = np.random.default_rng(12)
genome = "".join(rng.choice(list("ACGT"), size=800))
b0 = BankStrings(*[genome[i:i + 80] for i in range(0, 700, 20)])
b1 = BankStrings(*[genome[i:i + 80] for i in range(0, 700, 40)])
res = count_kmers_multibank([b0, b1], kmer_size=21, abundance_min=1,
                            device=device())
h = Histogram2D(max_value=20)
h.add_counts(res.counts_per_bank)
nz = np.argwhere(h.bins)
print(f"2D histogram: {len(nz)} occupied cells, "
      f"total {int(h.bins.sum())} distinct kmers")

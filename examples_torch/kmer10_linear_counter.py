"""LinearCounter cardinality estimation (ref: examples/kmer/kmer9.cpp,
kmer/impl/LinearCounter.cpp)."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.kmer.linear_counter import estimate_distinct_kmers

from _common import device

rng = np.random.default_rng(7)
genome = "".join(rng.choice(list("ACGT"), size=2000))
bank = BankStrings(*[genome[i:i + 100] for i in range(0, 1900, 50)])
est = estimate_distinct_kmers(bank, kmer_size=21, device=device())
print("estimated distinct 21-mers:", est)

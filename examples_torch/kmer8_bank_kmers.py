"""BankKmers: enumerate all 4^k kmers as a bank
(ref: examples/kmer/kmer8.cpp / BankKmers.hpp)."""
from gatb_core_tpu_torch.kmer.bank_kmers import BankKmers

from _common import device

device()  # host only: the flag is taken and unused

bank = BankKmers(4)
seqs = list(bank)
print("4^4 =", len(seqs), "first:", seqs[0].data, "last:", seqs[-1].data)

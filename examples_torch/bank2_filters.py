"""Bank adaptors: filtering, reference splitting, random banks
(ref: examples/bank/bank5-16.cpp family)."""
import sys
from gatb_core_tpu_torch import open_bank
from gatb_core_tpu_torch.bank.fasta import BankSplitter, BankRandom

from _common import device

device()  # host only: the flag is taken and unused

uri = sys.argv[1] if len(sys.argv) > 1 else \
    "/root/reference/gatb-core/test/db/reads1.fa"
bank = open_bank(uri)
# filter: sequences longer than 80 nt
longs = [s for s in bank if len(s) >= 80]
print(f"{len(longs)} sequences >= 80 nt")
# splitter: overlapping synthetic reads of a reference sequence
# (BankSplitter.hpp)
sub = BankSplitter(longs[0].data, read_size=40, overlap=20, coverage=2)
print("split reads:", sum(1 for _ in sub))
# random bank (BankRandom.hpp)
rnd = BankRandom(nb_sequences=5, length=40, seed=3)
print("random bank:", [len(s) for s in rnd])

"""Iterator adaptors over banks: truncate/filter/composite + observer
(ref: examples/bank/bank5-8.cpp — IteratorHelpers + ProgressIterator)."""
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.misc.iterators import (SubjectIterator, composite,
                                          filter_it, truncate)

from _common import device

device()  # host only: the flag is taken and unused

bank = BankStrings("ACGTACGT", "TTTTCCCC", "GGGGAAAA", "ACACACAC")
print("first 2:", [s.data for s in truncate(bank, 2)])
print("with GGGG:", [s.data for s in
                     filter_it(bank, lambda s: "GGGG" in s.data)])
both = composite(bank, BankStrings("TTAA"))
seen = []
sub = SubjectIterator(both, period=2)
sub.add_listener(lambda n: seen.append(n))
print("composite count:", sum(1 for _ in sub), "notifications:", seen)

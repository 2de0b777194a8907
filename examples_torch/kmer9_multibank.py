"""Multibank count matrices + solidity kinds (ref: the _multibank
PartitionsCommand variants + CountProcessorSolidity kinds)."""
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.kmer.counting import count_kmers_multibank

from _common import device

dev = device()
b1 = BankStrings("ACGTACGTACGTACG", "ACGTACGTACGTACG")
b2 = BankStrings("TTTACGTACGTACGT")
for kind in ("sum", "min", "max", "all", "one"):
    res = count_kmers_multibank([b1, b2], kmer_size=11, abundance_min=2,
                                solidity_kind=kind, device=dev)
    print(f"{kind}: {int(res.solid_mask.sum())} solid of {len(res.kmers)}")

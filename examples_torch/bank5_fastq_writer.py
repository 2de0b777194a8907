"""FASTQ iteration + FASTA writer (ref: examples/bank/bank13-16.cpp)."""
import os
import tempfile
from gatb_core_tpu_torch.bank.fasta import (BankFasta, BankFastaWriter,
                                            open_bank)

from _common import device

device()  # host only: the flag is taken and unused

fd, fq = tempfile.mkstemp(suffix=".fastq")
with os.fdopen(fd, "w") as f:
    for i, seq in enumerate(["ACGTACGTACGT", "GGCATTTACGTA"]):
        f.write(f"@read{i} comment\n{seq}\n+\n{'F' * len(seq)}\n")
bank = open_bank(fq)
seqs = list(bank)
print("fastq sequences:", [s.data for s in seqs])
fd2, fa = tempfile.mkstemp(suffix=".fa")
os.close(fd2)
with BankFastaWriter(fa) as w:
    for s in seqs:
        w.insert(s)
print("rewritten:", [s.data for s in BankFasta(fa)] ==
      [s.data for s in seqs])
os.unlink(fq); os.unlink(fa)

"""bankgen-equivalent CLI: synthetic random genome + overlapping reads.

Mirrors reference tools/bankgen.cpp:50-99: a BankRandom genome of -seq-len
bases and a BankSplitter reads bank (-read-len, -overlap-len, -coverage),
both written as FASTA with `<idx>__len__<size>` headers (SaveAsFasta,
bankgen.cpp:25-47).

Usage: python -m gatb_core_tpu_torch.tools.bankgen -out PREFIX [-seq-len N]
           [-read-len N] [-overlap-len N] [-coverage N]
"""

from __future__ import annotations

import argparse
import sys


def save_as_fasta(bank, uri: str) -> None:
    from ..bank.fasta import BankFastaWriter, Sequence

    with BankFastaWriter(uri) as out:
        for count, seq in enumerate(bank):
            out.insert(Sequence(f"{count}__len__{len(seq)}", seq.data,
                                None, count))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bankgen")
    p.add_argument("-out", dest="out", required=True, help="output prefix")
    p.add_argument("-seq-len", dest="seq_len", type=int, default=1000000)
    p.add_argument("-read-len", dest="read_len", type=int, default=150)
    p.add_argument("-overlap-len", dest="overlap_len", type=int, default=50)
    p.add_argument("-coverage", dest="coverage", type=int, default=3)
    args = p.parse_args(argv)

    from ..bank.fasta import BankRandom, BankSplitter

    random_bank = BankRandom(1, args.seq_len)
    genome = [s.data for s in random_bank][0]
    reads_bank = BankSplitter(genome, args.read_len, args.overlap_len,
                              args.coverage)

    save_as_fasta(random_bank, args.out + "_sequence.fa")
    save_as_fasta(reads_bank, args.out + "_reads.fa")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Custom CountProcessor: common kmers between input banks.

Port of the reference snippet examples/kmer/kmer12.cpp — inherit from
the CountProcessor base, refine process_table, implement clone /
finish_clones, and plug the processor into the counting run. For N
banks it fills the N(N+1)/2 'diagonal' pair-count vector: entry (i, j)
counts kmers abundant (>= threshold) in BOTH banks i and j; the main
diagonal is each bank's own abundant-kmer count.

Run: python examples_torch/kmer3_count_processor.py [fasta1 fasta2 ...]
     [--device cpu]
"""

import sys

import numpy as np

from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.kmer.count_processor import CountProcessor
from gatb_core_tpu_torch.kmer.counting import count_kmers_multibank

from _common import device


class CommonKmersProcessor(CountProcessor):
    """kmer12.cpp CountProcessorCustom, table-vectorized: the per-kmer
    pair loop becomes one boolean matrix product per table."""

    def __init__(self, nb_banks: int, threshold: int = 1):
        self.nb_banks = nb_banks
        self.threshold = threshold
        # N(N+1)/2 'diagonal' pair counters (kmer12.cpp offset() layout)
        self.count_total = np.zeros(nb_banks * (nb_banks + 1) // 2,
                                    np.int64)

    def offset(self, i: int, j: int) -> int:
        # kmer12.cpp: diagonal d = j - i, entry d*N - d(d-1)/2 + i
        d = j - i
        return d * self.nb_banks - d * (d - 1) // 2 + i

    def clone(self):
        return CommonKmersProcessor(self.nb_banks, self.threshold)

    def finish_clones(self, clones):
        for c in clones:
            if isinstance(c, CommonKmersProcessor) and c is not self:
                self.count_total += c.count_total

    def process_table(self, part_id, kmers, counts, sums):
        present = np.asarray(counts) >= self.threshold   # (N, B)
        # pair co-occurrence counts in one matmul (the counts come to
        # the processor as host arrays: B x B co-occurrence =
        # present^T @ present)
        co = present.T.astype(np.int64) @ present.astype(np.int64)
        for i in range(self.nb_banks):
            for j in range(i, self.nb_banks):
                self.count_total[self.offset(i, j)] += co[i, j]
        return None  # pass-through: do not filter downstream stages

    def get_count(self, i: int, j: int) -> int:
        if i > j:
            i, j = j, i
        return int(self.count_total[self.offset(i, j)])

    def get_properties(self):
        return {f"common_{i}_{j}": self.get_count(i, j)
                for i in range(self.nb_banks)
                for j in range(i, self.nb_banks)}


def main():
    dev = device()
    if len(sys.argv) > 1:
        banks = sys.argv[1:]
        nb = len(banks)
    else:
        banks = [BankStrings("ACGTACGTACGTAAA", "TTTACCCGGGAAAC"),
                 BankStrings("ACGTACGTACGTAAA"),
                 BankStrings("TTTACCCGGGAAAC", "GGGCCCAAATTTGG")]
        nb = 3
    proc = CommonKmersProcessor(nb_banks=nb, threshold=1)
    count_kmers_multibank(banks, kmer_size=11, abundance_min=1,
                          processor=proc, device=dev)
    for i in range(nb):
        for j in range(i, nb):
            print(f"banks ({i},{j}): {proc.get_count(i, j)} common kmers")


if __name__ == "__main__":
    main()

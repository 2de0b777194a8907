"""BankKmers + bank kmer iteration (legacy kmer-layer helpers).

Reference: kmer/impl/BankKmers.hpp (a bank whose sequences are ALL 4^k
k-mers, used by tests/benchmarks to sweep the full kmer space) and
kmer/impl/BankKmerIterator.hpp (iterate the kmers of every sequence of a
bank through a model).
"""

from __future__ import annotations

from typing import Iterator

from ..bank.fasta import IBank, Sequence, open_bank
from .model import ModelCanonical, ModelMinimizer, kmer_to_string

NT = "ACTG"  # GATB encoding order A=0 C=1 T=2 G=3 (IModel.hpp:73-84)


class BankKmers(IBank):
    """Bank enumerating all 4^k kmers as sequences (BankKmers.hpp:46-90).

    Only sensible for small k (the reference uses it the same way).
    """

    def __init__(self, kmer_size: int):
        if kmer_size > 14:
            raise ValueError("BankKmers: 4^k sequences — keep k <= 14")
        self.kmer_size = kmer_size
        self.total = 1 << (2 * kmer_size)

    @property
    def id(self) -> str:
        return f"Kmers{self.kmer_size}"

    def __iter__(self) -> Iterator[Sequence]:
        for value in range(self.total):
            s = kmer_to_string(value, self.kmer_size)
            yield Sequence(comment=f"kmer_{value}", data=s, index=value)

    def estimate(self, threshold: int = 5000):
        return self.total, self.total * self.kmer_size, self.kmer_size

    def get_size(self) -> int:
        return self.total * self.kmer_size


def iter_bank_kmers(bank, kmer_size: int, minimizer_size: int | None = None):
    """Yield (sequence_index, kmer_infos) per sequence of a bank — the
    BankKmerIterator equivalent. kmer_infos is the model's per-window
    iteration (value/canonical/validity, plus minimizer when
    ``minimizer_size`` is given)."""
    bank = open_bank(bank)
    model = (ModelMinimizer(kmer_size, minimizer_size)
             if minimizer_size else ModelCanonical(kmer_size))
    for i, seq in enumerate(bank):
        yield i, list(model.iter_kmers(seq.data))

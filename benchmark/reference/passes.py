"""The DSK pass split of a count, in plain torch (k <= 31).

A count in P passes (Rizk, Lavenier and Chikhi 2013, DSK; GATB-core's
``SortingCountAlgorithm``, whose pass filter keeps in pass p the k-mers
whose minimizer modulo P is p) holds in each pass a part of the distinct
table. The minimizer is GATB's lexicographic one (``Model.hpp``): of the
k - m + 1 m-mers of a k-mer, each taken in its canonical form, the
smallest, where an m-mer holding two adjacent A bases anywhere but at its
first two bases is banned and counts as 4^m - 1. The reverse complement of
a k-mer has the reverse complements of its m-mers, so the minimizer is
the same for both strands and is taken here from the canonical k-mer.

Values are as ``reference.kmers`` has them: 2 bits a base, first base
highest, A=0, C=1, T=2, G=3.
"""

from __future__ import annotations

import torch

from benchmark.reference.kmers import CHUNK, check_k, revcomp

M = 10                        # GATB-core's default minimizer size


def banned(mm: torch.Tensor, m: int) -> torch.Tensor:
    """m-mers with two adjacent A bases at positions (p, p + 1), p >= 1."""
    a = [((mm >> (2 * (m - 1 - p))) & 3) == 0 for p in range(m)]
    out = torch.zeros_like(mm, dtype=torch.bool)
    for p in range(1, m - 1):
        out |= a[p] & a[p + 1]
    return out


def minimizers(values: torch.Tensor, k: int, m: int = M) -> torch.Tensor:
    """The lexicographic minimizer of each canonical k-mer value."""
    check_k(k)
    mask = (1 << (2 * m)) - 1
    out = torch.empty_like(values)
    for s in range(0, values.numel(), CHUNK):
        v = values[s:s + CHUNK]
        best = torch.full_like(v, mask)
        for j in range(k - m + 1):
            mm = (v >> (2 * (k - m - j))) & mask
            mm = torch.minimum(mm, revcomp(mm, m))
            best = torch.minimum(best, torch.where(banned(mm, m),
                                                   torch.full_like(mm, mask),
                                                   mm))
        out[s:s + CHUNK] = best
    return out


def pass_of(values: torch.Tensor, k: int, nb_passes: int,
            m: int = M) -> torch.Tensor:
    """The pass that holds each canonical k-mer value."""
    return minimizers(values, k, m) % nb_passes


def split(distinct: torch.Tensor, counts: torch.Tensor, k: int,
          nb_passes: int, abundance_min: int, m: int = M) -> tuple:
    """(distinct k-mers per pass, solid k-mers per pass), as lists, of a
    count's distinct values and their counts."""
    p = pass_of(distinct, k, nb_passes, m)
    solid = counts >= abundance_min
    return (torch.bincount(p, minlength=nb_passes).tolist(),
            torch.bincount(p[solid], minlength=nb_passes).tolist())

"""Abundance histogram + 'auto' cutoff detection.

Ports gatb-core's Histogram (tools/misc/impl/Histogram.cpp) including the
bit-exact compute_threshold valley detection used by ``abundance-min=auto``
(Histogram.cpp:61-160, integer-truncating 0.2/0.6/0.2 smoothing).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Histogram:
    """Histogram of distinct-kmer abundances, bounded at ``max_value``
    (STR_HISTOGRAM_MAX default 10000). Bin i counts distinct kmers whose
    total abundance is i (i == max_value catches everything >=)."""

    max_value: int = 10000
    bins: np.ndarray = field(default=None)  # type: ignore[assignment]
    cutoff: int = 0
    first_peak: int = 0
    nb_solids_after_cutoff: int = 0

    def __post_init__(self):
        if self.bins is None:
            self.bins = np.zeros(self.max_value + 1, dtype=np.uint64)

    def add_counts(self, abundances: np.ndarray) -> None:
        """Accumulate one abundance per distinct kmer."""
        # np.minimum beats np.clip ~3x on large int arrays (counts are
        # already >= 0 from the reduce)
        clipped = np.minimum(abundances, self.max_value).astype(np.int64)
        np.maximum(clipped, 0, out=clipped)
        self.bins += np.bincount(clipped, minlength=self.max_value + 1) \
            .astype(np.uint64)

    def merge(self, other: "Histogram") -> None:
        self.bins += other.bins

    def compute_threshold(self, min_auto_threshold: int = 3) -> int:
        """Bit-exact port of Histogram::compute_threshold (Histogram.cpp:61-160).

        Smooths the histogram, finds the first increase (end of the error
        tail), the max after it (coverage peak), takes the valley min between
        them, bounds it by the 25%-mass cutoff, floors at min_auto_threshold.
        """
        h = self.bins.astype(np.uint64)
        length = self.max_value  # _length in reference
        smoothed = np.zeros(length + 1, dtype=np.uint64)
        sum_allk = 0

        if length >= 2:
            smoothed[1] = np.uint64(0.6 * float(h[1]) + 0.4 * float(h[2]))
            sum_allk += int(h[1]) * 1

        index_first_increase = -1
        index_maxval = -1
        max_val = 0
        for i in range(2, length):
            sum_allk += int(h[i]) * i
            smoothed[i] = np.uint64(0.2 * float(h[i - 1]) + 0.6 * float(h[i])
                                    + 0.2 * float(h[i + 1]))
            if index_first_increase == -1 and smoothed[i - 1] < smoothed[i]:
                index_first_increase = i - 1
            if index_first_increase > 0 and smoothed[i] > max_val:
                max_val = int(smoothed[i])
                index_maxval = i
        sum_allk += int(h[length]) * length

        if index_first_increase == -1:
            self.cutoff = min_auto_threshold
            return self.cutoff

        self.first_peak = index_maxval

        min_val = 10000000000
        index_minval = -1
        for i in range(index_first_increase, index_maxval + 1):
            if smoothed[i] < min_val:
                min_val = int(smoothed[i])
                index_minval = i
        cutoff = index_minval if index_minval != -1 else min_auto_threshold

        sum_elim = 0
        max_cutoff = 0
        for i in range(length + 1):
            sum_elim += int(h[i]) * i
            ratio = sum_elim / sum_allk if sum_allk else 0.0
            if ratio >= 0.25:
                max_cutoff = i + 1
                break

        if cutoff > max_cutoff:
            cutoff = max_cutoff
        if cutoff < min_auto_threshold:
            cutoff = min_auto_threshold
        self.cutoff = cutoff
        return cutoff

    def to_pairs(self) -> np.ndarray:
        """(index, abundance) rows like the reference 'histogram' dataset."""
        idx = np.arange(self.max_value + 1, dtype=np.uint64)
        return np.stack([idx, self.bins], axis=1)


@dataclass
class Histogram2D:
    """2D abundance histogram for two-bank inputs (IHistogram/Histogram2D,
    tools/misc/impl/Histogram.hpp: bin [a0][a1] counts distinct kmers with
    abundance a0 in bank 0 and a1 in bank 1, both clamped at max_value)."""

    max_value: int = 1000
    bins: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.bins is None:
            self.bins = np.zeros(
                (self.max_value + 1, self.max_value + 1), np.uint64)

    def add_counts(self, counts_per_bank: np.ndarray) -> None:
        """counts_per_bank: (N, 2) per-distinct-kmer abundances."""
        c = np.clip(counts_per_bank.astype(np.int64), 0, self.max_value)
        flat = c[:, 0] * (self.max_value + 1) + c[:, 1]
        self.bins += np.bincount(
            flat, minlength=(self.max_value + 1) ** 2) \
            .reshape(self.max_value + 1, self.max_value + 1) \
            .astype(np.uint64)

    def merge(self, other: "Histogram2D") -> None:
        self.bins += other.bins

"""LinearCounter: probabilistic distinct-kmer cardinality estimator.

Port of gatb_core_tpu/kmer/linear_counter.py, gatb-core's LinearCounter
(kmer/impl/LinearCounter.cpp:43-90): a 1-hash Bloom filter of ``size``
bits; the estimate is the classic linear-counting formula
``-size * ln((size - weight) / size)`` where ``weight`` is the number of
set bits. ``is_accurate`` iff load factor < 0.99 (LinearCounter.cpp:76-81).

Also ports the EstimateNbDistinctKmers wrapper
(kmer/impl/ConfigurationAlgorithm.cpp:64-160): counter sized
``min(nb_kmers_total, max_memory*8*1024*1024/2)`` bits, linear extrapolation
``count * nb_kmers_total / nb_processed`` and worst-case fallback to
``nb_kmers_total`` when inaccurate.

On the device: the bits are one bool tensor; a batch of canonical k-mers
(from the counting path's extraction, ``ops/kmer_ops.extract_kmers``) is
hashed with the Bloom filter's hash1 chain (``collections/bloom._chunk_hash``,
``ops/u64.u64_mod_u32``) and stored with one indexed write of True; the
weight is one sum. Invalid rows are left out before the store, as
``_bloom_build`` does, where the JAX module sends them to a dropped
out-of-range bit. The estimate keeps the JAX module's Python float formula.
"""

from __future__ import annotations

import math

import torch

from ..collections.bloom import _chunk_hash, bloom_seeds
from ..ops.u64 import u64_mod_u32


class LinearCounter:
    """1-hash Bloom cardinality counter (batched device inserts)."""

    def __init__(self, size_bits: int, device="cuda"):
        if size_bits <= 0:
            raise ValueError("size_bits must be positive")
        self.size_bits = int(size_bits)
        self._bits = torch.zeros((self.size_bits,), dtype=torch.bool,
                                 device=device)
        self._seed = 0

    def add(self, limbs, valid=None) -> None:
        """Insert a batch of (N, W) big-endian k-mer limbs (uint32 patterns
        in int32 storage, or zero-extended int64), on the counter's
        device; ``valid`` an optional (N,) bool mask."""
        dev = self._bits.device
        limbs = torch.as_tensor(limbs).to(dev)
        if valid is not None:
            limbs = limbs[torch.as_tensor(valid).to(dev)]
        if limbs.shape[0]:
            h = _chunk_hash(limbs, bloom_seeds(self._seed)[0])
            self._bits[u64_mod_u32(h, self.size_bits)] = True

    @property
    def weight(self) -> int:
        return int(self._bits.sum())

    def count(self) -> int:
        """Linear-counting estimate (LinearCounter.cpp:61-73)."""
        weight = self.weight
        if weight >= self.size_bits:
            weight = self.size_bits - 1  # saturated: avoid log(0)
        return int((-1.0 * self.size_bits)
                   * math.log((1.0 * self.size_bits - weight)
                              / self.size_bits))

    def is_accurate(self) -> bool:
        return (self.weight / self.size_bits) < 0.99


def estimate_distinct_kmers(bank, kmer_size: int, max_memory_mb: int = 5000,
                            batch_reads: int = 1024,
                            batch_len: int = 256, device="cuda") -> int:
    """EstimateNbDistinctKmers port (ConfigurationAlgorithm.cpp:64-160,
    367-396): stream the bank's canonical kmers through a LinearCounter on
    ``device`` and linearly extrapolate to the configured total kmer
    estimate."""
    from ..bank.fasta import open_bank
    from ..ops.kmer_ops import extract_kmers
    from .counting import _BatchBuilder

    bank = open_bank(bank)
    est_nb, est_total, est_max = bank.estimate()
    mean_len = est_total // max(est_nb, 1)
    nb_kmers_total = max((mean_len - kmer_size + 1), 0) * max(est_nb, 1)
    if nb_kmers_total == 0:
        return 0
    size_bits = min(nb_kmers_total, max_memory_mb * 8 * 1024 * 1024 // 2)
    counter = LinearCounter(max(size_bits, 64), device=device)

    builder = _BatchBuilder(kmer_size, batch_reads, batch_len)
    processed = torch.zeros((), dtype=torch.int64, device=device)

    def run(codes, valid, lengths, rows):
        nonlocal processed
        kb = extract_kmers(torch.from_numpy(codes).to(device),
                           torch.from_numpy(valid).to(device),
                           torch.from_numpy(lengths).to(device), kmer_size,
                           with_minimizers=False)
        v = kb.valid.reshape(-1)
        counter.add(kb.kmers.reshape(-1, kb.kmers.shape[-1]), v)
        processed += v.sum()

    for seq in bank:
        for batch in builder.add(seq.data):
            run(*batch)
    if builder.row:
        run(*builder.flush())

    processed = int(processed)
    if processed == 0:
        return 0
    if not counter.is_accurate():
        return int(nb_kmers_total)  # worst-case fallback (:157-161)
    return int(counter.count() * (nb_kmers_total / processed))

"""gatb_core_tpu_torch multibank counting against the JAX package and the
dict ground truth (mirrors tests/test_multibank.py, TestDSK.cpp:443-713
multi-bank solidity min/max/sum matrices). Integers: equality.
"""

import numpy as np
import pytest

from gatb_core_tpu.bank.fasta import BankStrings as JBankStrings
from gatb_core_tpu.kmer import counting as jc
from gatb_core_tpu_torch import BankStrings, count_kmers_multibank
from gatb_core_tpu_torch.convert import (multibank_result_from_numpy,
                                         multibank_result_to_numpy)
from gatb_core_tpu_torch.kmer.counting import (_rows_searchsorted,
                                               solidity_check)
from gatb_core_tpu_torch.kmer.model import count_kmers_py
from gatb_core_tpu_torch.ops.kmer_ops import kmers_to_py

K = 15
S1 = "ACGGTCATCAATGCCGTAAGGCTAGCTTACG"
S2 = "TTACGGACGGTCATCAATGCCGTAAGGAGTC"
S3 = "GGGTTTACCACGGTCATCAATGCCGTATTTT"
SMALL = dict(batch_reads=8, batch_len=64)


def _expected_matrix(bank_seqs, k=K):
    per_bank = [count_kmers_py(seqs, k) for seqs in bank_seqs]
    union = sorted(set().union(*[set(c) for c in per_bank]))
    mat = np.zeros((len(union), len(bank_seqs)), np.int32)
    for j, c in enumerate(per_bank):
        for i, v in enumerate(union):
            mat[i, j] = c.get(v, 0)
    return union, mat


def _both(bank_seqs, **kw):
    t = count_kmers_multibank([BankStrings(*s) for s in bank_seqs],
                              device="cpu", **kw)
    j = jc.count_kmers_multibank([JBankStrings(*s) for s in bank_seqs],
                                 **kw)
    return t, j


def _same(t, j):
    for a, b in zip(multibank_result_to_numpy(t)[:4],
                    (j.kmers, j.counts_per_bank, j.counts_sum,
                     j.solid_mask)):
        assert np.array_equal(a, np.asarray(b))
    assert t.info == j.info
    assert np.array_equal(t.solid_kmers, j.solid_kmers)
    assert np.array_equal(t.solid_counts, j.solid_counts)


def test_per_bank_matrix():
    bank_seqs = [[S1, S1], [S2], [S1, S3]]
    t, j = _both(bank_seqs, kmer_size=K, abundance_min=1, **SMALL)
    _same(t, j)
    union, mat = _expected_matrix(bank_seqs)
    assert kmers_to_py(t.kmers) == union
    assert (t.counts_per_bank == mat).all()
    assert (t.counts_sum == mat.sum(axis=1)).all()


@pytest.mark.parametrize("kind", ["sum", "min", "max", "all", "one"])
def test_solidity_kinds(kind):
    bank_seqs = [[S1, S1], [S2], [S1, S3]]
    t, j = _both(bank_seqs, kmer_size=K, abundance_min=2,
                 solidity_kind=kind, **SMALL)
    _same(t, j)
    _, mat = _expected_matrix(bank_seqs)
    exp = {"sum": mat.sum(axis=1) >= 2, "min": mat.min(axis=1) >= 2,
           "max": mat.max(axis=1) >= 2, "all": (mat >= 2).all(axis=1),
           "one": (mat >= 2).any(axis=1)}[kind]
    assert (t.solid_mask == exp).all(), kind


def test_custom_solidity_and_per_bank_thresholds():
    bank_seqs = [[S1], [S2]]
    # kmers present in bank 0 (>=1) but absent (not >=1) from bank 1
    t, j = _both(bank_seqs, kmer_size=K, abundance_min=1,
                 solidity_kind="custom", solid_vec=[True, False], **SMALL)
    _same(t, j)
    _, mat = _expected_matrix(bank_seqs)
    assert (t.solid_mask == ((mat[:, 0] >= 1) & (mat[:, 1] == 0))).all()
    t2, j2 = _both(bank_seqs, kmer_size=K, abundance_min=[1, 2],
                   abundance_max=[5, 9], solidity_kind="all", **SMALL)
    _same(t2, j2)
    counts = np.array([[3, 1], [2, 2], [0, 5]])
    got = solidity_check(counts, "all", [(2, 9), (1, 9)])
    assert got.tolist() == [True, True, False]


@pytest.mark.parametrize("k", [15, 32, 63])
def test_multibank_pass_invariance_and_superbatches(k):
    """nb_passes > 1 and several superbatches (the pairwise merge with
    count columns riding it) give identical matrices."""
    rng = np.random.default_rng(k)
    genome = "".join(rng.choice(list("ACGT"), size=900))
    bank_seqs = [[genome[i:i + 100] for i in range(0, 800, 7)],
                 [genome[i:i + 100] for i in range(3, 800, 11)]]
    kw = dict(kmer_size=k, abundance_min=1, batch_reads=8, batch_len=128,
              superbatch_rows=1 << 11)
    t1, j1 = _both(bank_seqs, nb_passes=1, **kw)
    _same(t1, j1)
    t3 = count_kmers_multibank([BankStrings(*s) for s in bank_seqs],
                               device="cpu", nb_passes=3, **kw)
    np.testing.assert_array_equal(t1.kmers, t3.kmers)
    np.testing.assert_array_equal(t1.counts_per_bank, t3.counts_per_bank)
    union, mat = _expected_matrix(bank_seqs, k)
    assert kmers_to_py(t1.kmers) == union
    assert (t1.counts_per_bank == mat).all()


def test_multibank_processor_and_convert_round_trip():
    from gatb_core_tpu_torch.kmer.count_processor import \
        CountProcessorCollect

    bank_seqs = [[S1, S2], [S3, S1]]
    proc = CountProcessorCollect()
    t = count_kmers_multibank([BankStrings(*s) for s in bank_seqs],
                              kmer_size=K, abundance_min=1, processor=proc,
                              device="cpu", **SMALL)
    kmers, counts, sums = proc.result(1)
    assert np.array_equal(kmers, t.kmers)
    assert np.array_equal(sums, t.counts_sum)
    back = multibank_result_from_numpy(*multibank_result_to_numpy(t))
    assert np.array_equal(back.kmers, t.kmers)
    assert np.array_equal(back.solid_counts, t.solid_counts)
    idx = _rows_searchsorted(t.kmers, t.kmers[::3])
    assert np.array_equal(idx, np.arange(len(t.kmers))[::3])

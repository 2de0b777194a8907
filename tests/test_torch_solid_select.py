"""The count's processor chain on the device (ops/solid_select.py).

- ``solid_select_plain`` and ``solid_histogram_plain``, the kernel's plain
  versions, against the numpy chain they replace
  (``CountProcessorHistogram`` -> ``CountProcessorSolidity`` ->
  ``CountProcessorCollect`` over one table): every bin, the solid rows and
  their counts, at W 1, 2 and 4, on skewed counts and at the edges;
- ``count_kmers`` on the device chain against the host chain (forced by a
  caller's no-op processor) on the fold and LSM paths, in one and two
  passes and with an auto cutoff: the same ``CountResult``;
- the ``count`` span's ``solid_select`` and ``solid`` counters.

The kernel itself runs only on a card: tests/test_torch_cuda.py holds it
against these plain versions there.
"""

import numpy as np
import pytest
import torch

from gatb_core_tpu_torch import BankStrings, count_kmers
from gatb_core_tpu_torch.kmer.count_processor import (
    CountProcessor, CountProcessorChain, CountProcessorCollect,
    CountProcessorHistogram, CountProcessorSolidity)
from gatb_core_tpu_torch.misc import time_info as T
from gatb_core_tpu_torch.ops import solid_select as SS

HISTO_MAX = 10000


def _table(w, n, cap, seed, ones=0.8):
    """(planes (W, cap) int32, counts (cap,) int32): n sorted distinct
    rows, then all-ones padding with count 0; a share ``ones`` of the
    counts is 1, the others spread over 0..2 * HISTO_MAX with the edges
    (negative, 0, 254, 255, histo_max and above) among them."""
    rng = np.random.default_rng(seed)
    rows = np.unique(rng.integers(0, 2**32, (2 * n + 8, w), dtype=np.uint64)
                     .astype(np.uint32), axis=0)[:n]
    assert len(rows) == n
    counts = rng.integers(2, 60, n).astype(np.int32)
    counts[rng.random(n) < ones] = 1
    edges = np.array([-3, 0, 1, 2, 254, 255, HISTO_MAX - 1, HISTO_MAX,
                      HISTO_MAX + 1, 2**31 - 1], np.int32)
    if n:
        pick = rng.integers(0, n, min(n, 3 * len(edges)))
        counts[pick] = edges[np.arange(len(pick)) % len(edges)]
    planes = np.full((w, cap), 0xFFFFFFFF, np.uint32)
    planes[:, :n] = rows.T
    c = np.zeros(cap, np.int32)
    c[:n] = counts
    return (torch.from_numpy(planes.view(np.int32)), torch.from_numpy(c))


def _numpy_chain(planes, counts, n, kind, lo, hi, histo_max=HISTO_MAX):
    """The host chain over one table: (bins, solid rows, solid counts)."""
    kmers = planes[:, :n].T.contiguous().numpy().view(np.uint32)
    c = counts[:n].numpy()
    hist = CountProcessorHistogram(histo_max)
    collect = CountProcessorCollect()
    chain = CountProcessorChain(hist, CountProcessorSolidity(kind, (lo, hi)),
                                collect)
    chain.process_table(0, kmers, c[:, None], c)
    rows, _, sums = collect.result(planes.shape[0])
    return hist.histogram.bins, rows, sums.astype(np.int32)


def _plain(planes, counts, n, lo, hi, histo_max=HISTO_MAX):
    bins = torch.zeros(histo_max + 1, dtype=torch.int64)
    rows, cnt = SS.solid_select(planes, counts, n, lo, hi, bins, histo_max)
    return (bins.numpy().astype(np.uint64), rows.numpy().view(np.uint32),
            cnt.numpy())


def _same(got, ref):
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("n,cap", [(0, 16), (1, 1), (1, 256), (8191, 8192),
                                   (8193, 1 << 14), (20011, 1 << 15)])
def test_plain_select_equals_the_numpy_chain(w, n, cap):
    """Rows not a multiple of the kernel's 8192-row tile, one row, none;
    every edge count; kinds sum, min, max, all and one (on one bank each
    is lo <= count <= hi)."""
    planes, counts = _table(w, n, cap, seed=n + w)
    ref = _numpy_chain(planes, counts, n, "sum", 2, 2**31 - 1)
    _same(_plain(planes, counts, n, 2, 2**31 - 1), ref)
    for kind in ("min", "max", "all", "one"):
        _same(_numpy_chain(planes, counts, n, kind, 2, 2**31 - 1), ref)


@pytest.mark.parametrize("lo,hi", [(1, 1), (2, 254), (255, 255),
                                   (0, HISTO_MAX), (HISTO_MAX + 1, 2**31 - 1),
                                   (3, 2), (-5, 2**40)])
def test_plain_select_at_the_bounds(lo, hi):
    """A finite abundance_max, counts at the uint8 fetch's 254/255 edge,
    histo_max, an empty range and bounds past the int32 range."""
    planes, counts = _table(2, 5000, 8192, seed=lo & 0xFFFF)
    ref = _numpy_chain(planes, counts, 5000, "sum", lo, hi)
    _same(_plain(planes, counts, 5000, lo, hi), ref)


@pytest.mark.parametrize("ones", [0.0, 0.97, 1.0])
@pytest.mark.parametrize("histo_max", [1, 255, HISTO_MAX, 20000])
def test_plain_histogram_under_skew(ones, histo_max):
    """A table of count-1 rows alone, nearly alone, or none; histo_max
    below, at and above the kernel's 12,000 shared bins; the histogram
    alone adds into bins that already hold a pass."""
    planes, counts = _table(4, 30000, 1 << 15, seed=histo_max, ones=ones)
    ref = _numpy_chain(planes, counts, 30000, "sum", 2, 2**31 - 1,
                       histo_max)
    _same(_plain(planes, counts, 30000, 2, 2**31 - 1, histo_max), ref)
    bins = torch.zeros(histo_max + 1, dtype=torch.int64)
    SS.solid_histogram(counts, 30000, bins, histo_max)
    SS.solid_histogram(counts, 1000, bins, histo_max)
    twice = CountProcessorHistogram(histo_max)
    twice.histogram.add_counts(counts[:30000].numpy())
    twice.histogram.add_counts(counts[:1000].numpy())
    assert np.array_equal(bins.numpy().astype(np.uint64),
                          twice.histogram.bins)


def test_wrappers_refuse_what_they_do_not_take():
    planes, counts = _table(2, 100, 256, seed=1)
    bins = torch.zeros(HISTO_MAX + 1, dtype=torch.int64)
    with pytest.raises(ValueError):
        SS.solid_select(planes, counts, 257, 2, 9)
    with pytest.raises(ValueError):
        SS.solid_select(planes[:, :128], counts, 100, 2, 9)
    with pytest.raises(ValueError):
        SS.solid_select(planes, counts.to(torch.int64), 100, 2, 9)
    with pytest.raises(ValueError):
        SS.solid_histogram(counts, 100, bins[:-1], HISTO_MAX)
    with pytest.raises(ValueError):        # neither the CPU nor CUDA
        SS.solid_select(planes.to("meta"), counts.to("meta"), 100, 2, 9)
    assert SS.launches == {"solid_select": 0, "solid_histogram": 0}


def _reads(seed=5, genome_len=3000, step=3):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=genome_len))
    reads = []
    for i in range(0, genome_len - 100, step):
        r = list(genome[i:i + 100])
        if rng.random() < 0.5:     # one substitution in half the reads
            j = rng.integers(0, 100)
            r[j] = "ACGT"[("ACGT".index(r[j]) + 1) % 4]
        reads.append("".join(r))
    return reads


READS = _reads()


def _counted(reads, processor=None, **kw):
    """count_kmers on the CPU with its ``count`` span's counters."""
    args = dict(kmer_size=31, abundance_min=2, device="cpu",
                superbatch_rows=1 << 14)
    args.update(kw)
    T.clear_spans()
    with T.recording():
        res = count_kmers(BankStrings(*reads), processor=processor, **args)
    (root,) = [sp for sp in T.spans() if sp.name == "count"]
    return res, root.counts


def _same_result(a, b):
    for x, y in ((a.solid_kmers, b.solid_kmers),
                 (a.solid_counts, b.solid_counts),
                 (a.histogram.bins, b.histogram.bins)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert np.array_equal(x, y)
    for key in ("cutoff", "first_peak", "nb_solids_after_cutoff"):
        assert getattr(a.histogram, key) == getattr(b.histogram, key), key
    assert set(a.info) == set(b.info)
    for key in a.info:
        if "time" not in key:
            assert a.info[key] == b.info[key], key


@pytest.mark.parametrize("kw", [
    {}, {"nb_passes": 2}, {"carry_accumulator": False},
    {"carry_accumulator": False, "nb_passes": 2},
    {"abundance_min": "auto"},
    {"abundance_min": "auto", "carry_accumulator": False},
    {"kmer_size": 63, "nb_passes": 2}, {"solidity_kind": "one"},
    {"abundance_max": 20}],
    ids=["fold", "fold-2", "lsm", "lsm-2", "auto", "lsm-auto", "k63-2",
         "one", "amax"])
def test_count_on_the_device_chain_equals_the_host_chain(kw):
    """The same CountResult either way; the device chain's pass count in
    ``solid_select``, none on the host chain; ``solid`` on both."""
    dev, dev_counts = _counted(READS, **kw)
    host, host_counts = _counted(READS, processor=CountProcessor(), **kw)
    _same_result(dev, host)
    passes = dev.info["nb_passes_effective"]
    assert dev_counts["solid_select"] == passes == kw.get("nb_passes", 1)
    assert host_counts.get("solid_select", 0) == 0
    assert dev_counts["solid"] == host_counts["solid"] == dev.nb_solid > 0
    assert dev_counts["distinct"] == dev.info["kmers_nb_distinct"]


def test_auto_cutoff_over_passes_keeps_the_host_chain():
    """An auto cutoff needs every pass's histogram before a select: two
    passes take the host chain, with the one-pass device result."""
    two, counts = _counted(READS, abundance_min="auto", nb_passes=2)
    one, _ = _counted(READS, abundance_min="auto")
    assert counts.get("solid_select", 0) == 0
    assert np.array_equal(two.solid_kmers, one.solid_kmers)
    assert np.array_equal(two.solid_counts, one.solid_counts)
    assert np.array_equal(two.histogram.bins, one.histogram.bins)
    assert two.histogram.cutoff == one.histogram.cutoff > 2


def test_a_custom_processor_sees_every_distinct_row():
    """The host chain is unchanged for a caller's processor: it is shown
    every pass's whole table, and the solid table is the device chain's."""
    class Rows(CountProcessor):
        def __init__(self):
            self.n = 0

        def clone(self):
            return self

        def process_table(self, part_id, kmers, counts, sums):
            self.n += len(kmers)

    proc = Rows()
    res, counts = _counted(READS, processor=proc, nb_passes=2)
    dev, _ = _counted(READS, nb_passes=2)
    assert proc.n == res.info["kmers_nb_distinct"] == counts["distinct"]
    _same_result(res, dev)


def test_an_empty_bank_on_the_device_chain():
    for kw in ({}, {"abundance_min": "auto"}, {"nb_passes": 2}):
        dev, counts = _counted(["ACGT" * 5], **kw)
        host, _ = _counted(["ACGT" * 5], processor=CountProcessor(), **kw)
        _same_result(dev, host)
        assert dev.nb_solid == 0 and counts["solid"] == 0
        assert dev.solid_kmers.shape == (0, 2)

"""The count in DSK passes, on the CPU, against the benchmark's plain
references: each pass's table against ``benchmark/reference/passes.py``'s
split (pass p holds the k-mers whose minimizer modulo the passes is p),
the count in three passes against the one-pass count, the plain
reference's count (``benchmark/reference/kmers.py``) and the JAX
package's, and the cross-pass merge of the device chain against a plain
sort of its parts."""

import os
import sys

import numpy as np
import pytest
import torch

from gatb_core_tpu.bank.fasta import BankStrings as JBankStrings
from gatb_core_tpu.kmer.counting import count_kmers as jcount_kmers
from gatb_core_tpu_torch import BankStrings, count_kmers
from gatb_core_tpu_torch.kmer import count_processor as cp
from gatb_core_tpu_torch.kmer import counting as tc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import kmers as K  # noqa: E402
from benchmark.reference import passes as PS  # noqa: E402

CODES = {"A": 0, "C": 1, "T": 2, "G": 3}
KW = dict(batch_reads=16, batch_len=128, superbatch_rows=1 << 13,
          device="cpu")


def _genome(size, seed):
    return "".join(np.random.default_rng(seed).choice(list("ACGT"),
                                                      size=size))


def _reads(size=3000, seed=7, step=9, length=100):
    """Overlapping reads of a random genome, ~11x: most k-mers solid."""
    g = _genome(size, seed)
    return [g[i:i + length] for i in range(0, size - length, step)]


def _values(limbs) -> torch.Tensor:
    """(N, W) uint32 limb rows, W <= 2 -> int64 values."""
    a = np.asarray(limbs).astype(np.int64)
    v = a[:, 0]
    for j in range(1, a.shape[1]):
        v = (v << 32) | a[:, j]
    return torch.from_numpy(v)


def _truth(reads, k):
    """The plain reference's count: (distinct values, counts)."""
    blocks = {}
    for r in reads:
        blocks.setdefault(len(r), []).append([CODES[c] for c in r])
    distinct, counts, _ = K.count(
        [torch.tensor(b, dtype=torch.uint8) for b in blocks.values()], k)
    return distinct, counts


class Recorder(cp.CountProcessor):
    """Keeps each pass's table: pass -> (k-mers, counts)."""

    def __init__(self, tables=None):
        self.tables = {} if tables is None else tables

    def clone(self):
        return Recorder(self.tables)

    def process_table(self, part_id, kmers, counts, sums):
        assert part_id not in self.tables
        self.tables[part_id] = (np.array(kmers), np.array(sums))


@pytest.mark.parametrize("nb_passes", [2, 3])
@pytest.mark.parametrize("k", [21, 31])
def test_each_pass_holds_its_minimizers(k, nb_passes):
    reads = _reads()
    rec = Recorder()
    res = count_kmers(BankStrings(*reads), processor=rec, kmer_size=k,
                      abundance_min=2, nb_passes=nb_passes, **KW)
    distinct, counts = _truth(reads, k)
    which = PS.pass_of(distinct, k, nb_passes)
    split = PS.split(distinct, counts, k, nb_passes, 2)
    assert min(split[0]) > 0 and min(split[1]) > 0
    assert sorted(rec.tables) == list(range(nb_passes))
    assert res.pass_distinct == tuple(split[0])
    for p in range(nb_passes):
        kmers, got_counts = rec.tables[p]
        v = _values(kmers)
        assert torch.equal(v, distinct[which == p])
        assert torch.equal(torch.from_numpy(got_counts.astype(np.int64)),
                           counts[which == p])
        assert (len(v), int((got_counts >= 2).sum())) \
            == (split[0][p], split[1][p])


def _bank_with_a_pass_without_solid(k=31, nb_passes=3):
    """Weak reads (disjoint windows of a genome, each k-mer once) and one
    short fragment read twice, whose few solid k-mers miss a pass: the
    first seed that gives such a bank."""
    for seed in range(100):
        g = _genome(6000, seed)
        reads = [g[i:i + 100] for i in range(0, 3000, 100)]
        reads += [g[4000:4000 + k + 4]] * 2
        distinct, counts = _truth(reads, k)
        n, solid = PS.split(distinct, counts, k, nb_passes, 2)
        if min(n) > 0 and 0 in solid and max(solid) > 0:
            return reads, solid
    raise AssertionError("no seed gives a pass without solid k-mers")


def _check_count(res, reads, k):
    """Rows, counts, histogram and cutoff against the plain reference."""
    distinct, counts = _truth(reads, k)
    solid = counts >= 2
    assert torch.equal(_values(res.solid_kmers), distinct[solid])
    assert torch.equal(torch.from_numpy(res.solid_counts.astype(np.int64)),
                       counts[solid])
    hmax = res.histogram.max_value
    want = torch.bincount(counts.clamp(max=hmax), minlength=hmax + 1)
    assert np.array_equal(res.histogram.bins, want.numpy().astype(np.uint64))
    assert res.histogram.cutoff == res.info["abundance_min"] == 2
    assert res.info["kmers_nb_distinct"] == distinct.numel()


SAME_INFO = ("kmers_nb_distinct", "kmers_nb_solid", "kmers_nb_weak",
             "kmers_nb_valid", "kmers_nb_invalid", "sequences_number",
             "sequences_size", "seq_size_min", "seq_size_max",
             "seq_size_mean", "seq_size_deviation", "kmer_size",
             "abundance_min", "abundance_max")


@pytest.mark.parametrize("bank", ["overlapping", "pass_without_solid"])
def test_three_passes_count_as_one(bank, monkeypatch):
    """The device chain's three-pass count equals its one-pass count and
    the plain reference's, with no numpy collect: the passes' solid rows
    merge on the device."""
    k = 31
    if bank == "overlapping":
        reads = _reads()
    else:
        reads, solid = _bank_with_a_pass_without_solid(k)
    one = count_kmers(BankStrings(*reads), kmer_size=k, abundance_min=2,
                      **KW)

    def refused(*a, **kw):
        raise AssertionError("the device chain collected on the host")

    monkeypatch.setattr(cp.CountProcessorCollect, "result", refused)
    merges = []
    merge = tc._merge_solid_parts

    def counted(parts):
        merges.append(len(parts))
        return merge(parts)

    monkeypatch.setattr(tc, "_merge_solid_parts", counted)
    three = count_kmers(BankStrings(*reads), kmer_size=k, abundance_min=2,
                        nb_passes=3, **KW)
    with_solid = 3 if bank == "overlapping" else sum(s > 0 for s in solid)
    assert merges == ([with_solid] if with_solid > 1 else [])
    _check_count(three, reads, k)
    assert np.array_equal(three.solid_kmers, one.solid_kmers)
    assert np.array_equal(three.solid_counts, one.solid_counts)
    assert three.solid_counts.dtype == one.solid_counts.dtype == np.int32
    assert np.array_equal(three.histogram.bins, one.histogram.bins)
    assert three.info["nb_passes_effective"] == 3
    assert three.pass_distinct == tuple(PS.split(*_truth(reads, k), k, 3,
                                                 2)[0])
    assert one.pass_distinct == (one.info["kmers_nb_distinct"],)
    for key in SAME_INFO:
        assert three.info[key] == one.info[key], key


@pytest.mark.parametrize("fits", [0, 1], ids=["no_part", "one_part"])
def test_three_passes_through_the_host(fits, monkeypatch):
    """Where the passes' solid rows do not fit on the card with their
    merge (``_parts_fit`` says so after ``fits`` parts), the parts held
    so far and every later one go to the host, and the host merge gives
    the same count; ``count.collect`` opens once."""
    from gatb_core_tpu_torch.misc import time_info as T

    k = 31
    reads = _reads()
    one = count_kmers(BankStrings(*reads), kmer_size=k, abundance_min=2,
                      **KW)
    asked = []
    monkeypatch.setattr(tc, "_parts_fit",
                        lambda parts, more: asked.append(more)
                        or len(parts) <= fits)
    calls = []
    for name in ("_merge_solid_parts", "_merge_host_parts"):
        merge = getattr(tc, name)
        monkeypatch.setattr(tc, name, lambda parts, merge=merge, name=name:
                            calls.append((name, len(parts)))
                            or merge(parts))
    T.clear_spans()
    with T.recording():
        three = count_kmers(BankStrings(*reads), kmer_size=k,
                            abundance_min=2, nb_passes=3, **KW)
    assert asked == [2, 1][:fits + 1]
    assert calls == [("_merge_host_parts", 3)]
    assert [sp.name for sp in T.spans()].count("count.collect") == 1
    _check_count(three, reads, k)
    assert np.array_equal(three.solid_kmers, one.solid_kmers)
    assert np.array_equal(three.solid_counts, one.solid_counts)
    assert np.array_equal(three.histogram.bins, one.histogram.bins)


class _Part:
    """A part's shape alone, on a card: (n, W) rows and (n,) counts."""

    is_cuda = True
    device = "cuda:0"

    def __init__(self, n, w=None):
        self.n, self.shape = n, (n, w)

    def numel(self):
        return self.n


@pytest.mark.parametrize("rows,peak,fits", [
    (7_720_000, 5.3e9, True),        # chr14q_k31 in three passes
    (1 << 28, 36e9, True),           # 35.4 GB held and merged
    (1 << 28, 37e9, False),
    ((1 << 28) + 1, 12e9, False),    # the merge's runs double
    (1_000_000_000, 5.3e9, False)])  # a human genome's pass
def test_the_parts_fit_on_an_80_gb_card(rows, peak, fits, monkeypatch):
    """Three passes at k 31 (W 2): the held rows and the merge's two
    padded buffers of 12 B rows beside the peak, within 0.9 x 80 GB."""
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: peak)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda d: type("P", (), {"total_memory": 80 * 10**9})())
    parts = [(_Part(rows, 2), _Part(rows))]
    assert tc._parts_fit(parts, 2) is fits


def test_three_passes_count_as_jax():
    reads = _reads(size=2000)
    kw = dict(kmer_size=31, abundance_min=2, nb_passes=3, batch_reads=16,
              batch_len=128, superbatch_rows=1 << 13)
    got = count_kmers(BankStrings(*reads), device="cpu", **kw)
    want = jcount_kmers(JBankStrings(*reads), **kw)
    assert np.array_equal(got.solid_kmers, np.asarray(want.solid_kmers))
    assert np.array_equal(got.solid_counts,
                          np.asarray(want.solid_counts).astype(np.int32))
    assert np.array_equal(got.histogram.bins, want.histogram.bins)
    assert got.histogram.cutoff == want.histogram.cutoff
    for key in SAME_INFO + ("nb_passes_effective",):
        assert got.info[key] == want.info[key], key


def _parts(w, sizes, seed):
    """Disjoint sorted parts of random rows with uint32 limbs (high bits
    set too, never the all-ones sentinel), and random counts."""
    g = torch.Generator().manual_seed(seed)
    n = sum(sizes)
    rows = torch.randint(-2**31, 2**31 - 1, (2 * n + 8, w), dtype=torch.int32,
                         generator=g)
    rows = torch.unique(rows, dim=0)[:n]
    rows = rows[torch.randperm(rows.shape[0], generator=g)]
    assert rows.shape[0] == n
    counts = torch.randint(2, 1000, (n,), dtype=torch.int32, generator=g)
    out, s = [], 0
    for m in sizes:
        r = rows[s:s + m].numpy().view(np.uint32)
        order = np.lexsort(r.T[::-1])
        out.append((rows[s:s + m][order].contiguous(),
                    counts[s:s + m][order].contiguous()))
        s += m
    return out


SIZES = [(1, [5, 3]), (2, [1000, 1, 257]), (2, [300, 700, 64, 1025, 9]),
         (4, [129, 128]), (2, [1 << 12, 1 << 12, 1 << 12])]


def _sorted_parts(parts):
    """The parts' rows (uint32) and counts by a plain sort."""
    allr = np.concatenate([r.numpy().view(np.uint32) for r, _ in parts])
    allc = np.concatenate([c.numpy() for _, c in parts])
    order = np.lexsort(allr.T[::-1])
    return allr[order], allc[order]


@pytest.mark.parametrize("w,sizes", SIZES)
def test_the_merge_equals_a_sort_of_its_parts(w, sizes):
    parts = _parts(w, sizes, seed=sum(sizes) + w)
    want_rows, want_counts = _sorted_parts(parts)
    rows, counts = tc._merge_solid_parts(parts)
    assert parts == []
    assert rows.dtype == counts.dtype == torch.int32
    assert np.array_equal(rows.numpy().view(np.uint32), want_rows)
    assert np.array_equal(counts.numpy(), want_counts)


@pytest.mark.parametrize("w,sizes", SIZES)
def test_the_host_merge_equals_a_sort_of_its_parts(w, sizes):
    parts = _parts(w, sizes, seed=sum(sizes) + w)
    want_rows, want_counts = _sorted_parts(parts)
    rows, counts = tc._merge_host_parts(parts)
    assert parts == []
    assert rows.dtype == np.uint32 and counts.dtype == np.int32
    assert np.array_equal(rows, want_rows)
    assert np.array_equal(counts, want_counts)

"""The port's host leftovers against the JAX package's: the bank tools
(``BankRandom``, ``BankSplitter``, ``BankFastaWriter``, ``BankBinary``,
``tools.bankgen``) write the same bytes, ``misc.{enums,strings,iterators}``
behave alike, ``BankKmers`` / ``iter_bank_kmers`` / ``Histogram2D`` give
the same values, the native ``NativeSeqReader`` reads what JAX's reads,
and the device ``LinearCounter`` and ``estimate_distinct_kmers`` (on the
CPU here) set the same bits and give the same estimates at k = 21, 31
and 63.
"""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatb_core_tpu import native as jnative
from gatb_core_tpu.bank import binary as jbinary
from gatb_core_tpu.bank import fasta as jfasta
from gatb_core_tpu.kmer import bank_kmers as jbk
from gatb_core_tpu.kmer import histogram as jhist
from gatb_core_tpu.kmer import linear_counter as jlc
from gatb_core_tpu.misc import enums as jenums
from gatb_core_tpu.misc import iterators as jit_
from gatb_core_tpu.misc import strings as jstrings
from gatb_core_tpu.tools import bankgen as jbankgen
from gatb_core_tpu_torch import native as tnative
from gatb_core_tpu_torch.bank import binary as tbinary
from gatb_core_tpu_torch.bank import fasta as tfasta
from gatb_core_tpu_torch.kmer import bank_kmers as tbk
from gatb_core_tpu_torch.kmer import histogram as thist
from gatb_core_tpu_torch.kmer import linear_counter as tlc
from gatb_core_tpu_torch.misc import enums as tenums
from gatb_core_tpu_torch.misc import iterators as tit
from gatb_core_tpu_torch.misc import strings as tstrings
from gatb_core_tpu_torch.tools import bankgen as tbankgen


def _records(bank):
    return [(s.comment, s.data, s.quality, s.index) for s in bank]


def _read(path):
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# bank tools
# ---------------------------------------------------------------------------


def test_bank_random_and_splitter():
    assert _records(tfasta.BankRandom(7, 53, seed=4)) == \
        _records(jfasta.BankRandom(7, 53, seed=4))
    assert tfasta.BankRandom(7, 53).get_size() == 7 * 53
    ref = "".join(s.data for s in tfasta.BankRandom(1, 500, seed=2))
    for args in ((80, 30, 1), (50, 10, 3), (500, 0, 2), (600, 0, 1)):
        t = tfasta.BankSplitter(ref, *args)
        j = jfasta.BankSplitter(ref, *args)
        assert _records(t) == _records(j)
        assert t.get_size() == j.get_size()


@pytest.mark.parametrize("name,width", [("w.fa", 0), ("w.fa", 60),
                                        ("w.fq", 0), ("w.fa.gz", 7)])
def test_bank_fasta_writer_bytes(tmp_path, name, width):
    """The same records through each package's writer: the same bytes
    (for .gz, the same bytes once decompressed: the gzip header holds a
    time)."""
    seqs = [jfasta.Sequence(f"s{i} x", "ACGTN" * (i * 7 + 3),
                            None if not name.endswith(".fq")
                            else "I" * (i * 35 + 15), i)
            for i in range(5)]
    paths = []
    for mod, tag in ((jfasta, "j"), (tfasta, "t")):
        path = str(tmp_path / f"{tag}_{name}")
        with mod.BankFastaWriter(path, width=width) as w:
            for s in seqs:
                w.insert(mod.Sequence(s.comment, s.data, s.quality, s.index))
            w.flush()
        paths.append(path)
    assert _read(paths[0]) == _read(paths[1])
    assert _records(tfasta.open_bank(paths[1])) == \
        _records(jfasta.open_bank(paths[0]))


def test_bank_binary_bytes(tmp_path):
    src = tmp_path / "in.fa"
    src.write_text(">a\nACGTNNacgtRY\n>b\n\n>c\n" + "GATTACA" * 41 + "\n")
    jout, tout = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    assert jbinary.convert_bank(str(src), jout) == \
        tbinary.convert_bank(str(src), tout) == 3
    assert _read(jout) == _read(tout)
    assert _records(tbinary.BankBinary(tout)) == \
        _records(jbinary.BankBinary(jout))
    assert tbinary.BankBinary(tout).get_size() == \
        jbinary.BankBinary(jout).get_size()
    codes = np.arange(11, dtype=np.uint8) % 4
    packed = tbinary.pack_codes(codes)
    assert packed == jbinary.pack_codes(codes)
    assert np.array_equal(tbinary.unpack_codes(packed, 11), codes)
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\0" * 16)
    with pytest.raises(ValueError):
        list(tbinary.BankBinary(str(bad)))


def test_bankgen_bytes(tmp_path):
    args = ["-seq-len", "3000", "-read-len", "80", "-overlap-len", "40",
            "-coverage", "2"]
    assert jbankgen.main(["-out", str(tmp_path / "j")] + args) == 0
    assert tbankgen.main(["-out", str(tmp_path / "t")] + args) == 0
    for suffix in ("_sequence.fa", "_reads.fa"):
        assert _read(str(tmp_path / ("t" + suffix))) == \
            _read(str(tmp_path / ("j" + suffix)))


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def test_enums():
    for name in ("BloomKind", "DebloomKind", "DebloomImpl", "BranchingKind",
                 "KmerSolidityKind"):
        t, j = getattr(tenums, name), getattr(jenums, name)
        assert [(m.name, m.value) for m in t] == \
            [(m.name, m.value) for m in j]
        assert t.default().name == j.default().name
        for m in j:
            assert tenums.parse_enum(t, m.value).name == m.name
    with pytest.raises(ValueError):
        tenums.parse_enum(tenums.BloomKind, "bogus")
    flags = {k: v for k, v in vars(jenums).items() if k.startswith("STR_")}
    assert flags and all(getattr(tenums, k) == v for k, v in flags.items())


def test_strings():
    for mod in (tstrings, jstrings):
        assert mod.Stringify.format("k=%d in %s", 31, "r.fa") == \
            "k=31 in r.fa"
    text = "a,b;;c,,d;"
    assert list(tstrings.TokenizerIterator(text, ",;")) == \
        list(jstrings.TokenizerIterator(text, ",;"))
    it = tstrings.TokenizerIterator(text, ",;")
    it.first()
    toks = []
    while not it.is_done():
        toks.append(it.item())
        it.next()
    assert toks == ["a", "b", "c", "d"]
    para = "one two three four five six seven eight nine ten eleven"
    for width, indent in ((12, 0), (20, 4), (80, 2)):
        assert tstrings.StringLine.format(para, width, indent) == \
            jstrings.StringLine.format(para, width, indent)
    xml = ('<?xml version="1.0"?><config a="1 &amp; 2" b=\'x\'>'
           '<kmer_size>31</kmer_size><empty/><n>&lt;7&gt;</n></config>')
    ev = lambda mod: [(e.kind, e.name, e.value)
                      for e in mod.XmlReader(xml).read()]
    assert ev(tstrings) == ev(jstrings)


def test_iterators():
    data = list(range(25))
    assert list(tit.truncate(data, 7)) == list(jit_.truncate(data, 7))
    odd = lambda x: x % 2
    assert list(tit.filter_it(data, odd)) == list(jit_.filter_it(data, odd))
    assert list(tit.composite("ab", [1], ())) == \
        list(jit_.composite("ab", [1], ()))
    assert list(tit.paired("abc", data)) == list(jit_.paired("abc", data))
    assert list(tit.product("ab", [1, 2])) == list(jit_.product("ab", [1, 2]))
    for mod in (tit, jit_):
        seen = []
        sub = mod.SubjectIterator(data, period=10)
        sub.add_listener(seen.append)
        assert list(sub) == data and seen == [10, 20]
        can = mod.CancellableIterator(data)
        got = []
        for x in can:
            got.append(x)
            if x == 4:
                can.cancel()
        assert got == [0, 1, 2, 3, 4]
    for disp in (tit.SerialDispatcher(), tit.Dispatcher(1),
                 tit.Dispatcher(3)):
        out = []
        assert disp.iterate(iter(data), out.append, group_size=4) == 25
        assert sorted(out) == data
        ran = []
        disp.dispatch_commands([lambda i=i: ran.append(i) for i in range(5)])
        assert sorted(ran) == list(range(5))


# ---------------------------------------------------------------------------
# kmer layer
# ---------------------------------------------------------------------------


def test_bank_kmers_and_iteration():
    for k in (1, 3, 5):
        t, j = tbk.BankKmers(k), jbk.BankKmers(k)
        assert _records(t) == _records(j)
        assert t.id == j.id and t.estimate() == j.estimate()
        assert t.get_size() == j.get_size()
    with pytest.raises(ValueError):
        tbk.BankKmers(15)
    seqs = ["ACTGACCTGNAGT", "AC", "GGGTTTAAACCC"]
    for m in (None, 3):
        t = list(tbk.iter_bank_kmers(tfasta.BankStrings(*seqs), 5, m))
        j = list(jbk.iter_bank_kmers(jfasta.BankStrings(*seqs), 5, m))
        assert t == j


def test_histogram2d():
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 40, size=(500, 2))
    t, j = thist.Histogram2D(max_value=25), jhist.Histogram2D(max_value=25)
    t.add_counts(counts)
    j.add_counts(counts)
    t2, j2 = thist.Histogram2D(max_value=25), jhist.Histogram2D(max_value=25)
    t2.add_counts(counts[:50])
    j2.add_counts(counts[:50])
    t.merge(t2)
    j.merge(j2)
    assert t.bins.dtype == j.bins.dtype and np.array_equal(t.bins, j.bins)
    assert thist.Histogram2D().bins.shape == (1001, 1001)


# ---------------------------------------------------------------------------
# native record reader
# ---------------------------------------------------------------------------


def _write(path, text):
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
    return path


@pytest.mark.parametrize("name", ["r.fa", "r.fq", "r.fa.gz", "r.fq.gz",
                                  "long.fa"])
def test_native_seq_reader(tmp_path, name):
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain for the native parser")
    rng = np.random.default_rng(len(name))
    seqs = ["".join(rng.choice(list("ACGTN"), size=n))
            for n in (5, 0, 31, 100, 77)]
    if name.startswith("long"):
        seqs.append("ACGT" * 5000)       # above initial_cap below
    if ".fq" in name:
        text = "".join(f"@q{i}\n{s}\n+\n{'I' * len(s)}\n"
                       for i, s in enumerate(seqs))
    else:
        text = "".join(f">s{i} c\n{s[:40]}\n{s[40:]}\n"
                       for i, s in enumerate(seqs))
    path = _write(str(tmp_path / name), text)
    got = list(tnative.NativeSeqReader(path, initial_cap=64))
    assert got == list(jnative.NativeSeqReader(path, initial_cap=64))
    assert got == [s.data for s in tfasta.BankFasta(path)]
    with pytest.raises(FileNotFoundError):
        tnative.NativeSeqReader(str(tmp_path / "missing.fa"))


# ---------------------------------------------------------------------------
# linear counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [21, 31, 63])
def test_linear_counter_bits_and_count(k):
    from gatb_core_tpu.ops.kmer_ops import py_to_limbs

    rng = np.random.default_rng(k)
    vals = [int(v) for v in rng.integers(0, 1 << min(2 * k, 62), size=3000)]
    vals += [(1 << (2 * k)) - 1 - v for v in vals[:500]]
    limbs = np.asarray(py_to_limbs(vals, k)).astype(np.uint32)
    valid = rng.random(len(vals)) < 0.8
    j = jlc.LinearCounter(20011)
    t = tlc.LinearCounter(20011, device="cpu")
    for lo, hi in ((0, 1000), (1000, 3500)):
        j.add(jnp.asarray(limbs[lo:hi]), jnp.asarray(valid[lo:hi]))
        t.add(torch.from_numpy(limbs[lo:hi].view(np.int32)),
              torch.from_numpy(valid[lo:hi]))
    j.add(limbs[:200])                  # no mask: every row, twice over
    t.add(torch.from_numpy(limbs[:200].view(np.int32)).long() & 0xFFFFFFFF)
    assert np.array_equal(t._bits.numpy(), np.asarray(j._bits))
    assert t.weight == j.weight and t.count() == j.count()
    assert t.is_accurate() == j.is_accurate()
    small_t, small_j = tlc.LinearCounter(64, "cpu"), jlc.LinearCounter(64)
    small_t.add(torch.from_numpy(limbs.view(np.int32)))
    small_j.add(limbs)
    assert small_t.count() == small_j.count()      # saturated
    assert not small_t.is_accurate()
    with pytest.raises(ValueError):
        tlc.LinearCounter(0, "cpu")


@pytest.fixture(scope="module")
def estimate_bank(tmp_path_factory):
    """6,000 reads (past IBank.estimate's 5,000-read sample, so the
    estimate scales by file size), lengths 70-160, some N, one read
    shorter than k."""
    rng = np.random.default_rng(8)
    genome = "".join(rng.choice(list("ACGT"), size=20_000))
    path = str(tmp_path_factory.mktemp("lc") / "reads.fa")
    with open(path, "w") as f:
        for i in range(6000):
            n = int(rng.integers(70, 161))
            s = int(rng.integers(0, len(genome) - n))
            r = list(genome[s:s + n])
            if i % 11 == 0:
                r[int(rng.integers(0, n))] = "N"
            f.write(f">r{i}\n{''.join(r)}\n")
        f.write(">short\nACGT\n")
    return path


@pytest.mark.parametrize("k,max_memory_mb", [(21, 5000), (31, 5000),
                                             (63, 5000), (21, 0)])
def test_estimate_distinct_kmers(estimate_bank, k, max_memory_mb):
    """Equal estimates; ``max_memory_mb=0`` gives a 64-bit counter that
    saturates, so both fall back to the total k-mer estimate."""
    kw = dict(max_memory_mb=max_memory_mb, batch_reads=512, batch_len=256)
    t = tlc.estimate_distinct_kmers(estimate_bank, k, device="cpu", **kw)
    j = jlc.estimate_distinct_kmers(estimate_bank, k, **kw)
    assert isinstance(t, int) and t == j and t > 0

"""The port's Leon compression (compression/{range_coder,leon,leon_ref}.py,
bank/fasta.BankLeon, tools/leon.py) against the JAX package's: the range
coder's byte streams, GTBL1 files byte for byte (the inputs of
tests/test_leon.py and a seeded FASTQ), the reference ``.leon`` container
dataset by dataset and attribute by attribute (lossy, the default, and
lossless), each package decoding the other's files, the empty solid set,
``open_bank`` of a ``.leon`` file and the CLI. The port counts on the CPU
here (``device="cpu"``).

A JAX compression costs seconds (its count compiles), so the four the file
makes are module fixtures shared by the tests. The lossless container is
held to the JAX lossy one with the quality blocks replaced by the zlib
streams of the raw qualities, which is what the JAX function writes with
``lossless=True``.
"""

import functools
import zlib

import h5py
import numpy as np
import pytest

from gatb_core_tpu.compression import leon as jleon
from gatb_core_tpu.compression import leon_ref as jref
from gatb_core_tpu.compression import range_coder as jrc
from gatb_core_tpu.tools import leon as jtool
from gatb_core_tpu_torch.bank.fasta import BankLeon, open_bank
from gatb_core_tpu_torch.compression import leon as tleon
from gatb_core_tpu_torch.compression import leon_ref as tref
from gatb_core_tpu_torch.compression import range_coder as trc
from gatb_core_tpu_torch.tools import leon as ttool


def _write_fasta(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">seq_{i}\n{r}\n")
    return str(path)


def _write_fastq(path, n_reads=150, genome_len=1200, read_len=80, seed=5):
    """A seeded FASTQ at ~10x: some N, qualities straddling '@' with phred
    0 and 2 sprinkled in, headers ``r<i> pos:<p>``."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=genome_len))
    with open(path, "w") as f:
        for i in range(n_reads):
            s = int(rng.integers(0, genome_len - read_len))
            r = list(genome[s:s + read_len])
            if i % 7 == 0:
                r[int(rng.integers(0, read_len))] = "N"
            q = rng.integers(33, 74, size=read_len)
            q[rng.integers(0, read_len, 3)] = 33
            q[rng.integers(0, read_len, 3)] = 35
            f.write(f"@r{i} pos:{s}\n{''.join(r)}\n+\n"
                    f"{''.join(chr(int(c)) for c in q)}\n")
    return str(path)


def _reads_fasta_n():
    rng = np.random.default_rng(1)
    genome = "".join(rng.choice(list("ACGT"), size=400))
    reads = [genome[i:i + 80] for i in range(0, 300, 11)]
    reads.append("NNNACGT" + genome[:40])
    return reads


def _reads_coverage():
    rng = np.random.default_rng(2)
    genome = "".join(rng.choice(list("ACGT"), size=1000))
    return [genome[i:i + 100] for i in range(0, 900, 5)] * 2


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("leon_in")
    return {"fasta_n": (_write_fasta(d / "n.fa", _reads_fasta_n()), 21, 1),
            "coverage": (_write_fasta(d / "cov.fa", _reads_coverage()),
                         25, 2),
            "fastq": (_write_fastq(d / "reads.fq"), 21, 2)}


@pytest.fixture(scope="module")
def jax_gtbl(inputs, tmp_path_factory):
    """Three JAX GTBL1 compressions: name -> (path, info)."""
    d = tmp_path_factory.mktemp("leon_jax")
    out = {}
    for name, (src, k, amin) in inputs.items():
        path = str(d / f"{name}.leon")
        info = jleon.LeonCompressor(kmer_size=k, abundance_min=amin) \
            .compress(src, path)
        out[name] = (path, info)
    return out


@pytest.fixture(scope="module")
def jax_ref(inputs, tmp_path_factory):
    """The fourth JAX compression: the reference container of the FASTQ,
    lossy (the default)."""
    src, k, amin = inputs["fastq"]
    path = str(tmp_path_factory.mktemp("leon_jax_ref") / "reads.fq.leon")
    info = jref.leon_ref_compress(src, path, kmer_size=k, abundance_min=amin)
    return path, info


def _contents(path):
    out = {}

    def walk(group, prefix):
        for key in group:
            if isinstance(group[key], h5py.Group):
                out[prefix + key + "/"] = "group"
                walk(group[key], prefix + key + "/")
            else:
                ds = group[key]
                out[prefix + key] = (ds.dtype.str, ds[...].tobytes())
            out[prefix + key + "@"] = {
                k: (v.tolist() if hasattr(v, "tolist") else v)
                for k, v in group[key].attrs.items()}

    with h5py.File(path, "r") as f:
        walk(f, "")
    return out


# ---------------------------------------------------------------------------
# range coder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_sym,size,skew", [(256, 5000, True), (2, 500, False),
                                              (5, 3000, False),
                                              (256, 70000, True)])
def test_range_coder_bytes_equal(n_sym, size, skew):
    """Both coders give the same bytes for the same symbol stream (the
    last stream is long enough to rescale the model) and decode it."""
    rng = np.random.default_rng(n_sym + size)
    p = None
    if skew:
        p = np.r_[[0.5], [0.5 / (n_sym - 1)] * (n_sym - 1)]
    syms = [int(s) for s in rng.choice(n_sym, size=size, p=p)]
    bufs = []
    for rc in (jrc, trc):
        enc, m = rc.RangeEncoder(), rc.Order0Model(n_sym)
        for s in syms:
            enc.encode(m, s)
        enc.flush()
        bufs.append(enc.get_buffer())
    assert bufs[0] == bufs[1]
    dec, m = trc.RangeDecoder(bufs[1]), trc.Order0Model(n_sym)
    assert [dec.next_byte(m) for _ in syms] == syms


# ---------------------------------------------------------------------------
# GTBL1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fasta_n", "coverage", "fastq"])
def test_gtbl_bytes_equal(inputs, jax_gtbl, tmp_path, name):
    src, k, amin = inputs[name]
    jpath, jinfo = jax_gtbl[name]
    tpath = str(tmp_path / "t.leon")
    tinfo = tleon.LeonCompressor(kmer_size=k, abundance_min=amin,
                                 device="cpu").compress(src, tpath)
    assert tinfo == jinfo
    assert open(tpath, "rb").read() == open(jpath, "rb").read()


@pytest.mark.parametrize("name", ["fasta_n", "coverage", "fastq"])
def test_gtbl_each_decodes_the_other(inputs, jax_gtbl, tmp_path, name):
    """The port decodes the JAX file (which the test above holds equal to
    the port's) to the input, and writes the same file as JAX's
    decompressor."""
    src = inputs[name][0]
    jpath = jax_gtbl[name][0]
    tout, jout = str(tmp_path / "t.out"), str(tmp_path / "j.out")
    tseqs = tleon.LeonDecompressor().decompress(jpath, tout)
    jseqs = jleon.LeonDecompressor().decompress(jpath, jout)
    assert open(tout, "rb").read() == open(jout, "rb").read()
    orig = list(open_bank(src))
    assert [(s.comment, s.data, s.quality) for s in tseqs] == \
        [(s.comment, s.data, s.quality) for s in orig]
    assert [(s.comment, s.data, s.quality) for s in jseqs] == \
        [(s.comment, s.data, s.quality) for s in orig]


# ---------------------------------------------------------------------------
# the reference container
# ---------------------------------------------------------------------------


def test_ref_container_lossy_equal(inputs, jax_ref, tmp_path):
    src, k, amin = inputs["fastq"]
    jpath, jinfo = jax_ref
    tpath = str(tmp_path / "t.leon")
    tinfo = tref.leon_ref_compress(src, tpath, kmer_size=k,
                                   abundance_min=amin, device="cpu")
    assert tinfo == jinfo
    tc, jc = _contents(tpath), _contents(jpath)
    assert tc.keys() == jc.keys()
    for key in jc:
        assert tc[key] == jc[key], key
    # the smoothing changed some quality: the lossy path is not vacuous
    orig = open(src).read().splitlines()
    got = tref.leon_ref_decompress(tpath).decode().splitlines()
    assert got[3::4] != orig[3::4] and got[1::4] == orig[1::4]


def test_ref_container_lossless_equal(inputs, jax_ref, tmp_path):
    src, k, amin = inputs["fastq"]
    tpath = str(tmp_path / "t.leon")
    tref.leon_ref_compress(src, tpath, kmer_size=k, abundance_min=amin,
                           lossless=True, device="cpu")
    quals = [s.quality for s in open_bank(src)]
    want = _contents(jax_ref[0])
    want["leon/qual/qual_0"] = ("|u1", zlib.compress(
        "".join(q + "\n" for q in quals).encode("ascii"), 9))
    got = _contents(tpath)
    assert got.keys() == want.keys()
    for key in want:
        if key == "leon/qual/qual_0@":
            assert got[key] == {"size": [str(len(
                want["leon/qual/qual_0"][1]))]}
        else:
            assert got[key] == want[key], key
    orig = open(src).read().splitlines()
    assert jref.leon_ref_decompress(tpath).decode().splitlines()[3::4] == \
        orig[3::4]


def test_ref_contents_match_the_file(inputs, jax_ref):
    """The helper's contents are what the JAX function wrote, and its
    blocks decode in memory with the port's decoders."""
    src, k, amin = inputs["fastq"]
    c = tref.leon_ref_contents(src, k, amin, device="cpu")
    j = _contents(jax_ref[0])
    assert c["bloom_bytes"] == j["leon/bloom"][1]
    assert c["anchors_dict"] == j["leon/anchors/anchorsDict"][1]
    assert c["dna_blocks"] == [j["leon/dna/dna_0"][1]]
    assert c["header_blocks"] == [j["leon/header/header_0"][1]]
    assert c["qual_blocks"] == [j["leon/qual/qual_0"][1]]
    seqs = list(open_bank(src))
    bloom = tref.NeighborBloom(c["bloom_bytes"], c["bloom_size"],
                               c["bloom_nb_hash"], k)
    dec = trc.RangeDecoder(c["anchors_dict"])
    m = trc.Order0Model(5)
    anchors = []
    for _ in range(c["nb_anchors"]):
        v = 0
        for _ in range(k):
            v = (v << 2) | dec.next_byte(m)
        anchors.append(v)
    reads = tref._DnaDecoder(k, bloom, anchors).decode_block(
        c["dna_blocks"][0], len(seqs))
    headers = tref._HeaderDecoder(c["first_header"]).decode_block(
        c["header_blocks"][0], len(seqs))
    assert reads == [s.data for s in seqs]
    assert headers == [s.comment for s in seqs]


def test_ref_each_decodes_the_other(inputs, jax_ref, tmp_path):
    src, k, amin = inputs["fastq"]
    tpath = str(tmp_path / "t.leon")
    tref.leon_ref_compress(src, tpath, kmer_size=k, abundance_min=amin,
                           device="cpu")
    assert tref.leon_ref_decompress(jax_ref[0]) == \
        jref.leon_ref_decompress(jax_ref[0])
    assert jref.leon_ref_decompress(tpath) == \
        tref.leon_ref_decompress(tpath)
    assert tref.is_leon_ref_container(tpath)
    assert not tref.is_leon_ref_container(src)
    got = tleon.LeonDecompressor().decompress(tpath)
    assert [s.data for s in got] == [s.data for s in open_bank(src)]


def test_empty_solid_set(inputs, tmp_path):
    """abundance-min above every count: no dictionary, a Bloom of zero
    words; both formats still round trip, through both packages."""
    src = inputs["fasta_n"][0]
    reads = [s.data for s in open_bank(src)]
    g = str(tmp_path / "e.leon")
    info = tleon.LeonCompressor(kmer_size=21, abundance_min=1000,
                                device="cpu").compress(src, g)
    assert info["dict_size"] == 0
    assert [s.data for s in jleon.LeonDecompressor().decompress(g)] == reads
    r = str(tmp_path / "e.ref.leon")
    rinfo = tref.leon_ref_compress(src, r, kmer_size=21, abundance_min=1000,
                                   device="cpu")
    assert rinfo["nb_anchors"] == 0
    with h5py.File(r, "r") as f:
        assert not f["leon/bloom"][...].any()
    assert jref.leon_ref_decompress(r).decode().splitlines()[1::2] == reads


@pytest.mark.parametrize("fmt", ["gtbl", "ref"])
def test_open_bank_of_a_leon_file(inputs, jax_gtbl, jax_ref, fmt):
    path = jax_gtbl["fastq"][0] if fmt == "gtbl" else jax_ref[0]
    bank = open_bank(path)
    assert isinstance(bank, BankLeon)
    src = inputs["fastq"][0]
    orig = list(open_bank(src))
    got = list(bank)
    assert [s.data for s in got] == [s.data for s in orig]
    assert [s.comment for s in got] == [s.comment for s in orig]
    if fmt == "gtbl":
        assert [s.quality for s in got] == [s.quality for s in orig]
    assert bank.get_size() == sum(len(s.data) for s in orig)


@pytest.fixture
def tool_on_cpu(monkeypatch):
    """The port's leon CLI counts on the CPU."""
    monkeypatch.setattr(
        tleon, "LeonCompressor",
        functools.partial(tleon.LeonCompressor, device="cpu"))
    monkeypatch.setattr(
        tref, "leon_ref_compress",
        functools.partial(tref.leon_ref_compress, device="cpu"))


def test_tool(inputs, jax_gtbl, jax_ref, tool_on_cpu, tmp_path, capsys):
    """``leon -c -gtbl`` and ``leon -c`` write the JAX files; ``leon -d``
    writes what the JAX tool's ``-d`` writes, for both formats."""
    src, k, amin = inputs["fastq"]
    flags = ["-kmer-size", str(k), "-abundance", str(amin)]
    g = str(tmp_path / "g.leon")
    assert ttool.main(["-file", src, "-c", "-gtbl", "-out", g] + flags) == 0
    assert open(g, "rb").read() == open(jax_gtbl["fastq"][0], "rb").read()
    r = str(tmp_path / "r.leon")
    assert ttool.main(["-file", src, "-c", "-out", r] + flags) == 0
    assert _contents(r) == _contents(jax_ref[0])
    for leon_file in (g, r):
        assert ttool.main(["-file", leon_file, "-d", "-out",
                           leon_file + ".t"]) == 0
        assert jtool.main(["-file", leon_file, "-d", "-out",
                           leon_file + ".j"]) == 0
        assert open(leon_file + ".t", "rb").read() == \
            open(leon_file + ".j", "rb").read()
    assert ttool.main(["-file", src]) == 1
    assert "compressed" in capsys.readouterr().out

"""The port's graph and bank CLI tools against the JAX package's, at
tolerance 0: ``dbgcheck.check_graph`` (every key but ``time``) at k = 15,
31, 33 and 63, including checksums that wrap mod 2^64,
``dbgtopology.topology_matrix``, both CLIs' printed blocks (the port's
graph built on the CPU), ``kmer_checksum`` on 1- and 2-word records,
``clear_cache.clear``, the ``new_project`` tree and ``bank_download``
over ``file://``.
"""

import gzip
import os

import numpy as np
import pytest

from gatb_core_tpu.collections import containers as jcont
from gatb_core_tpu.debruijn.graph import Graph as JGraph
from gatb_core_tpu.tools import bank_download as jbd
from gatb_core_tpu.tools import clear_cache as jcc
from gatb_core_tpu.tools import dbgcheck as jcheck
from gatb_core_tpu.tools import dbgtopology as jtopo
from gatb_core_tpu.tools import kmer_checksum as jsum
from gatb_core_tpu.tools import new_project as jnew
from gatb_core_tpu_torch.collections import containers as tcont
from gatb_core_tpu_torch.debruijn.graph import Graph as TGraph
from gatb_core_tpu_torch.tools import bank_download as tbd
from gatb_core_tpu_torch.tools import clear_cache as tcc
from gatb_core_tpu_torch.tools import dbgcheck as tcheck
from gatb_core_tpu_torch.tools import dbgtopology as ttopo
from gatb_core_tpu_torch.tools import kmer_checksum as tsum
from gatb_core_tpu_torch.tools import new_project as tnew

from test_torch_tail import _small_table


def _stats(stats):
    return {k: v for k, v in stats.items() if k != "time"}


@pytest.mark.parametrize("k,seed", [(15, 1), (31, 2), (33, 3), (63, 4)])
def test_check_graph(k, seed):
    vals, limbs, counts = _small_table(k, seed)
    jg = JGraph(k, limbs, counts)
    tg = TGraph(k, limbs, counts, device="cpu")
    got, want = tcheck.check_graph(tg), jcheck.check_graph(jg)
    assert list(got) == list(want)
    assert _stats(got) == _stats(want)
    assert isinstance(got["time"], float)
    assert want["nbBranching"] > 2 and want["nbSuccessors"] > len(vals)
    # the branching stage ran, as in JAX's tool
    assert np.array_equal(tg._branching, jg._branching)
    assert got["checksumBranching"] == tg.checksum_branching()
    words = (k + 31) // 32
    assert got["checkumNodes"] == jcheck.largeint_hex(sum(vals), words)
    if k == 31:   # the sums wrap mod 2^64
        assert sum(vals) >= 1 << 64
    assert np.array_equal(ttopo.topology_matrix(tg),
                          jtopo.topology_matrix(jg))
    assert ttopo.topology_matrix(tg).dtype == np.int64


def test_check_graph_empty_and_chunked(monkeypatch):
    """No node at all; then sweep chunks of 1000 nodes (a graph this small
    takes one chunk of at least 4096), so the sums cross chunks and the
    last chunk is partial."""
    from gatb_core_tpu_torch.ops import sortops

    empty = np.zeros((0, 2), np.uint32)
    none = np.zeros(0, np.int32)
    got = tcheck.check_graph(TGraph(31, empty, none, device="cpu"))
    assert _stats(got) == {
        "nbSolids": 0, "nbSuccessors": 0, "nbBranching": 0,
        "checkumNodes": "", "checksumSuccessors": "",
        "checksumBranching": "", "abundance": 0, "abundanceBranching": 0}
    vals, limbs, counts = _small_table(21, 6, length=1500)
    assert len(vals) % 1000
    want = _stats(jcheck.check_graph(JGraph(21, limbs, counts)))
    monkeypatch.setattr(sortops, "sweep_chunk", lambda n: 1000)
    tg = TGraph(21, limbs, counts, device="cpu")
    tg.precompute_adjacency()
    assert _stats(tcheck.check_graph(tg)) == want


def test_largeint_hex():
    for total, words in ((0, 1), (1 << 64, 1), ((1 << 64) + 5, 2),
                         (0xABC << 128, 3), (-1, 2)):
        assert tcheck.largeint_hex(total, words) == \
            jcheck.largeint_hex(total, words)


@pytest.fixture
def reads(tmp_path):
    rng = np.random.default_rng(8)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    path = tmp_path / "reads.fa"
    with open(path, "w") as f:
        for i in range(0, 2900, 4):
            read = genome[i:i + 100]
            if i % 40 == 0:          # an error: a bulge or a tip
                read = read[:50] + "ACGT"[("ACGT".index(read[50]) + 1) % 4] \
                    + read[51:]
            f.write(f">r{i}\n{read}\n")
    return str(path)


def test_clis_print_the_same_blocks(reads, monkeypatch, capsys):
    """dbgcheck and dbgtopology on a reads file: the port's printed blocks
    (its graph built on the CPU) equal JAX's, bar the time line. JAX's
    tools get a JAX Graph over the port's solid table in place of their
    own count (JAX's create takes 8-18 s here; the two packages' counts
    are held equal by tests/test_torch_dbgh5.py)."""
    orig = TGraph.create.__func__
    made = []

    def create(cls, *a, **kw):
        made.append(orig(cls, *a, device="cpu", **kw))
        return made[-1]

    monkeypatch.setattr(TGraph, "create", classmethod(create))
    monkeypatch.setattr(JGraph, "create", classmethod(
        lambda cls, *a, **kw: cls(made[-1].kmer_size, made[-1].solid_limbs,
                                  made[-1].solid_counts)))
    args = ["-in", reads, "-kmer-size", "21", "-abundance-min", "2"]
    out = {}
    for name, mod in (("t", tcheck), ("j", jcheck), ("tt", ttopo),
                      ("jt", jtopo)):
        assert mod.main(args) == 0
        out[name] = [line for line in capsys.readouterr().out.splitlines()
                     if not line.startswith("time ")]
    assert out["t"] == out["j"]
    assert out["tt"] == out["jt"]
    assert made[0].kmer_size == 21 and made[0].nb_nodes > 2900
    assert any(line.startswith("nbBranching") and not line.endswith(" 0  ")
               for line in out["t"])
    assert out["tt"][-1].startswith("branching (in!=1 or out!=1): ")


@pytest.mark.parametrize("words", [1, 2])
@pytest.mark.parametrize("dump", [False, True])
def test_kmer_checksum(tmp_path, capsys, words, dump):
    rng = np.random.default_rng(words)
    vals = [int(x) for x in rng.integers(-(1 << 63), 1 << 63, 301 * words)]
    vals += [0, -1]                       # a zero word, an all-ones word
    if words == 2:
        vals.append(7)                    # a trailing half value is dropped
    path = str(tmp_path / "kmers.bin")
    with tcont.BagFile(path) as bag:
        for v in vals:
            bag.insert(v)
    argv = [path] + (["dump"] if dump else []) + ["--words", str(words)]
    assert tsum.main(argv) == 0
    got = capsys.readouterr().out
    assert jsum.main(argv) == 0
    assert got == capsys.readouterr().out
    n = len(vals) // words
    assert got.splitlines()[-1].startswith(f"FOUND {n} WITH CHECKSUM ")
    assert len(got.splitlines()) == (n + 1 if dump else 1)


def test_clear(capsys):
    for n_bytes, chunk in ((3 << 20, 1), ((5 << 20) + 12345, 2)):
        assert tcc.clear(n_bytes, chunk_mb=chunk, verbose=False) == \
            jcc.clear(n_bytes, chunk_mb=chunk, verbose=False) == n_bytes
    tcc.clear(1 << 20, chunk_mb=1, verbose=True)
    assert "clear cache" in capsys.readouterr().err


def _project(path):
    out = {}
    for root, _, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            with open(full) as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


@pytest.mark.parametrize("name,nb_tools", [("my-tool", 1), ("Big_Tool", 3)])
def test_new_project_tree(tmp_path, capsys, name, nb_tools):
    """The same tree and text, once the package names are swapped."""
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    jp = jnew.create_project(str(tmp_path / "j"), name, nb_tools)
    assert tnew.main(["-d", str(tmp_path / "t"), "-n", name, "-t",
                      str(nb_tools)]) == str(tmp_path / "t" / name)
    assert capsys.readouterr().out == f"created {tmp_path / 't' / name}\n"
    jtree, ttree = _project(jp), _project(str(tmp_path / "t" / name))
    assert sorted(ttree) == sorted(jtree)
    assert len(ttree) == 2 + 2 * nb_tools
    for rel, text in jtree.items():
        assert ttree[rel] == text.replace("gatb_core_tpu",
                                          "gatb_core_tpu_torch"), rel
    assert any("import gatb_core_tpu_torch" in t or
               "from gatb_core_tpu_torch" in t for t in ttree.values())
    with pytest.raises(FileExistsError):
        tnew.create_project(str(tmp_path / "t"), name, nb_tools)


def test_bank_download_file_url(tmp_path, capsys):
    src = tmp_path / "src" / "mini.fa.gz"
    os.makedirs(src.parent)
    with gzip.open(src, "wt") as f:
        f.write(">a\nACGTACGT\n>b\nGGGTTT\n>c\nAC\nGT\n")
    out = {}
    for p, mod in (("j", jbd), ("t", tbd)):
        os.makedirs(tmp_path / p)
        dest = mod.download(src.as_uri(), str(tmp_path / p))
        assert dest == str(tmp_path / p / "mini.fa")
        out[p] = (open(dest).read(), mod.annotate(dest))
    assert out["t"] == out["j"]
    assert out["t"][1] == {"sequences": 3, "total_nt": 18, "max_len": 8}
    # the CLI on a plain file, into a folder of its own
    os.makedirs(tmp_path / "cli")
    plain = tmp_path / "j" / "mini.fa"
    assert tbd.main(["-url", plain.as_uri(), "-out",
                     str(tmp_path / "cli")]) == 0
    assert capsys.readouterr().out.startswith(
        f"{tmp_path / 'cli' / 'mini.fa'}: {{'sequences': 3")
    missing = (tmp_path / "none.fa").as_uri()
    for mod in (jbd, tbd):
        with pytest.raises(RuntimeError, match="download failed"):
            mod.download(missing, str(tmp_path / "t"))
        with pytest.raises(SystemExit):
            mod.main(["-url", missing, "-out", str(tmp_path / "t")])
    assert not os.path.exists(tmp_path / "t" / "none.fa.part")

"""gatb_core_tpu_torch dbgh5 against the JAX package's: the two tools build
the graph of a bank the test writes and their ``.h5`` files must hold the
same datasets (``/dsk/solid``, the histogram, ``/minimizers``, and with the
postsolid stages on ``/mphf``, ``/dsk/mphf``, ``/bloom``, ``/debloom``,
``/adjacency``, ``/branching``) and the same configuration and state
attributes (times and paths left out), at k=31 and k=63; the KFF files must
be equal byte for byte; each package's ``Graph.load`` reads the other's
file, and ``dbginfo`` prints the same text. The port runs on the CPU here
(``device="cpu"`` handed to ``Graph.create`` and ``Graph.load``).
"""

import os

import h5py
import numpy as np
import pytest

from gatb_core_tpu.storage import hdf5 as jh5
from gatb_core_tpu.tools import dbgh5 as jdbgh5
from gatb_core_tpu_torch.debruijn.graph import Graph
from gatb_core_tpu_torch.storage import hdf5 as th5
from gatb_core_tpu_torch.storage.kff import read_kff, write_kff
from gatb_core_tpu_torch.tools import dbgh5 as tdbgh5

NONE = ["-bloom", "none", "-debloom", "none", "-mphf", "none",
        "-branching-nodes", "none"]
# -max-memory 1 sizes the superbatch at its 2^16-row floor: the default
# plan sorts 2^25 rows a step, far too many for a CPU test
SMALL = ["-max-memory", "1"]
# attributes that differ by design: wall times, and JAX's compile counter
VOLATILE = ("time", "xml", "nb_device_programs", "exec")


@pytest.fixture
def bank(tmp_path):
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), size=4000))
    path = tmp_path / "reads.fa"
    with open(path, "w") as f:
        for i in range(0, 3900, 5):
            f.write(f">r{i}\n{genome[i:i + 100]}\n")
        f.write(">withN\n" + genome[:60] + "N" + genome[61:150] + "\n")
    return str(path)


@pytest.fixture
def on_cpu(monkeypatch):
    """The port's dbgh5 builds its graph on the CPU."""
    orig = Graph.create.__func__
    monkeypatch.setattr(
        Graph, "create",
        classmethod(lambda cls, **kw: orig(cls, device="cpu", **kw)))


def _walk(group, out, prefix=""):
    for key in group:
        if isinstance(group[key], h5py.Group):
            _walk(group[key], out, prefix + key + "/")
        else:
            out[prefix + key] = group[key][...]
    out[prefix + "@"] = {
        k: (v.tolist() if hasattr(v, "tolist") else v)
        for k, v in group.attrs.items()
        if not any(word in k for word in VOLATILE)}


def _contents(path):
    out = {}
    with h5py.File(path, "r") as f:
        _walk(f, out)
    return out


@pytest.mark.parametrize("k", [31, 63])
def test_dbgh5_h5_and_kff_equal_jax(k, bank, tmp_path, on_cpu,
                                    monkeypatch):
    monkeypatch.chdir(tmp_path)
    flags = ["-in", bank, "-kmer-size", str(k), "-abundance-min", "3",
             "-verbose", "0", "-kff"] + NONE + SMALL
    assert jdbgh5.main(flags + ["-out", "jax.h5"]) == 0
    os.rename("reads.fa.kff", "jax.kff")
    assert tdbgh5.main(flags + ["-out", "port.h5"]) == 0
    with open("jax.kff", "rb") as a, open("reads.fa.kff", "rb") as b:
        assert a.read() == b.read()
    j, t = _contents("jax.h5"), _contents("port.h5")
    assert sorted(j) == sorted(t)
    assert {"dsk/solid", "histogram/histogram", "histogram/cutoff",
            "minimizers/minimRepart"} <= set(j)
    for key in j:
        if key.endswith("@"):
            assert j[key] == t[key], key
        else:
            assert j[key].dtype == t[key].dtype, key
            assert np.array_equal(j[key], t[key]), key
    assert len(j["dsk/solid"]) > 3000
    # the port reads its own file back, and the KFF entries are the table
    with th5.Storage("port.h5", "r") as st:
        limbs, counts = th5.load_solid(st)
        assert th5.prop_int(st, "kmer_size") == k
        assert st.check_state(th5.STATE_SORTING_COUNT_DONE)
        assert st.check_state(th5.STATE_CONFIGURATION_DONE)
        assert not st.check_state(th5.STATE_MPHF_DONE)
    kk, entries, _ = read_kff("reads.fa.kff")
    assert kk == k and len(entries) == len(counts)
    assert [c for _, c in entries] == counts.tolist()
    write_kff("again.kff", limbs, counts, k)
    with open("again.kff", "rb") as a, open("jax.kff", "rb") as b:
        assert a.read() == b.read()


def _same_files(a, b):
    j, t = _contents(a), _contents(b)
    assert sorted(j) == sorted(t)
    for key in j:
        if key.endswith("@"):
            assert j[key] == t[key], key
        else:
            assert j[key].dtype == t[key].dtype, key
            assert np.array_equal(j[key], t[key]), key
    return j


def _bloom_fields(b):
    """Of either package's BloomFilter."""
    return (b.to_numpy().tolist(), b.size_bits, b.n_hash, b.user_seed,
            b.kind, b.kmer_size)


@pytest.mark.parametrize("k,bloom,debloom", [
    (31, "neighbor", "cascading"), (63, "neighbor", "cascading"),
    (31, "neighbor", "original"), (31, "cache", "cascading"),
    (31, "cache", "original"), (31, "basic", "cascading"),
    (31, "basic", "original")])
def test_dbgh5_postsolid_h5_equal_jax(k, bloom, debloom, bank, tmp_path,
                                      on_cpu, monkeypatch):
    """``-mphf none`` and otherwise the flags given (the first two cases
    are the tool's defaults): every group of the two files equal, and each
    package's loaders read the other's file."""
    monkeypatch.chdir(tmp_path)
    flags = ["-in", bank, "-kmer-size", str(k), "-abundance-min", "3",
             "-verbose", "0", "-mphf", "none"] + SMALL
    if (bloom, debloom) != ("neighbor", "cascading"):
        flags += ["-bloom", bloom, "-debloom", debloom]
    assert jdbgh5.main(flags + ["-out", "jax.h5"]) == 0
    assert tdbgh5.main(flags + ["-out", "port.h5"]) == 0
    j = _same_files("jax.h5", "port.h5")
    assert {"bloom/bloom", "debloom/cfp", "debloom/cfp_all",
            "adjacency/masks", "branching/nodes"} <= set(j)
    assert j["bloom/bloom"].dtype == np.uint32
    assert j["bloom/@"]["kind"] == bloom and j["debloom/@"]["nb_cfp"] > 0
    assert j["debloom/@"]["kind"] == debloom
    assert ("debloom/cascading/t4" in j) == (debloom == "cascading")
    assert j["adjacency/masks"].dtype == np.uint8
    assert {"nb_branching", "checksum_branching"} <= set(j["branching/@"])
    w = (2 * k + 31) // 32
    for path in ("jax.h5", "port.h5"):
        with th5.Storage(path, "r") as st:
            for bit in (th5.STATE_BLOOM_DONE, th5.STATE_DEBLOOM_DONE,
                        th5.STATE_BRANCHING_DONE, th5.STATE_ADJACENCY_DONE):
                assert st.check_state(bit)
            assert not st.check_state(th5.STATE_MPHF_DONE)
            tb = th5.load_bloom(st, device="cpu")
            tc = th5.load_debloom(st, w)
            groups = [th5.load_bloom_group(
                st.group("debloom").group("cascading").group(f"bloom{i}"),
                device="cpu") for i in (2, 3, 4)] \
                if debloom == "cascading" else []
        with jh5.Storage(path, "r") as st:
            jb = jh5.load_bloom(st)
            jc = jh5.load_debloom(st, w)
            jgroups = [jh5.load_bloom_group(
                st.group("debloom").group("cascading").group(f"bloom{i}"))
                for i in (2, 3, 4)] if debloom == "cascading" else []
        assert tb.words.device.type == "cpu"
        assert _bloom_fields(tb) == _bloom_fields(jb)
        assert tc.dtype == jc.dtype and np.array_equal(tc, jc)
        assert len(tc) == j["debloom/@"]["nb_cfp"]
        assert [_bloom_fields(b) for b in groups] == \
            [_bloom_fields(b) for b in jgroups]


def test_dbgh5_default_stages_raise_until_ported(bank, tmp_path, on_cpu,
                                                 monkeypatch):
    """The reference's flag defaults run every stage, the MPHF with them
    (the run raised NotImplementedError until the MPHF was ported; the
    name stays): the port's file and props equal JAX's with those flags,
    ``-mphf emphf`` builds the same BooPHF, and ``-check`` compares the
    branching keys."""
    monkeypatch.chdir(tmp_path)
    base = ["-in", bank, "-kmer-size", "31", "-verbose", "0"] + SMALL
    assert jdbgh5.main(base + ["-out", "j.h5", "-check-dump", "j.props"]) \
        == 0
    assert tdbgh5.main(base + ["-out", "x.h5", "-check-dump", "x.props"]) \
        == 0
    j = _same_files("j.h5", "x.h5")
    assert {"mphf/bits", "mphf/perm", "dsk/mphf"} <= set(j)
    assert tdbgh5.main(base + ["-mphf", "emphf", "-out", "e.h5"]) == 0
    e = _contents("e.h5")
    for key in j:
        if key.startswith("mphf/") and not key.endswith("@"):
            assert np.array_equal(e[key], j[key]), key
    with open("x.props") as f:
        props = dict(line.split(None, 1) for line in f if " " in line)
    with open("j.props") as f:
        jprops = dict(line.split(None, 1) for line in f if " " in line)
    assert int(props["nb_branching"]) > 0 and props["checksum_branching"]
    assert "postsolid_time" in props and int(props["nb_cfp"]) > 0
    assert "postsolid_time.mphf" in props
    for key in ("nb_branching", "checksum_branching", "nb_cfp",
                "kmers_nb_solid", "debloom_kind"):
        assert props[key] == jprops[key], key
    # -check compares the branching keys too
    assert tdbgh5.main(base + ["-mphf", "none", "-check", "x.props"]) == 0
    with open("x.props") as f:
        lines = [("nb_branching 1\n" if line.startswith("nb_branching ")
                  else line) for line in f]
    with open("y.props", "w") as f:
        f.writelines(lines)
    assert tdbgh5.main(base + ["-mphf", "none", "-check", "y.props"]) == 1


@pytest.fixture(scope="module", params=[31, 63])
def default_files(request, tmp_path_factory):
    """JAX's and the port's dbgh5 with the default flags on one bank:
    (k, directory holding jax.h5 and port.h5)."""
    k = request.param
    d = tmp_path_factory.mktemp(f"default{k}")
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), size=4000))
    with open(d / "reads.fa", "w") as f:
        for i in range(0, 3900, 5):
            f.write(f">r{i}\n{genome[i:i + 100]}\n")
    flags = ["-in", str(d / "reads.fa"), "-kmer-size", str(k),
             "-abundance-min", "3", "-verbose", "0"] + SMALL
    orig = Graph.create.__func__
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        mp.setattr(Graph, "create", classmethod(
            lambda cls, **kw: orig(cls, device="cpu", **kw)))
        assert jdbgh5.main(flags + ["-out", "jax.h5"]) == 0
        assert tdbgh5.main(flags + ["-out", "port.h5"]) == 0
    return k, d


def test_dbgh5_default_flags_h5_equal_jax(default_files):
    """Every dataset and attribute of the two files equal, /mphf/* and
    the reference stream /dsk/mphf byte for byte."""
    k, d = default_files
    j = _same_files(str(d / "jax.h5"), str(d / "port.h5"))
    for key in ("mphf/bits", "mphf/prefix", "mphf/perm", "mphf/abundance",
                "mphf/fallback_keys", "mphf/fallback_ranks", "dsk/mphf",
                "bloom/bloom", "debloom/cascading/t4", "branching/nodes"):
        assert key in j, key
    assert j["dsk/mphf"].dtype == np.uint8 and len(j["dsk/mphf"]) > 1000
    assert j["mphf/@"]["n"] == len(j["dsk/solid"])
    with h5py.File(d / "port.h5", "r") as f:
        state = int(f.attrs["state"])
    assert state & th5.STATE_MPHF_DONE


def _ref_layout(src, dst):
    """A copy of a file in the reference's layout: no /mphf encoding (only
    the /dsk/mphf stream) and the cascade blooms as raw /debloom/bloom{2,3,4}
    datasets with string attributes, /debloom/cfp holding T4."""
    import shutil

    shutil.copy(src, dst)
    with h5py.File(dst, "a") as f:
        for name in ("bits", "prefix", "perm", "fallback_keys",
                     "fallback_ranks"):
            del f["mphf"][name]
        g = f["debloom"]
        for i in (2, 3, 4):
            cg = g["cascading"][f"bloom{i}"]
            ds = g.create_dataset(f"bloom{i}",
                                  data=cg["bloom"][...].view(np.uint8))
            for attr, key in (("size", "size_bits"), ("nb_hash", "nb_hash"),
                              ("type", "kind"), ("kmer_size", "kmer_size")):
                ds.attrs[attr] = np.array([str(cg.attrs[key]).encode()],
                                          dtype=h5py.string_dtype())
        del g["cascading"]
        del g["cfp_all"]


def test_graph_load_reads_either_packages_file(default_files, tmp_path):
    """Each package's Graph.load opens the other's file (and a copy in the
    reference's layout) and answers contains, node_index, query_abundance
    and branching_nodes alike. The port loads the BooPHF of /mphf onto the
    device; from a reference-layout file it loads none (JAX adapts the
    /dsk/mphf stream on the host) and answers through the rank search."""
    from gatb_core_tpu.collections.boophf_ref import RefMPHFAdapter as JAd
    from gatb_core_tpu.debruijn.graph import Graph as JGraph
    from gatb_core_tpu_torch.collections.boophf import BooPHF
    from gatb_core_tpu_torch.convert import boophf_to_numpy, u32_to_torch

    k, d = default_files
    ref = str(tmp_path / "ref.h5")
    _ref_layout(str(d / "jax.h5"), ref)
    for path in (str(d / "jax.h5"), str(d / "port.h5"), ref):
        tg = Graph.load(path, device="cpu")
        jg = JGraph.load(path)
        if path == ref:
            assert tg._mphf is None
            assert isinstance(jg._mphf, JAd)
        else:
            assert isinstance(tg._mphf, BooPHF)
            got = boophf_to_numpy(tg._mphf)
            for f in ("bits", "prefix", "perm", "fallback_keys"):
                assert np.array_equal(got[f], np.asarray(
                    getattr(jg._mphf, f))), f
            assert np.array_equal(tg._mphf.rank(u32_to_torch(
                tg.solid_limbs, "cpu")).numpy(), np.arange(tg.nb_nodes))
        assert tg._debloom.kind == jg._debloom.kind == "cascading"
        assert np.array_equal(tg.solid_limbs, jg.solid_limbs)
        assert np.array_equal(tg.abundance_codes, jg.abundance_codes)
        assert np.array_equal(tg._adjacency, jg._adjacency)
        assert np.array_equal(tg.branching_nodes(), jg.branching_nodes())
        assert np.array_equal(tg._branching_counts, jg._branching_counts)
        absent = tg.solid_limbs.copy()
        absent[:, -1] ^= 1
        q = np.concatenate([tg.solid_limbs, absent, jg._debloom.cfp])
        for mode in ("exact", "bloom_cfp"):
            assert np.array_equal(tg.contains(q, mode=mode),
                                  jg.contains(q, mode=mode))
        assert np.array_equal(tg.node_index(q), jg.node_index(q))
        assert np.array_equal(tg.query_abundance(q), jg.query_abundance(q))
        assert (tg.node_index(tg.solid_limbs) == np.arange(tg.nb_nodes)).all()
        tg.storage.close()
        jg.storage.close()


def test_dbginfo_text_equal_jax(default_files, capsys):
    from gatb_core_tpu.tools import dbginfo as jinfo
    from gatb_core_tpu_torch.tools import dbginfo as tinfo

    k, d = default_files
    for name in ("jax.h5", "port.h5"):
        path = str(d / name)
        assert jinfo.main(["-in", path]) == 0
        want = capsys.readouterr().out
        assert tinfo.main(["-in", path]) == 0
        got = capsys.readouterr().out
        assert got == want and f"kmer_size    : {k}" in got
        assert "MPHF_DONE" in got and "checksum_branching" in got


def test_dbgh5_check_dump_and_tool_contract(bank, tmp_path, on_cpu,
                                            monkeypatch):
    monkeypatch.chdir(tmp_path)
    flags = ["-in", bank, "-kmer-size", "21", "-abundance-min", "auto",
             "-verbose", "0", "-nb-passes", "2", "-out", "p.h5",
             "-check-dump", "p.props"] + NONE + SMALL
    assert tdbgh5.main(flags) == 0
    assert tdbgh5.main(flags + ["-check", "p.props"]) == 0
    with open("p.props") as f:
        props = dict(line.split(None, 1) for line in f if " " in line)
    assert int(props["kmers_nb_solid"]) > 0
    tool = tdbgh5.Dbgh5Tool()
    assert tool.execute(flags) == 0 and tool.info["rc"] == 0


def test_graph_create_without_output_and_plan(bank):
    from gatb_core_tpu_torch.debruijn.graph import _plan_partitions
    from gatb_core_tpu_torch.kmer.configuration import compute_plan

    g = Graph.create(bank=bank, kmer_size=31, abundance_min=3,
                     bloom_kind="none", debloom_kind="none",
                     mphf_kind="none", build_branching=False,
                     superbatch_rows=1 << 14, device="cpu")
    assert g.storage is None and g.nb_nodes == len(g.solid_counts) > 3000
    assert g.get_info()["nb_solid_kmers"] == g.nb_nodes
    assert g.abundance_codes.dtype == np.uint8
    assert _plan_partitions(bank, 31, 10) >= 1
    plan = compute_plan(1000, 100000, 100, 31)
    assert plan.nb_passes >= 1 and plan.get_properties()["kmer_size"] == 31

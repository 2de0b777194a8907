"""The port's host tail against the JAX package's, at tolerance 0:
bitpack's three codec names, ``collections.containers`` (the hash tables'
slots and order, the bags' file bytes), ``storage.filedir`` (the directory
tree and every ``.json`` and ``.data`` file for the same calls, in the
three file modes, and a graph's postsolid stages written through it by
each package) and ``system.info`` (the keys, bar the ones ROADMAP C
names as deliberate differences).
"""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatb_core_tpu.collections import containers as jcont
from gatb_core_tpu.debruijn.graph import Graph as JGraph
from gatb_core_tpu.ops import bitpack as jbit
from gatb_core_tpu.storage import filedir as jfd
from gatb_core_tpu.storage import hdf5 as jh5
from gatb_core_tpu.system import info as jinfo
from gatb_core_tpu_torch.collections import containers as tcont
from gatb_core_tpu_torch.debruijn.graph import Graph as TGraph
from gatb_core_tpu_torch.ops import bitpack as tbit
from gatb_core_tpu_torch.ops.kmer_ops import py_to_limbs
from gatb_core_tpu_torch.storage import filedir as tfd
from gatb_core_tpu_torch.storage import hdf5 as th5
from gatb_core_tpu_torch.system import info as tinfo

# ---------------------------------------------------------------------------
# ops/bitpack
# ---------------------------------------------------------------------------


def test_ascii_to_codes_every_byte():
    buf = np.arange(256, dtype=np.uint8)
    jc, jv = jbit.ascii_to_codes(jnp.asarray(buf))
    tc, tv = tbit.ascii_to_codes(torch.from_numpy(buf))
    assert tc.dtype == torch.uint8 and tv.dtype == torch.bool
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert tv.sum() == 8        # ACGTacgt
    # any integer dtype is read as its low byte, as in JAX
    wide = torch.from_numpy(buf.astype(np.int32) + 256)
    assert torch.equal(tbit.ascii_to_codes(wide)[0], tc)


@pytest.mark.parametrize("seed", [0, 1])
def test_string_codes_round_trip(seed):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACGTacgtNnRY-"), size=300))
    tc, tv = tbit.string_to_codes(seq)
    jc, jv = jbit.string_to_codes(seq)
    assert np.array_equal(tc, jc) and np.array_equal(tv, jv)
    assert tc.dtype == jc.dtype and tv.dtype == jv.dtype
    assert tbit.codes_to_string(tc) == jbit.codes_to_string(jc)
    clean = "".join(rng.choice(list("ACGT"), size=64))
    assert tbit.codes_to_string(tbit.string_to_codes(clean)[0]) == clean


# ---------------------------------------------------------------------------
# collections/containers
# ---------------------------------------------------------------------------


def _keys(n, seed, hi=1 << 62):
    rng = np.random.default_rng(seed)
    keys = [int(x) for x in rng.integers(0, hi, size=n)]
    return keys + keys[: n // 3]          # repeats increment


def test_oahash_slots_and_items():
    keys = _keys(300, 1)
    j, t = jcont.OAHash(300), tcont.OAHash(300)
    for i, key in enumerate(keys):
        j.increment(key, 1 + i % 3)
        t.increment(key, 1 + i % 3)
    assert t.capacity == j.capacity and t.nb_items == j.nb_items
    assert np.array_equal(t.keys, j.keys)
    assert np.array_equal(t.values, j.values)
    assert list(t.items()) == list(j.items())
    for key in keys[:20] + [5, 7]:
        assert t.get(key) == j.get(key)
        assert (key in t) == (key in j)
    assert all(tcont.OAHash._oahash64(k) == jcont.OAHash._oahash64(k)
               for k in keys[:50] + [0, (1 << 64) - 1, -1])


def test_oahash_full():
    for mod in (jcont, tcont):
        h = mod.OAHash(4)                  # capacity 8
        for key in range(8):
            h.increment(key)
        with pytest.raises(RuntimeError):
            h.increment(100)


def test_hash16_growth_and_sorted_items():
    keys = _keys(3000, 2)
    j, t = jcont.Hash16(initial_capacity=16), \
        tcont.Hash16(initial_capacity=16)
    for i, key in enumerate(keys):
        j.insert(key, i % 5)
        t.insert(key, i % 5)
        if i in (10, 500):
            assert np.array_equal(t._keys, j._keys)
    assert len(t._keys) == len(j._keys) > 16       # grew
    assert np.array_equal(t._keys, j._keys)
    assert np.array_equal(t._vals, j._vals)
    assert t.nb_items == j.nb_items
    assert list(t.sorted_items()) == list(j.sorted_items())
    assert [t.get(k) for k in keys[:30] + [3]] == \
        [j.get(k) for k in keys[:30] + [3]]
    t.clear()
    j.clear()
    assert t.nb_items == j.nb_items == 0 and list(t.sorted_items()) == []


def test_hash16_is_full():
    for mod in (jcont, tcont):
        h = mod.Hash16(max_memory_mb=1, initial_capacity=1 << 17)
        assert h._max_items == 65536
        for key in range(65535):
            h.insert(key)
        assert not h.is_full
        h.insert(70000)
        assert h.is_full
        assert not mod.Hash16().is_full


def test_container_set():
    vals = _keys(50, 3)
    j, t = jcont.ContainerSet(vals), tcont.ContainerSet(vals)
    assert t.values == j.values and len(t) == len(j)
    for v in vals[:10] + [-1, 1 << 63]:
        assert (v in t) == (v in j) and t.contains(v) == j.contains(v)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_bags_bytes_and_iterator(tmp_path):
    vals = [v - (1 << 62) for v in _keys(40000, 4, hi=1 << 63)]
    paths = {}
    for name, mod in (("j", jcont), ("t", tcont)):
        path = str(tmp_path / f"{name}.bag")
        with mod.BagFile(path) as bag:
            for v in vals[:10]:
                bag.insert(v)
            cache = mod.BagCache(bag, cache_size=1000)
            for v in vals[10:]:
                cache.insert(v)
            cache.flush()
        part = mod.BagPartition(str(tmp_path / f"{name}_part"), 3,
                                cache_size=7)
        for i, v in enumerate(vals[:100]):
            part.insert(i % 3, v)
        part.close()
        paths[name] = (path, part)
    assert _read(paths["t"][0]) == _read(paths["j"][0])
    for i in range(3):
        fj = os.path.join(paths["j"][1].directory, f"part_{i}")
        ft = os.path.join(paths["t"][1].directory, f"part_{i}")
        assert _read(ft) == _read(fj)
        assert list(paths["t"][1].iterator(i)) == vals[i:100:3]
    # each package's iterator reads the other's file
    assert list(tcont.IteratorFile(paths["j"][0])) == vals
    assert list(jcont.IteratorFile(paths["t"][0])) == vals


# ---------------------------------------------------------------------------
# storage/filedir
# ---------------------------------------------------------------------------


def _tree(folder):
    """{relative path: bytes}, gzip members decompressed (their header
    holds the write time)."""
    out = {}
    for name in sorted(os.listdir(folder)):
        raw = _read(os.path.join(folder, name))
        if raw[:2] == b"\x1f\x8b":
            raw = gzip.decompress(raw)
        out[name] = raw
    return out


def _storage_calls(mod, h5, name, mode):
    st = mod.StorageFactory.create(name, mode=mode, file_mode="w")
    g = st.group("dsk")
    g.set_dataset("solid", np.arange(100, dtype=np.uint64).reshape(25, 4))
    rec = np.zeros(5, dtype=h5.count_dtype(2))
    rec["value"] = np.arange(10).reshape(5, 2)
    rec["abundance"] = np.arange(5) - 2
    g.set_dataset("records", rec)
    g.set_dataset("empty", np.zeros((0, 3), np.uint32))
    g.set_property("nb", np.uint64(25))
    g.set_property("sizes", np.asarray([3, 4], np.uint64))
    g.set_property("ratio", np.float32(0.5))
    sub = g.group("inner")
    sub.set_property("note", "deep")
    with sub.ostream("blob") as s:
        s.write(b"hello ")
        s.write(b"bytes")
    st.set_state_bit(h5.STATE_SORTING_COUNT_DONE)
    st.set_state_bit(h5.STATE_BLOOM_DONE)
    st.group("histogram").set_dataset("cutoff", np.asarray([3], np.uint64))
    return st


@pytest.mark.parametrize("mode", ["file", "gzfile", "compressed-file"])
def test_file_storage_equal_files(tmp_path, mode):
    name = {p: str(tmp_path / p / "store") for p in "jt"}
    for p in "jt":
        os.makedirs(tmp_path / p)
    _storage_calls(jfd, jh5, name["j"], mode)
    st = _storage_calls(tfd, th5, name["t"], mode)
    assert isinstance(st, tfd.FileStorage) and st.compressed == (
        mode != "file")
    tj, tt = _tree(name["j"] + "_gatb"), _tree(name["t"] + "_gatb")
    assert sorted(tt) == sorted(tj) and tt == tj
    # reopened in mode "a": every read equal, each package reads the other's
    for opener in (jfd, tfd):
        for p in "jt":
            ro = opener.StorageFactory.create(name[p], mode=mode)
            g = ro.group("dsk")
            assert np.array_equal(g.get_dataset("solid"),
                                  np.arange(100, dtype=np.uint64)
                                  .reshape(25, 4))
            rec = g.get_dataset("records")
            assert rec.dtype == th5.count_dtype(2)
            assert rec["abundance"].tolist() == [-2, -1, 0, 1, 2]
            assert g.get_dataset("empty").shape == (0, 3)
            assert g.get_dataset("missing") is None
            assert g.get_property("sizes") == [3, 4]
            assert g.get_property("ratio") == 0.5
            assert g.group("inner").istream("blob").read() == b"hello bytes"
            assert ro.get_state() == (th5.STATE_SORTING_COUNT_DONE
                                      | th5.STATE_BLOOM_DONE)
            assert ro.check_state(th5.STATE_BLOOM_DONE)
            assert not ro.check_state(th5.STATE_MPHF_DONE)
    # __contains__ sees datasets only, not subgroups, in both packages
    for mod in (jfd, tfd):
        g = mod.FileStorage(name["t"]).group("dsk")
        assert "solid" in g and "records" in g and "missing" not in g
        assert "inner" not in g
        assert "blob" in g.group("inner")
        assert mod.StorageFactory.exists(name["t"], mode)
        assert not mod.StorageFactory.exists(name["t"] + "x", mode)
    # mode "w" starts the folder again; a name ending in _gatb is kept
    fresh = tfd.FileStorage(name["t"] + "_gatb/", "w")
    assert fresh.folder == name["t"] + "_gatb/"
    assert os.listdir(fresh.folder) == []


def test_storage_factory_modes(tmp_path):
    h5 = str(tmp_path / "g.h5")
    st = tfd.StorageFactory.create(h5, mode="hdf5", file_mode="w")
    assert isinstance(st, th5.Storage)
    st.close()
    for mod in (jfd, tfd):
        assert mod.StorageFactory.MODES == jfd.StorageFactory.MODES
        assert mod.StorageFactory.exists(h5, "hdf5")
        with pytest.raises(ValueError, match="unknown storage mode"):
            mod.StorageFactory.create(str(tmp_path / "x"), mode="nope")


def _small_table(k, seed, length=700):
    """A sorted canonical table of a genome and two mutated copies (so the
    graph branches), with random counts."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, length)
    seqs = [genome]
    for _ in range(2):
        copy = genome.copy()
        pos = rng.choice(length, 6, replace=False)
        copy[pos] = (copy[pos] + 1) % 4
        seqs.append(copy)
    vals = set()
    mask = (1 << (2 * k)) - 1
    for s in seqs:
        f = r = 0
        for i, c in enumerate(int(x) for x in s):
            f = ((f << 2) | c) & mask
            r = (r >> 2) | ((c ^ 2) << (2 * k - 2))
            if i >= k - 1:
                vals.add(min(f, r))
    vals = sorted(vals)
    counts = rng.integers(1, 1 << 31, len(vals)).astype(np.int32)
    return vals, np.asarray(py_to_limbs(vals, k), np.uint32), counts


# property values that are wall times (Graph.info's postsolid_time.* and
# the configuration's xml dump of them)
TIME_VALUED = ("xml",)


def test_graph_stages_through_file_storage(tmp_path):
    """The postsolid stages of one table, written by a JAX Graph and a
    port Graph (on the CPU) through each package's FileStorage: every
    .data file byte-equal, every property equal bar the time-valued
    ones."""
    _, limbs, counts = _small_table(31, 5)
    names = {}
    for p, graph_cls, fd, h5, kw in (
            ("j", JGraph, jfd, jh5, {}),
            ("t", TGraph, tfd, th5, {"device": "cpu"})):
        st = fd.FileStorage(str(tmp_path / p), "w")
        graph = graph_cls(31, limbs, counts, storage=st, **kw)
        graph.build_postsolid()
        h5.save_solid(st, graph.solid_limbs, graph.solid_counts, 31)
        h5.save_config(st, graph.info)
        names[p] = st.folder
    tj, tt = _tree(names["j"]), _tree(names["t"])
    assert sorted(tt) == sorted(tj)
    data = [n for n in tj if n.endswith(".data")]
    assert {"dsk.solid.data", "dsk.mphf.data", "bloom.bloom.data",
            "debloom.cfp.data", "debloom.cascading.t4.data",
            "adjacency.masks.data", "branching.nodes.data",
            "mphf.bits.data", "mphf.perm.data"} <= set(data)
    for n in data:
        assert tt[n] == tj[n], n
    import json

    for n in tj:
        if n.endswith(".json"):
            pj, pt = json.loads(tj[n]), json.loads(tt[n])
            assert sorted(pt) == sorted(pj), n
            assert {k: v for k, v in pt.items() if k not in TIME_VALUED} \
                == {k: v for k, v in pj.items() if k not in TIME_VALUED}, n
    assert jfd.FileStorage(names["t"][:-5]).check_state(
        jh5.STATE_MPHF_DONE | jh5.STATE_BRANCHING_DONE)


# ---------------------------------------------------------------------------
# system/info
# ---------------------------------------------------------------------------

# ROADMAP C: the keys where the port reports torch and CUDA, not JAX
DIFFERENT_KEYS = {"jax", "torch", "cuda", "devices", "version"}


def test_system_info_keys():
    jv, tv = jinfo.SystemInfo.version_info(), tinfo.SystemInfo.version_info()
    assert set(jv) - DIFFERENT_KEYS == set(tv) - DIFFERENT_KEYS
    assert {k: v for k, v in tv.items() if k not in DIFFERENT_KEYS} == \
        {k: v for k, v in jv.items() if k not in DIFFERENT_KEYS}
    assert tv["torch"] == torch.__version__
    assert tv["cuda"] == torch.version.cuda
    assert tv["devices"] == ([torch.cuda.get_device_name(i) for i in
                              range(torch.cuda.device_count())]
                             if torch.cuda.is_available() else [])
    jl, tl = jinfo.library_info(), tinfo.library_info()
    assert "devices" not in tl
    assert {k: v for k, v in tl.items() if k not in DIFFERENT_KEYS} == \
        {k: v for k, v in jl.items() if k not in DIFFERENT_KEYS}
    assert tl["version"] != jl["version"]
    jh, th = jinfo.host_info(), tinfo.host_info()
    assert sorted(th) == sorted(jh)
    assert {k: v for k, v in th.items() if k != "cmemory_used_mb"} == \
        {k: v for k, v in jh.items() if k != "cmemory_used_mb"}
    for name in ("nb_cores", "memory_physical_total_mb",
                 "memory_project_mb"):
        assert getattr(tinfo.SystemInfo, name)() == \
            getattr(jinfo.SystemInfo, name)()
    assert tinfo.SystemInfo.memory_self_used_mb() > 0
    assert tinfo.FileSystem.max_files_number() == \
        jinfo.FileSystem.max_files_number()
    assert abs(tinfo.FileSystem.available_space_mb(".")
               - jinfo.FileSystem.available_space_mb(".")) < 64
    path = tinfo.FileSystem.temp_filename("gatbtest")
    try:
        assert os.path.basename(path).startswith("gatbtest")
    finally:
        os.remove(path)

"""gatb_core_tpu_torch.debruijn.graph (node API, adjacency, branching,
the postsolid state machine) against the JAX package's Graph on the same
reads, and against a brute-force Python graph; integers throughout,
tolerance 0. Also the package surface and the rule that the port imports
neither jax nor gatb_core_tpu."""

import ast
import os

import numpy as np
import pytest
import torch

import gatb_core_tpu as jpkg
import gatb_core_tpu_torch as tpkg
from gatb_core_tpu.bank.fasta import BankStrings as JBank
from gatb_core_tpu.debruijn.graph import Graph as JGraph
from gatb_core_tpu.kmer.model import (canonical, count_kmers_py,
                                      kmer_to_string, revcomp,
                                      string_to_kmer)
from gatb_core_tpu_torch import BankStrings, Graph
from gatb_core_tpu_torch.debruijn import graph as tgraph
from gatb_core_tpu_torch.ops.kmer_ops import kmers_to_py, py_to_limbs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# keys of get_info() that differ by design: a JAX compile-cache metric
# there, the parser and the device here
ONLY_JAX = {"nb_device_programs"}
ONLY_PORT = {"parser", "device"}


def _reads(k, seed=None):
    rng = np.random.default_rng(k if seed is None else seed)
    genome = "".join(rng.choice(list("ACGT"), size=300))
    seqs = [genome[i:i + 2 * k + 10] for i in range(0, 300 - 2 * k - 9, k)]
    return seqs * 2


def _create(cls, bank, k, **kw):
    kw.setdefault("mphf_kind", "none")
    if cls is Graph:
        kw.update(device="cpu", superbatch_rows=1 << 13)
    return cls.create(bank, kmer_size=k, abundance_min=1, batch_reads=16,
                      batch_len=max(128, 3 * k), **kw)


def brute_force_graph(seqs, k):
    solid = set(count_kmers_py(seqs, k, abundance_min=1))
    mask = (1 << (2 * k)) - 1

    def neighbors(v):
        f = v
        out, inn = [], []
        for nt in range(4):
            if canonical(((f << 2) | nt) & mask, k) in solid:
                out.append(nt)
            if canonical((f >> 2) | (nt << (2 * (k - 1))), k) in solid:
                inn.append(nt)
        return out, inn

    return solid, neighbors


@pytest.fixture(scope="module", params=[11, 31, 63])
def pair(request):
    k = request.param
    seqs = _reads(k)
    return (k, seqs, _create(JGraph, JBank(*seqs), k),
            _create(Graph, BankStrings(*seqs), k))


def test_graph_matches_jax(pair):
    k, seqs, jg, tg = pair
    assert tg.nb_nodes == jg.nb_nodes and tg.kmer_size == k
    assert np.array_equal(tg.solid_limbs, jg.solid_limbs)
    assert np.array_equal(tg.solid_counts, jg.solid_counts)
    assert np.array_equal(tg.abundance_codes, jg.abundance_codes)
    assert tg._adjacency.dtype == np.uint8
    assert np.array_equal(tg._adjacency, jg._adjacency)
    assert np.array_equal(tg.branching_nodes(), jg.branching_nodes())
    assert np.array_equal(tg._branching_counts, jg._branching_counts)
    assert tg.checksum_branching() == jg.checksum_branching()
    absent = tg.solid_limbs.copy()
    absent[:, -1] ^= 1
    for q in (tg.solid_limbs, absent, tg.solid_limbs[3]):
        assert np.array_equal(tg.contains(q), jg.contains(q))
        assert np.array_equal(tg.node_index(q), jg.node_index(q))
        assert np.array_equal(tg.adjacency_masks(q), jg.adjacency_masks(q))
        assert np.array_equal(tg.out_degree(q), jg.out_degree(q))
        assert np.array_equal(tg.in_degree(q), jg.in_degree(q))
        assert np.array_equal(tg.query_abundance(q), jg.query_abundance(q))
        assert np.array_equal(tg.contains(q, mode="bloom_cfp"),
                              jg.contains(q, mode="bloom_cfp"))
    a, b = tg.neighbors(tg.solid_limbs[5]), jg.neighbors(jg.solid_limbs[5])
    for side in ("out", "in"):
        assert [x.tolist() for x in a[side]] == \
            [x.tolist() for x in b[side]]
        assert all(x.dtype == np.uint32 for x in a[side])
    chunks = list(tg.iter_nodes(chunk=50))
    assert sum(len(c[0]) for c in chunks) == tg.nb_nodes
    assert np.array_equal(np.concatenate([c[1] for c in chunks]),
                          jg.solid_counts)


def test_graph_matches_brute_force(pair):
    k, seqs, _, tg = pair
    solid, nbrs = brute_force_graph(seqs, k)
    vals = kmers_to_py(tg.solid_limbs)
    assert vals == sorted(solid)
    assert tg.contains(tg.solid_limbs).all()
    assert (tg.node_index(tg.solid_limbs) == np.arange(tg.nb_nodes)).all()
    masks = tg.adjacency_masks(tg.solid_limbs)
    branching = []
    for i, v in enumerate(vals):
        out, inn = nbrs(v)
        assert masks[i] == sum(1 << nt for nt in out) \
            + sum(1 << (4 + nt) for nt in inn), kmer_to_string(v, k)
        if len(out) != 1 or len(inn) != 1:
            branching.append(v)
    assert kmers_to_py(tg.branching_nodes()) == branching
    words = max(1, (k + 31) // 32)
    total = sum(branching) % (1 << (64 * words))
    ws = [f"{(total >> (64 * i)) & (2**64 - 1):x}"
          for i in range(words - 1, -1, -1)]
    while len(ws) > 1 and ws[0] == "0":
        ws.pop(0)
    assert tg.checksum_branching() == ".".join(ws)
    if 0 not in solid:
        absent = py_to_limbs([0], k)
        assert not tg.contains(absent)[0]
        assert tg.node_index(absent)[0] == -1
        assert tg.query_abundance(absent)[0] == 0


def test_get_info_key_sets_match_jax(pair):
    """The two packages report the same keys (values of the time keys are
    not compared), bar the differences listed above."""
    k, seqs, jg, tg = pair
    ji, ti = jg.get_info(), tg.get_info()
    assert set(ji) - set(ti) == ONLY_JAX
    assert set(ti) - set(ji) == ONLY_PORT
    for key in ("postsolid_time", "postsolid_time.debloom",
                "postsolid_time.branching", "postsolid_time.adjacency",
                "nb_branching", "checksum_branching", "nb_cfp",
                "debloom_kind", "bloom_size_bits"):
        assert key in ti, key
    for key in set(ji) & set(ti):
        if "time" not in key:
            assert ji[key] == ti[key], key


def test_postsolid_time_with_every_stage_off():
    seqs = _reads(15)
    off = dict(bloom_kind="none", debloom_kind="none", mphf_kind="none",
               build_branching=False)
    ti = _create(Graph, BankStrings(*seqs), 15, **off).get_info()
    ji = _create(JGraph, JBank(*seqs), 15, **off).get_info()
    assert ti["postsolid_time"] == 0 and "postsolid_time" in ji
    assert set(ji) - set(ti) == ONLY_JAX and set(ti) - set(ji) == ONLY_PORT
    assert "nb_branching" not in ti and "nb_cfp" not in ti
    # a bloom without debloom (or the reverse) runs neither, as in JAX
    g = _create(Graph, BankStrings(*seqs), 15, debloom_kind="none",
                build_branching=False)
    assert g._debloom is None and "nb_cfp" not in g.get_info()


def test_mphf_stage_still_raises():
    """The MPHF stage (it raised before it was ported; the name stays):
    'boophf' builds the BooPHF equal to JAX's array for array ('emphf'
    the same one) and ranking every node; node_index, query_abundance and
    the node-state maps answer as JAX's graph does through its MPHF, -1 on
    absent rows."""
    from gatb_core_tpu_torch.collections.boophf import BooPHF
    from gatb_core_tpu_torch.convert import boophf_to_numpy, u32_to_torch

    seqs = _reads(15, seed=4) + _reads(15, seed=5)
    tg = _create(Graph, BankStrings(*seqs), 15, mphf_kind="boophf")
    jg = _create(JGraph, JBank(*seqs), 15, mphf_kind="boophf")
    assert isinstance(tg._mphf, BooPHF) and tg._mphf.bits.device.type == \
        "cpu"
    got = boophf_to_numpy(tg._mphf)
    other = _create(Graph, BankStrings(*seqs), 15, mphf_kind="emphf")
    assert all(np.array_equal(v, got[key]) for key, v in
               boophf_to_numpy(other._mphf).items())
    for f in ("bits", "prefix", "perm", "fallback_keys", "fallback_ranks"):
        want = np.asarray(getattr(jg._mphf, f))
        assert got[f].dtype == want.dtype and np.array_equal(got[f], want)
    assert got["sizes"] == jg._mphf.sizes and got["n"] == tg.nb_nodes
    assert np.array_equal(tg._mphf.rank(u32_to_torch(tg.solid_limbs, "cpu"))
                          .numpy(), np.arange(tg.nb_nodes))
    absent = tg.solid_limbs.copy()
    absent[:, -1] ^= 3
    for q in (tg.solid_limbs, absent, tg.solid_limbs[7]):
        idx = tg.node_index(q)
        assert idx.dtype == np.int32
        assert np.array_equal(idx, jg.node_index(q))
        assert np.array_equal(tg.query_abundance(q), jg.query_abundance(q))
    assert (tg.node_index(tg.solid_limbs) == np.arange(tg.nb_nodes)).all()
    for g in (tg, jg):
        g.set_node_state(g.solid_limbs[2:6], 3)
        g.delete_node(g.solid_limbs[4])
    for q in (tg.solid_limbs, absent):
        assert np.array_equal(tg.query_node_state(q), jg.query_node_state(q))
        assert np.array_equal(tg.is_node_deleted(q), jg.is_node_deleted(q))
    ti, ji = tg.get_info(), jg.get_info()
    assert "postsolid_time.mphf" in ti and set(ji) - set(ti) == ONLY_JAX


def test_membership_modes():
    seqs = _reads(21)
    g = _create(Graph, BankStrings(*seqs), 21)
    assert g.membership_mode == "exact"
    g.set_membership_mode("bloom_cfp")
    assert g.contains(g.solid_limbs).all()
    with pytest.raises(ValueError):
        g.set_membership_mode("hash")
    bare = _create(Graph, BankStrings(*seqs), 21, bloom_kind="none",
                   build_branching=False)
    with pytest.raises(ValueError, match="no debloom"):
        bare.set_membership_mode("bloom_cfp")
    with pytest.raises(ValueError, match="no debloom"):
        bare.contains(bare.solid_limbs, mode="bloom_cfp")


def test_branching_fork_and_checksum_match_jax():
    k = 15
    core = "ACGGTCATCAATGCCGTAAGGCTA"
    seqs = [core + "TTTTGCAGCTT", core + "GAAACTGGCAT"]
    tg = _create(Graph, BankStrings(*seqs), k)
    jg = _create(JGraph, JBank(*seqs), k)
    solid, nbrs = brute_force_graph(seqs, k)
    exp = [v for v in sorted(solid)
           if [len(x) for x in nbrs(v)] != [1, 1]]
    assert kmers_to_py(tg.branching_nodes()) == exp
    assert tg.checksum_branching() == f"{sum(exp) % (1 << 64):x}" \
        == jg.checksum_branching()
    info = tg.get_info()
    assert info["nb_branching"] == len(exp)


def test_precompute_adjacency_chunks_agree():
    seqs = _reads(31)
    whole = _create(Graph, BankStrings(*seqs), 31, bloom_kind="none",
                    build_branching=False)
    parts = _create(Graph, BankStrings(*seqs), 31, bloom_kind="none",
                    build_branching=False)
    a = whole.precompute_adjacency()
    b = parts.precompute_adjacency(chunk=37)
    assert np.array_equal(a, b) and a is whole.precompute_adjacency()
    assert "postsolid_time.adjacency" in parts.info


def test_abundance_state_and_build_node():
    k = 15
    seqs = ["ACGGTCATCAATGCCGTAAGG"] * 5
    g = _create(Graph, BankStrings(*seqs), k)
    jg = _create(JGraph, JBank(*seqs), k)
    assert (g.query_abundance(g.solid_limbs) == 5).all()
    node = g.solid_limbs[0]
    assert not g.is_node_deleted(node)[0]
    g.delete_node(node)
    assert g.is_node_deleted(node)[0]
    g.set_node_state(g.solid_limbs[1], 1)
    assert g.query_node_state(g.solid_limbs[1])[0] == 1
    assert g.query_node_state(g.solid_limbs[2])[0] == 0
    g.delete_nodes_by_index(np.array([3]))
    assert g.is_node_deleted(g.solid_limbs[3])[0]
    assert g.node_state.tolist()[:4] == [1, 2, 0, 1]
    seq = seqs[0][:k]
    built = g.build_node(seq)
    assert built.tolist() == jg.build_node(seq).tolist()
    assert g.contains(built)[0]
    assert g.node_to_string(built) == jg.node_to_string(built) == \
        kmer_to_string(canonical(string_to_kmer(seq), k), k)
    assert revcomp(string_to_kmer(g.node_to_string(built)), k) >= \
        string_to_kmer(g.node_to_string(built))
    with pytest.raises(ValueError):
        g.build_node(seq + "A")


def test_adjacency_kernel_and_popcount():
    seqs = _reads(31)
    g = _create(Graph, BankStrings(*seqs), 31, bloom_kind="none",
                build_branching=False)
    table = g._padded_table()
    assert table.dtype == torch.int32 and table.shape == g.solid_limbs.shape
    masks = tgraph._adjacency_kernel(table[:40], table, 31)
    assert masks.dtype == torch.uint8
    assert np.array_equal(masks.numpy(), g.adjacency_masks(
        g.solid_limbs[:40]))
    # fewer live rows: the neighbours past them are not found
    few = tgraph._adjacency_kernel(table[:40], table, 31, n_table=0)
    assert not few.any()
    x = np.arange(256, dtype=np.uint8)
    assert tgraph._popcount4(x).tolist() == [bin(v).count("1") for v in x]


def test_graph_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        Graph(15, np.zeros((1, 1), np.uint32), np.ones(1, np.int32))


@pytest.mark.parametrize("name", [
    "open_bank", "BankFasta", "BankStrings", "BankAlbum", "BankComposite",
    "BankSplitter", "BankFastaWriter", "Sequence", "CountConfig", "CountResult", "SortingCount", "count_kmers",
    "count_kmers_multibank", "solidity_check", "Histogram", "Graph",
    "build_bloom", "BloomFilter", "Storage", "assemble_contigs",
    "__version__", "parallel.mesh.make_mesh", "parallel.mesh.make_mesh2d",
    "parallel.mesh.data_sharding", "parallel.mesh.replicated",
    "parallel.mesh.DATA_AXIS", "parallel.mesh.HOST_AXIS",
    "parallel.mesh.CHIP_AXIS", "parallel.exchange.partition_of_minimizer",
    "parallel.exchange.ShardCount", "parallel.exchange.make_count_step",
    "parallel.exchange.count_kmers_distributed",
    "parallel.exchange.count_kmers_distributed_hostmerge",
    "parallel.exchange.global_table",
    "parallel.superbatch.sample_range_bounds",
    "parallel.superbatch.make_superbatch_step",
    "parallel.superbatch.make_host_merge",
    "parallel.superbatch.count_kmers_distributed_superbatch",
    "parallel.postsolid.shard_table", "parallel.postsolid.exchange_rank",
    "parallel.postsolid.distributed_adjacency",
    "parallel.postsolid.distributed_debloom_probe",
    "parallel.postsolid.distributed_cand_ranks",
    "parallel.postsolid.distributed_pointer_double",
    "parallel.postsolid.distributed_cut_cycles",
    "ops.bitpack.string_to_codes", "ops.bitpack.codes_to_string",
    "ops.bitpack.ascii_to_codes", "collections.containers.OAHash",
    "collections.containers.Hash16", "collections.containers.ContainerSet",
    "collections.containers.BagFile", "collections.containers.BagCache",
    "collections.containers.BagPartition",
    "collections.containers.IteratorFile", "storage.filedir.FileGroup",
    "storage.filedir.FileStorage", "storage.filedir.StorageFactory",
    "system.info.SystemInfo", "system.info.host_info",
    "system.info.library_info", "system.info.FileSystem",
    "tools.dbgcheck.largeint_hex", "tools.dbgcheck.check_graph",
    "tools.dbgcheck.main", "tools.dbgtopology.topology_matrix",
    "tools.dbgtopology.main", "tools.kmer_checksum.main",
    "tools.clear_cache.clear", "tools.clear_cache.main",
    "tools.new_project.create_project", "tools.new_project.main",
    "tools.bank_download.download", "tools.bank_download.annotate",
    "tools.bank_download.main"])
def test_package_surface(name):
    """Every name the port has a module for comes from both packages (a
    dotted name from the module it names)."""
    import importlib

    *mod, attr = name.split(".")
    jmod, tmod = jpkg, tpkg
    if mod:
        jmod = importlib.import_module(".".join([jpkg.__name__, *mod]))
        tmod = importlib.import_module(".".join([tpkg.__name__, *mod]))
    assert hasattr(jmod, attr) and hasattr(tmod, attr)
    if name == "__version__":
        assert tpkg.__version__ == jpkg.__version__
    if name.endswith("_AXIS"):
        assert getattr(jmod, attr) == getattr(tmod, attr)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_neither_jax_nor_the_jax_package():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "gatb_core_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    assert len(paths) > 30
    for path in paths:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "gatb_core_tpu"), \
                f"{path} imports {mod}"


@pytest.mark.parametrize("debloom", ["cascading", "original", "none"])
def test_load_resumes_after_every_stage(debloom, tmp_path):
    """The port's Graph.load of its own file (the cases of
    tests/test_postsolid.py): every completed stage comes back on the
    device asked for, a skipped one stays absent, and the loaded graph
    answers as the built one and as JAX's load of the same file."""
    from gatb_core_tpu_torch.collections.boophf import BooPHF
    from gatb_core_tpu_torch.ops.neighbor_ops import neighbor_candidates
    from gatb_core_tpu_torch.storage import hdf5 as th5

    out = str(tmp_path / "g.h5")
    kw = dict(output=out, repartition=False)
    if debloom == "none":
        kw.update(bloom_kind="none", mphf_kind="none")
    else:
        kw.update(debloom_kind=debloom, mphf_kind="boophf")
    rng = np.random.default_rng(6)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    seqs = [genome[i:i + 100] for i in range(0, 2900, 7)]
    g1 = _create(Graph, BankStrings(*seqs), 21, **kw)
    assert debloom == "none" or g1._debloom.nb_cfp > 0
    g1.storage.close()
    g2 = Graph.load(out, device="cpu")
    jg = JGraph.load(out)
    state = g2.storage.get_state()
    assert bool(state & th5.STATE_MPHF_DONE) == (debloom != "none")
    assert bool(state & th5.STATE_DEBLOOM_DONE) == (debloom != "none")
    assert state & th5.STATE_BRANCHING_DONE
    assert np.array_equal(g2.branching_nodes(), g1.branching_nodes())
    assert np.array_equal(g2._branching_counts, g1._branching_counts)
    assert np.array_equal(g2._adjacency, g1._adjacency)
    idx = g2.node_index(g2.solid_limbs)
    assert (idx == np.arange(g2.nb_nodes)).all()
    if debloom == "none":
        assert g2._mphf is None and g2._debloom is None
    else:
        assert isinstance(g2._mphf, BooPHF)
        assert g2._mphf.bits.device.type == "cpu"
        assert g2._debloom.kind == g1._debloom.kind == debloom
        assert np.array_equal(g2._debloom.bloom.to_numpy(),
                              g1._debloom.bloom.to_numpy())
        assert np.array_equal(g2._debloom.cfp, g1._debloom.cfp)
        cands = neighbor_candidates(g2._padded_table(), 21).numpy() \
            .astype(np.uint32).reshape(-1, g2._w)
        assert np.array_equal(g2.contains(cands, mode="bloom_cfp"),
                              g2.contains(cands, mode="exact"))
        assert np.array_equal(g2.contains(cands, mode="bloom_cfp"),
                              jg.contains(cands, mode="bloom_cfp"))
    assert np.array_equal(g2.query_abundance(g2.solid_limbs),
                          jg.query_abundance(jg.solid_limbs))
    g2.storage.close()
    jg.storage.close()
    with pytest.raises(ValueError, match="counting"):
        import h5py

        with h5py.File(str(tmp_path / "empty.h5"), "w"):
            pass
        Graph.load(str(tmp_path / "empty.h5"), device="cpu")

"""The port's mesh-sharded postsolid and unitig stages
(gatb_core_tpu_torch/parallel/postsolid.py and the ``mesh`` argument of
``Graph``, ``build_debloom``, ``build_unitigs``, ``build_unitig_graph`` and
``Simplifications``) against the JAX package's on its 8-device virtual CPU
mesh and against the port's single-device stages, on the inputs of
tests/test_parallel_postsolid.py (same seeds).

The port runs on 2, 4 and 8 spawned CPU ranks over gloo (one ``RankPool``
per size for the module); every rank must return the same result, equal to
JAX's exactly (no tolerance). The ranks import this module, so it imports
nothing of JAX at the top.
"""

import numpy as np
import pytest

from gatb_core_tpu_torch.parallel.mesh import RankPool

K = 21


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------


def _stages(mesh, limbs, cf):
    from gatb_core_tpu_torch.kmer.debloom import build_debloom
    from gatb_core_tpu_torch.parallel import postsolid as pp

    before = pp.retries["postsolid"]
    adj = pp.distributed_adjacency(mesh, limbs, K, capacity_factor=cf)
    replays = pp.retries["postsolid"] - before
    ranks, flips = pp.distributed_cand_ranks(mesh, limbs, K)
    deb = build_debloom(limbs, K, cascading=False, mesh=mesh,
                        device=mesh.device)
    return adj, replays, ranks.numpy(), flips.numpy(), deb.cfp


def _probe(mesh, limbs, words, size_bits, n_hash, seed, kind):
    import torch

    from gatb_core_tpu_torch.collections.bloom import BloomFilter
    from gatb_core_tpu_torch.parallel.postsolid import \
        distributed_debloom_probe

    bloom = BloomFilter(torch.from_numpy(words.view(np.int32)), size_bits,
                        n_hash, seed, kind, K)
    return (distributed_debloom_probe(mesh, limbs, K, bloom),)


def _list_ranking(mesh, parent):
    from gatb_core_tpu_torch.parallel import postsolid as pp

    par, cut = pp.distributed_cut_cycles(mesh, parent)
    roots, rank = pp.distributed_pointer_double(mesh, par)
    return par.numpy(), cut.numpy(), roots.numpy(), rank.numpy()


def _graph(mesh, reads, kw):
    from gatb_core_tpu_torch import BankStrings, Graph

    g = Graph.create(BankStrings(*reads), mesh=mesh, **kw)
    return _graph_record(g)


def _graph_record(g):
    ug = g.unitig_graph()
    unitigs = sorted(zip(list(ug.sequences), ug.mean_abundance.tolist()))
    stats = g.simplify()
    contigs, _ = g.contigs(traversal="monument")
    simplified = g.unitig_graph()
    return (g.solid_limbs, g.precompute_adjacency(), g.checksum_branching(),
            g._debloom.cfp, unitigs,
            (stats.tips_removed, stats.bulges_removed, stats.ec_removed),
            g.node_state.copy(), sorted(contigs),
            sorted(simplified.sequences))


def _same_on_every_rank(outs):
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b)
            else:
                assert a == b
    return outs[0]


# ---------------------------------------------------------------------------
# inputs and the JAX side
# ---------------------------------------------------------------------------


def _reads(seed=11, glen=3000, n_reads=400):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=glen))
    return [genome[s:s + 120]
            for s in rng.integers(0, glen - 120, size=n_reads)]


def _error_reads():
    """The reads above and mutated copies (twice each, so solid at
    abundance 2): bulges and tips to simplify."""
    rng = np.random.default_rng(29)
    reads = _reads(seed=31, glen=1500, n_reads=150)
    for i in range(0, 150, 10):
        r = list(reads[i])
        r[int(rng.integers(30, 90))] = "ACGT"[int(rng.integers(4))]
        reads += ["".join(r)] * 2
    return reads


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(n):
        if n not in made:
            made[n] = RankPool(n, device="cpu", timeout=120)
        return made[n]

    yield get
    for pool in made.values():
        pool.close()


@pytest.fixture(scope="module")
def jax_side():
    """The solid table of tests/test_parallel_postsolid.py and the JAX
    package's sharded stages on its 8-device mesh."""
    from gatb_core_tpu.bank.fasta import BankStrings
    from gatb_core_tpu.kmer.counting import count_kmers
    from gatb_core_tpu.kmer.debloom import build_debloom
    from gatb_core_tpu.parallel import postsolid as jp
    from gatb_core_tpu.parallel.mesh import make_mesh

    res = count_kmers(BankStrings(*_reads()), kmer_size=K, abundance_min=2)
    limbs = res.solid_kmers
    mesh = make_mesh(8)
    ranks, flips = jp.distributed_cand_ranks(mesh, limbs, K)
    deb = build_debloom(limbs, K, cascading=False)
    return dict(limbs=limbs, mesh=mesh,
                adj=jp.distributed_adjacency(mesh, limbs, K),
                ranks=ranks, flips=flips, deb=deb,
                cfp=jp.distributed_debloom_probe(mesh, limbs, K, deb.bloom))


def _port_single(limbs):
    """The port's single-device adjacency and candidate sweep (CPU)."""
    from gatb_core_tpu_torch.debruijn.graph import _adjacency_kernel
    from gatb_core_tpu_torch.debruijn.unitigs import cand_sweep
    from gatb_core_tpu_torch.kmer.debloom import rows_to_device

    table = rows_to_device(limbs, "cpu")
    ranks, flips = cand_sweep(table, len(limbs), K)
    return _adjacency_kernel(table, table, K).numpy(), ranks.numpy(), \
        flips.numpy()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_distributed_stages_equal(pools, jax_side, ndev):
    """Adjacency, candidate ranks and flips, and the cFP set through
    ``build_debloom(mesh=)``: equal to JAX's sharded stages and to the
    port's single-device sweeps."""
    limbs = jax_side["limbs"]
    adj, replays, ranks, flips, cfp = _same_on_every_rank(
        pools(ndev).run(_stages, limbs, 2.0))
    assert replays == 0
    assert adj.dtype == np.uint8 and np.array_equal(adj, jax_side["adj"])
    assert np.array_equal(ranks, jax_side["ranks"])
    assert np.array_equal(flips, jax_side["flips"])
    assert cfp.shape == jax_side["cfp"].shape
    assert np.array_equal(cfp, jax_side["cfp"])
    assert np.array_equal(cfp, jax_side["deb"].cfp)
    one_adj, one_ranks, one_flips = _port_single(limbs)
    assert np.array_equal(adj, one_adj)
    assert np.array_equal(ranks, one_ranks)
    assert np.array_equal(flips, one_flips)


def test_distributed_adjacency_overflow_retry(pools, jax_side, monkeypatch):
    """Send windows too small for the routing skew: the sweep is replayed
    as often as JAX's, and nothing is dropped."""
    from gatb_core_tpu.parallel import postsolid as jp

    calls = {"n": 0}
    dispatch = jp._adjacency_dispatch

    def counting(*a, **kw):
        calls["n"] += 1
        return dispatch(*a, **kw)

    monkeypatch.setattr(jp, "_adjacency_dispatch", counting)
    limbs = jax_side["limbs"]
    want = jp.distributed_adjacency(jax_side["mesh"], limbs, K,
                                    capacity_factor=0.02)
    adj, replays, *_ = _same_on_every_rank(
        pools(8).run(_stages, limbs, 0.02))
    assert replays > 0 and replays == calls["n"] - 1
    assert np.array_equal(adj, want)
    assert np.array_equal(adj, jax_side["adj"])


@pytest.mark.parametrize("ndev", [2, 8])
def test_distributed_debloom_probe_equal(pools, jax_side, ndev):
    """distributed_debloom_probe with JAX's own Bloom: the cFP set of
    JAX's probe."""
    bloom = jax_side["deb"].bloom
    (cfp,) = _same_on_every_rank(pools(ndev).run(
        _probe, jax_side["limbs"], np.asarray(bloom.words, np.uint32),
        bloom.size_bits, bloom.n_hash, bloom.user_seed, bloom.kind))
    assert np.array_equal(cfp, jax_side["cfp"])


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_distributed_list_ranking_equal(pools, jax_side, ndev):
    """Cycle cuts and pointer doubling over random chains and cycles:
    equal to JAX's single-device and sharded functions and to the port's
    single-device ones."""
    import torch

    from gatb_core_tpu.debruijn.unitigs import _cut_cycles, _pointer_double
    from gatb_core_tpu.parallel import postsolid as jp
    from gatb_core_tpu_torch.debruijn import unitigs as tu

    rng = np.random.default_rng(5)
    m = 2 * len(jax_side["limbs"]) + ndev - 1     # not a multiple of ndev
    par = np.arange(m)
    perm = rng.permutation(m)
    for i in range(0, m - 1, 3):      # random chains + the odd cycle
        par[perm[i]] = perm[i + 1]
    p1, c1 = _cut_cycles(par.copy())
    r1, k1 = _pointer_double(p1)
    got = _same_on_every_rank(pools(ndev).run(_list_ranking, par))
    for a, b in zip(got, (p1, c1, r1, k1)):
        assert np.array_equal(a, b)
    if ndev == 8:
        p2, c2 = jp.distributed_cut_cycles(jax_side["mesh"], par.copy())
        r2, k2 = jp.distributed_pointer_double(jax_side["mesh"], p2)
        for a, b in zip(got, (p2, c2, r2, k2)):
            assert np.array_equal(a, b)
    tp, tc = tu._cut_cycles(torch.from_numpy(par))
    tr, tk = tu._pointer_double(tp)
    for a, b in zip(got, (tp, tc, tr, tk)):
        assert np.array_equal(a, b.numpy())


@pytest.fixture(scope="module")
def graphs():
    """The JAX package's and the port's single-device graphs of the error
    reads: create, unitigs, simplify, Monument, the simplified unitigs."""
    from gatb_core_tpu.bank.fasta import BankStrings as JBank
    from gatb_core_tpu.debruijn.graph import Graph as JGraph
    from gatb_core_tpu_torch import BankStrings, Graph

    reads = _error_reads()
    kw = dict(kmer_size=K, abundance_min=2, batch_reads=64, batch_len=256,
              build_branching=True, mphf_kind="none")
    want = _graph_record(JGraph.create(JBank(*reads), **kw))
    one = _graph_record(Graph.create(BankStrings(*reads), device="cpu",
                                     **kw))
    return reads, kw, want, one


@pytest.mark.parametrize("ndev", [2, 8])
def test_full_graph_build_on_mesh(pools, graphs, ndev):
    """Graph.create(mesh=): the table, adjacency, branching checksum, cFP
    set, unitigs with their abundances, simplify's removals and
    node_state, Monument contigs and the simplified unitig graph, equal to
    JAX's graph and to the port's single-device graph."""
    reads, kw, want, one = graphs
    got = _same_on_every_rank(pools(ndev).run(_graph, reads, kw))
    assert sum(want[5]) > 0           # simplify removed something
    for a, b, c in zip(got, want, one):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b) and np.array_equal(a, c)
        else:
            assert a == b == c


def test_tiny_table_leaves_shards_empty(pools, jax_side):
    """3 rows over 8 ranks: five shards are empty and their ranks still
    take part in every collective; the stages equal JAX's."""
    from gatb_core_tpu.parallel import postsolid as jp

    limbs = jax_side["limbs"][:3]
    adj, _, ranks, flips, _ = _same_on_every_rank(
        pools(8).run(_stages, limbs, 2.0))
    want_r, want_f = jp.distributed_cand_ranks(jax_side["mesh"], limbs, K)
    assert np.array_equal(adj, jp.distributed_adjacency(jax_side["mesh"],
                                                        limbs, K))
    assert np.array_equal(ranks, want_r) and np.array_equal(flips, want_f)

"""gatb_core_tpu_torch.debruijn.unitigs and graph_unitigs against the JAX
package's modules on the same solid tables and adjacency: every field of
``build_unitigs`` (sequences, node maps, k-mer counts, the float32 means
bit for bit), the successor / cycle-cut / list-ranking core on random
adjacency, the chunked candidate sweep, the links, and the GFA and FASTA
bytes. The tables come from the port's Graph on the CPU (its adjacency is
held equal to JAX's by test_torch_graph.py); at most one JAX unitig build
per case."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gatb_core_tpu.debruijn import graph_unitigs as jgu
from gatb_core_tpu.debruijn import unitigs as ju
from gatb_core_tpu_torch import BankStrings, Graph
from gatb_core_tpu_torch.debruijn import graph_unitigs as tgu
from gatb_core_tpu_torch.debruijn import unitigs as tu


def _graph(seqs, k, **kw):
    return Graph.create(BankStrings(*seqs), kmer_size=k, abundance_min=1,
                        batch_reads=16, batch_len=max(128, 3 * k),
                        mphf_kind="none", bloom_kind="none",
                        build_branching=False, superbatch_rows=1 << 13,
                        device="cpu", **kw)


def _bank(k, seed):
    """Reads of a random genome with a branch and uneven coverage."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=600))
    seqs = [genome[i:i + 2 * k + 20] for i in range(0, 580 - 2 * k, k // 2)]
    seqs.append(genome[50:50 + k] + "".join(rng.choice(list("ACGT"),
                                                       size=30)))
    seqs.append(genome[200:300])
    return seqs


def _inputs(g):
    return g.solid_limbs, g.solid_counts, g.precompute_adjacency(), g._k


def _same_set(a, b):
    assert list(a.sequences) == list(b.sequences)
    for f in ("mean_abundance", "kmer_counts", "node_unitig", "node_pos",
              "node_strand"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.mean_abundance.view(np.uint32).tolist() == \
        b.mean_abundance.view(np.uint32).tolist()


@pytest.fixture(scope="module", params=[15, 31, 63])
def case(request):
    k = request.param
    g = _graph(_bank(k, seed=k), k)
    limbs, counts, adj, _ = _inputs(g)
    return g, ju.build_unitigs(limbs, counts, adj, k)


def test_build_unitigs_matches_jax(case):
    g, want = case
    got = tu.build_unitigs(*_inputs(g), device="cpu")
    _same_set(got, want)
    assert (got.node_unitig >= 0).all()
    assert int(got.kmer_counts.sum()) == g.nb_nodes
    assert got.nb_unitigs > 1
    # the device table as input, with the step clock on
    steps = {}
    on_dev = tu.build_unitigs(g._padded_table(), g.solid_counts,
                              g.precompute_adjacency(), g._k, device="cpu",
                              timings=steps)
    np.testing.assert_array_equal(on_dev.sequences.lengths(),
                                  [len(s) for s in want.sequences])
    _same_set(on_dev, want)
    assert list(steps) == ["candidate_ranks", "successor_rule", "cycle_cut",
                           "list_ranking", "node_maps", "emit"]
    assert all(v >= 0 for v in steps.values())


def test_chunked_sweep_and_candidate_ranks_match(case):
    g, want = case
    limbs, counts, adj, k = _inputs(g)
    for chunk in (64, 1000):
        _same_set(tu.build_unitigs(limbs, counts, adj, k, chunk=chunk,
                                   device="cpu"), want)
    ranks, flips = tu._cand_ranks_flips(g._padded_table(), g._padded_table(),
                                        g.nb_nodes, k)
    jr, jf = ju._cand_ranks_flips(jnp.asarray(limbs), jnp.asarray(limbs),
                                  jnp.int32(g.nb_nodes), k)
    assert ranks.dtype == torch.int32 and flips.dtype == torch.int8
    assert np.array_equal(ranks.numpy(), np.asarray(jr))
    assert np.array_equal(flips.numpy(), np.asarray(jf))


def test_link_unitigs_and_files_match_jax(case, tmp_path):
    g, want = case
    limbs, counts, adj, k = _inputs(g)
    jg = jgu.link_unitigs(limbs, want, k)
    tg = tgu.build_unitig_graph(limbs, counts, adj, k, device="cpu")
    assert np.array_equal(tg.link_offsets, jg.link_offsets)
    assert np.array_equal(tg.link_targets, jg.link_targets)
    assert tg.link_offsets.dtype == jg.link_offsets.dtype
    assert tg.link_targets.dtype == jg.link_targets.dtype
    assert len(tg.link_targets) > 0
    # the links of JAX's unitig set through the port
    tp = tgu.link_unitigs(limbs, want, k, device="cpu")
    assert np.array_equal(tp.link_offsets, jg.link_offsets)
    assert np.array_equal(tp.link_targets, jg.link_targets)
    for name in ("write_gfa", "write_fasta"):
        getattr(jg, name)(str(tmp_path / "j"))
        getattr(tg, name)(str(tmp_path / "t"))
        assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    tg.write_gfa(str(tmp_path / "u.gfa"))
    a = tgu.UnitigGraph.load_gfa(str(tmp_path / "u.gfa"), k)
    b = jgu.UnitigGraph.load_gfa(str(tmp_path / "u.gfa"), k)
    assert a.sequences == b.sequences == list(want.sequences)
    for f in ("mean_abundance", "kmer_counts", "link_offsets",
              "link_targets"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert [a.simple_path_longest(o) for o in range(2 * a.nb_unitigs)] == \
        [b.simple_path_longest(o) for o in range(2 * b.nb_unitigs)]


def test_graph_unitigs_and_contigs_match_jax(case):
    """Graph.unitig_graph and Graph.contigs (traversal 'simple') against
    JAX's from the same table, and the A7 paths raise."""
    g, want = case
    ug = g.unitig_graph()
    assert list(ug.sequences) == list(want.sequences)
    assert "postsolid_time.unitigs" in g.info
    seqs, means = g.contigs(min_contig_len=g._k + 2)
    keep = np.asarray([len(s) for s in want.sequences]) >= g._k + 2
    assert seqs == [s for s, k_ in zip(want.sequences, keep) if k_]
    assert np.array_equal(means, want.mean_abundance[keep])
    with pytest.raises(NotImplementedError, match="A7"):
        g.contigs(traversal="monument")
    g.delete_nodes_by_index(np.array([0]))
    with pytest.raises(NotImplementedError, match="A7"):
        g.unitig_graph()
    with pytest.raises(NotImplementedError, match="A7"):
        g.contigs()
    g.node_state[:] = 0


def test_circular_and_single_kmer_match_jax():
    """The fixtures of tests/test_unitigs.py: a circular genome (one cyclic
    unitig) and a single k-mer."""
    rng = np.random.default_rng(0)
    core = "".join(rng.choice(list("ACGT"), size=60))
    for seqs, k in (([core + core[:10]], 11), (["ACGGTCATCAATGCC"], 15)):
        g = _graph(seqs, k)
        got = tu.build_unitigs(*_inputs(g), device="cpu")
        _same_set(got, ju.build_unitigs(*_inputs(g)))
        assert got.nb_unitigs == 1
        assert int(got.kmer_counts[0]) == g.nb_nodes


def test_empty_table():
    got = tu.build_unitigs(np.zeros((0, 2), np.uint32),
                           np.zeros(0, np.int32), np.zeros(0, np.uint8), 31,
                           device="cpu")
    want = ju.build_unitigs(np.zeros((0, 2), np.uint32),
                            np.zeros(0, np.int32), np.zeros(0, np.uint8), 31)
    _same_set(got, want)
    ug = tgu.link_unitigs(np.zeros((0, 2), np.uint32), got, 31, device="cpu")
    assert ug.nb_unitigs == 0 and ug.link_offsets.tolist() == [0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_succ_cut_rank_matches_jax_on_random_adjacency(seed):
    """Random masks and candidate ranks (chains, cycles, branches and
    absent candidates mixed), with padding rows past n."""
    rng = np.random.default_rng(seed)
    c, n = 512, 500
    adj = rng.integers(0, 256, c).astype(np.uint8)
    adj[rng.random(c) < 0.6] = np.uint8(0x11)      # many simple nodes
    ranks = rng.integers(-1, n, size=(c, 8)).astype(np.int32)
    # a cycle of 40 nodes and a chain of 60: out by A (slot 0), in by A
    # (the reverse strand's successor sits in slot 4)
    for lo, hi, cyc in ((0, 40, True), (100, 160, False)):
        adj[lo:hi] = 0x11
        for i in range(lo, hi):
            nxt = i + 1 if i + 1 < hi else lo
            ranks[i, 0] = nxt if (i + 1 < hi or cyc) else -1
            ranks[nxt, 4] = i
    flips = rng.integers(0, 2, size=(c, 8)).astype(np.int8)
    flips[:160] = 0
    want = ju._succ_cut_rank(jnp.asarray(ranks), jnp.asarray(flips),
                             jnp.asarray(adj), n)
    got = tu._succ_cut_rank(torch.from_numpy(ranks), torch.from_numpy(flips),
                            torch.from_numpy(adj), n)
    for x, y in zip(got, want):
        assert np.array_equal(x.numpy(), np.asarray(y))
    assert got[2].any()                              # a cycle was cut
    succ = tu._oriented_succ(torch.from_numpy(adj), torch.from_numpy(ranks),
                             torch.from_numpy(flips)).numpy()
    jsucc = ju._oriented_succ(adj, np.maximum(ranks, 0), flips)
    sel = (ranks >= 0).all(axis=1).repeat(2)
    assert np.array_equal(succ[sel], jsucc[sel])
    assert np.array_equal(tu._indegree_oriented(torch.from_numpy(adj)),
                          ju._indegree_oriented(adj))


@pytest.mark.parametrize("m", [1, 2, 37, 1024, 3001])
def test_pointer_double_and_cut_cycles_match_jax(m):
    """Random forests of chains plus pure cycles: the same roots, ranks,
    cuts and round count as the JAX package's padded arrays."""
    rng = np.random.default_rng(m)
    perm = rng.permutation(m)
    parent = np.arange(m)
    cuts = np.sort(rng.choice(m, max(1, m // 10), replace=False))
    for a, b in zip(cuts, list(cuts[1:]) + [m]):
        seg = perm[a:b]
        parent[seg[1:]] = seg[:-1]
        if rng.random() < 0.3 and len(seg) > 1:
            parent[seg[0]] = seg[-1]                 # a pure cycle
    cut_p, cut = tu._cut_cycles(torch.from_numpy(parent))
    jcut_p, jcut = ju._cut_cycles(parent)
    assert np.array_equal(cut_p.numpy(), jcut_p)
    assert np.array_equal(cut.numpy(), jcut)
    roots, rank = tu._pointer_double(cut_p)
    jroots, jrank = ju._pointer_double(jcut_p)
    assert np.array_equal(roots.numpy(), jroots)
    assert np.array_equal(rank.numpy(), jrank)
    cap = 1 << max(1, (m - 1).bit_length())
    assert tu._rounds(m) == max(1, int(np.ceil(np.log2(max(cap, 2))))) + 1

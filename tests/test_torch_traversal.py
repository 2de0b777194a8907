"""gatb_core_tpu_torch.debruijn.traversal and iterative_extensions against
the JAX package's modules, with no tolerance: needleman_wunsch_identity,
the oriented neighbor table of NodeGraphView, assemble_contigs for both
traversals and both engines (the contig lists in order, and the
TraversalStats), Graph.contigs(traversal="monument") after simplify(),
IterativeExtensions, and the get_info() keys the two stages add.

Tables come from the port's Graph.create on the CPU; both packages' Graph
objects are made from them (``Graph(k, limbs, counts)``). The read
generators are test_torch_simplify.py's."""

from types import SimpleNamespace

import numpy as np
import pytest

from gatb_core_tpu.debruijn import iterative_extensions as jie
from gatb_core_tpu.debruijn import traversal as jtr
from gatb_core_tpu.debruijn.graph import Graph as JGraph
from gatb_core_tpu_torch import Graph
from gatb_core_tpu_torch.debruijn import iterative_extensions as tie
from gatb_core_tpu_torch.debruijn import traversal as ttr
from test_torch_simplify import _bubbly, _errors, _graph, _rand


def _table(seqs, k, amin=1):
    g = _graph(seqs, k, amin)
    return SimpleNamespace(k=k, limbs=g.solid_limbs, counts=g.solid_counts)


def _pair(table):
    return (Graph(table.k, table.limbs, table.counts, device="cpu"),
            JGraph(table.k, table.limbs, table.counts))


def _snp():
    """tests/test_traversal.py's SNP bubble: two haplotypes, 2:1."""
    rng = np.random.default_rng(2)
    left, right, mid = _rand(rng, 60), _rand(rng, 60), _rand(rng, 9)
    mid2 = mid[:4] + ("A" if mid[4] != "A" else "C") + mid[5:]
    reads = []
    for h in (left + mid + right,) * 2 + (left + mid2 + right,):
        reads += [h[i:i + 45] for i in range(0, len(h) - 44, 6)]
        reads.append(h[-45:])
    return reads, 15, 1


CASES = {"bubbly1": lambda: _bubbly(1, amin=1), "bubbly2": lambda: _bubbly(2),
         "snp": _snp, "errors_k21": lambda: _errors(21, 5, glen=2000),
         "errors_k63": lambda: _errors(63, 6, glen=2000)}


@pytest.fixture(scope="module", params=list(CASES))
def table(request):
    seqs, k, amin = CASES[request.param]()
    table = _table(seqs, k, amin)
    table.name = request.param
    return table


def test_needleman_wunsch_identity_matches_jax():
    rng = np.random.default_rng(0)
    pairs = [("", ""), ("A", ""), ("ACGT", "ACGT"), ("ACGTACGTAC",
                                                     "ACGTCGTAC")]
    for _ in range(60):
        a = _rand(rng, int(rng.integers(1, 40)))
        b = list(a)
        for _ in range(int(rng.integers(0, 6))):
            op, p = int(rng.integers(3)), int(rng.integers(len(b) + 1))
            if op == 0 and p < len(b):
                b[p] = "ACGT"[int(rng.integers(4))]
            elif op == 1:
                b.insert(p, "ACGT"[int(rng.integers(4))])
            elif b:
                del b[min(p, len(b) - 1)]
        pairs += [(a, "".join(b)), (a, _rand(rng, int(rng.integers(1, 40))))]
    for a, b in pairs:
        got = ttr.needleman_wunsch_identity(a, b)
        assert got == jtr.needleman_wunsch_identity(a, b), (a, b)
        assert isinstance(got, float)


def _views_equal(tg, jg, precomputed=None):
    tv = ttr.NodeGraphView(tg, precomputed=precomputed)
    jv = jtr.NodeGraphView(jg)
    for f in ("out_nbr", "out_deg_arr", "alive"):
        x, y = getattr(tv, f), getattr(jv, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert tv.n == jv.n and tv.k == jv.k
    for oid in (0, 1, 2 * tv.n - 1):
        assert tv.node_string(oid) == jv.node_string(oid)
        assert tv.out_neighbors(oid) == jv.out_neighbors(oid)
        assert tv.in_degree(oid) == jv.in_degree(oid)
    return tv


def test_node_graph_view_matches_jax(table):
    """From the view's own sweep, on the whole graph and with nodes
    deleted by simplify(); and from Simplifications' sweep."""
    tg, jg = _pair(table)
    _views_equal(tg, jg)
    tg.simplify()
    jg.simplify()
    assert np.array_equal(tg.node_state, jg.node_state)
    _views_equal(tg, jg)
    simp = tg._simplifications
    _views_equal(tg, jg, (simp._full_ranks, simp._full_flips))


def _assemble(mod, graph, monkeypatch, **kw):
    """assemble_contigs and the TraversalStats of the traversal it made."""
    made = []
    init = mod.Traversal.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    with monkeypatch.context() as m:
        m.setattr(mod.Traversal, "__init__", record)
        seqs = mod.assemble_contigs(graph, **kw)
    assert len(made) == 1
    return seqs, vars(made[0].stats)


@pytest.mark.parametrize("simplified", [False, True])
def test_assemble_contigs_matches_jax(table, simplified, monkeypatch):
    tg, jg = _pair(table)
    if simplified:
        tg.simplify()
        jg.simplify()
    for traversal in ("simple", "monument"):
        for engine in ("oracle", "fast"):
            kw = dict(traversal=traversal, engine=engine, min_contig_len=0)
            got = _assemble(ttr, tg, monkeypatch, **kw)
            want = _assemble(jtr, jg, monkeypatch, **kw)
            assert got == want, (traversal, engine)
            assert got[0]
    if table.name in ("bubbly1", "snp") and not simplified:
        assert got[1]["bubbles_popped"] > 0     # Monument crossed bubbles


def test_graph_contigs_monument_after_simplify(table):
    tg, jg = _pair(table)
    before = set(tg.get_info()), set(jg.get_info())
    assert vars(tg.simplify()) == vars(jg.simplify())
    seqs, means = tg.contigs(traversal="monument")
    want, _ = jg.contigs(traversal="monument")
    assert means is None and seqs == want
    assert all(len(s) >= 2 * tg.kmer_size + 1 for s in seqs)
    # the keys the two stages add to get_info()
    added = set(tg.get_info()) - before[0]
    assert added == set(jg.get_info()) - before[1]
    assert {"postsolid_time.simplify", "postsolid_time.contigs"} <= added


def _ext_graph(reads, k):
    return _pair(_table(reads, k))


def test_iterative_extensions_match_jax():
    """The three cases of tests/test_misc_components.py::
    TestIterativeExtensions, with both traversal kinds."""
    k = 15
    rng = np.random.default_rng(1)
    genome = _rand(rng, 200)
    lin = _ext_graph([genome[i:i + 60] for i in range(0, 140, 7)], k)
    rng = np.random.default_rng(2)
    genome2 = _rand(rng, 150)
    tgt = _ext_graph([genome2[i:i + 60] for i in range(0, 90, 5)], k)
    tiny = _ext_graph(["ACGGTCATCAATGCCGT"], k)
    calls = [(lin, (genome[:k],)), (tgt, (genome2[:k], genome2[50:50 + k])),
             (tiny, ("T" * k,))]
    for (tg, jg), args in calls:
        for kind in ("monument", "simple"):
            got = tie.IterativeExtensions(tg, traversal_kind=kind)
            want = jie.IterativeExtensions(jg, traversal_kind=kind)
            assert np.array_equal(got.view.out_nbr, want.view.out_nbr)
            a, b = got.extend(*args), want.extend(*args)
            assert isinstance(a, tie.ExtensionResult)
            assert vars(a) == vars(b), (args, kind)
    assert tie.IterativeExtensions(tgt[0]).extend(
        genome2[:k], target=genome2[50:50 + k]).reached_target
    with pytest.raises(ValueError):
        tie.IterativeExtensions(tiny[0]).extend("ACG")

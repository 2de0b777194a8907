"""The port's Minia assembly (``Graph.simplify()`` then
``Graph.contigs(traversal="monument")``) against the benchmark's plain
reference (``benchmark/reference/minia.py``), and the reference against
the JAX package's, with no tolerance: the deleted nodes, the
simplification's numbers and removal strings, and the contigs.

Banks are the benchmark's own generator's at a small size, with
scaled-down rRNA-like (4 copies of 600 bp, 0.1-1% diverged) and IS-like
(two 350 bp types, 0-0.2% diverged) families laid in, 100x of 150 bp
reads with 0.5% substitutions, at k 21 and k 31 on three seeds each.
Both programs take the reference's own count (``dbg.Truth``) as their
solid table. The ``minia_bank`` judge is shown planted faults: one tip
kept, one contig dropped."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gatb_core_tpu.debruijn.graph import Graph as JGraph
from gatb_core_tpu_torch import Graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import gen as G  # noqa: E402
from benchmark.harness import BENCH_DIR, load_module  # noqa: E402
from benchmark.reference import dbg as R  # noqa: E402
from benchmark.reference import kmers as K  # noqa: E402
from benchmark.reference import minia as M  # noqa: E402

D = load_module(os.path.join(BENCH_DIR, "drivers", "minia_bank.py"))
SEEDS = (2**31 + 1, 2**33 + 7, 5)


def _config(k: int) -> dict:
    return {"genome_len": 20000, "read_len": 150, "coverage": 100,
            "error_rate": 0.005, "strands": "both", "kmer_size": k,
            "abundance_min": 2, "repeats": {"families": [
                {"name": "rrn", "copies": 4, "mb": 0.0024, "share": 0.12,
                 "consensus_len": 600, "consensi": 1, "keep_3prime": False,
                 "divergence": [0.001, 0.01]},
                {"name": "IS", "copies": 8, "mb": 0.0024, "share": 0.1,
                 "consensus_len": 350, "consensi": 2, "keep_3prime": False,
                 "divergence": [0.0, 0.002]}]}}


def _truth(k: int, seed: int):
    cfg = _config(k)
    return cfg, R.Truth.of(G.bank_blocks(cfg, seed, "cpu")[2], k, 2)


def _assemble(g) -> dict:
    """What ``minia_bank`` keeps of a step: deletions, numbers, contigs."""
    stats = g.simplify()
    s = g._simplifications
    contigs, _ = g.contigs(traversal="monument")
    return {"deleted": np.packbits(g.node_state & 1).tobytes(),
            "stats": {"tips_removed": stats.tips_removed,
                      "bulges_removed": stats.bulges_removed,
                      "ec_removed": stats.ec_removed, "passes": stats.passes,
                      "tip_removal": s.tip_removal,
                      "bubble_removal": s.bubble_removal,
                      "ec_removal": s.ec_removal},
            "contigs": contigs}


def _reference(truth) -> SimpleNamespace:
    m = M.Minia(truth)
    stats = dict(m.simplify())
    return SimpleNamespace(minia=m, stats=stats, deleted=~m.live.numpy(),
                           contigs=m.contigs())


@pytest.fixture(scope="module", params=[(k, s) for k in (21, 31)
                                        for s in SEEDS],
                ids=lambda p: f"k{p[0]}-{p[1]}")
def case(request):
    k, seed = request.param
    cfg, truth = _truth(k, seed)
    limbs = K.values_to_limbs(truth.nodes.numpy(), k)
    g = Graph(k, limbs, truth.counts.numpy().astype(np.int32), device="cpu")
    return SimpleNamespace(k=k, seed=seed, cfg=cfg, truth=truth, limbs=limbs,
                           graph=g, port=_assemble(g),
                           ref=_reference(truth))


def test_port_equals_the_reference(case):
    got, ref = case.port, case.ref
    deleted = np.unpackbits(np.frombuffer(got["deleted"], np.uint8),
                            count=len(case.limbs)).astype(bool)
    assert np.array_equal(deleted, ref.deleted)
    assert got["stats"] == {f: ref.stats[f] for f in D.STATS}
    assert M.contig_diff(got["contigs"], ref.contigs) == 0
    assert sorted(got["contigs"]) == sorted(ref.contigs)
    # the banks are not trivial: every pass deletes, and the repeats
    # split the genome into several contigs
    assert min(ref.stats[f] for f in ("tips_removed", "bulges_removed",
                                      "ec_removed")) > 0
    assert len(ref.contigs) >= 5


def test_reset_then_again_equals_a_fresh_graph(case):
    g = case.graph
    g.reset_node_state()
    assert not g.node_state.any() and g._simplifications is None
    again = _assemble(g)
    assert again["deleted"] == case.port["deleted"]
    assert again["stats"] == case.port["stats"]
    assert sorted(again["contigs"]) == sorted(case.port["contigs"])


def test_the_judge_reads_a_sound_step_as_zero(case):
    graph, steps = _outputs_to_judge(case)
    nums, failed = D.judge(case.cfg, case.seed, "cpu", graph, steps,
                           case.truth)
    assert failed == 0 and all(v == lim == 0 for v, lim in nums.values())


def _outputs_to_judge(case):
    t = case.truth
    branch = (K.popcount4(t.masks) != 1) | (K.popcount4(t.masks >> 4) != 1)
    graph = {"limbs": case.limbs, "counts": t.counts.numpy(),
             "info": {"kmers_nb_distinct": t.distinct.numel(),
                      "kmers_nb_weak": int((t.distinct_counts < 2).sum()),
                      "kmers_nb_valid": t.windows},
             "masks": t.masks.numpy(), "branching": case.limbs[branch]}
    return graph, [dict(case.port), dict(case.port)]


@pytest.mark.parametrize("fault", ["tip_kept", "contig_dropped"])
def test_planted_faults_read_nonzero(fault):
    k, seed = 31, SEEDS[0]
    cfg, truth = _truth(k, seed)
    ref = _reference(truth)
    limbs = K.values_to_limbs(truth.nodes.numpy(), k)
    step = {"deleted": ref.deleted.copy(),
            "stats": {f: ref.stats[f] for f in D.STATS},
            "contigs": list(ref.contigs)}
    if fault == "tip_kept":
        # the nodes of one tip back in the graph: a dead end of the graph
        # as built that the reference deleted
        deg = M.Compaction(ref.minia.out, torch.ones_like(ref.minia.live),
                           ref.minia.counts, k).deg_o.numpy()
        dead_end = (deg[0::2] == 0) | (deg[1::2] == 0)
        step["deleted"][np.nonzero(dead_end & ref.deleted)[0][0]] = False
    else:
        step["contigs"].pop(len(step["contigs"]) // 2)
    step["deleted"] = np.packbits(step["deleted"]).tobytes()
    case = SimpleNamespace(truth=truth, limbs=limbs,
                           port=step)
    graph, steps = _outputs_to_judge(case)
    nums, failed = D.judge(cfg, seed, "cpu", graph, steps, truth)
    name = {"tip_kept": "deleted_diff", "contig_dropped": "contig_diff"}
    assert nums[name[fault]][0] >= 1 and failed == 2
    assert nums["minia_steps_differ"][0] == 0


def test_the_reference_equals_jax():
    k, seed = 31, SEEDS[1]
    _, truth = _truth(k, seed)
    limbs = K.values_to_limbs(truth.nodes.numpy(), k)
    jg = JGraph(k, limbs, truth.counts.numpy().astype(np.int32))
    stats = jg.simplify()
    s = jg._simplifications
    contigs, _ = jg.contigs(traversal="monument")
    ref = _reference(truth)
    assert np.array_equal((jg.node_state & 1).astype(bool), ref.deleted)
    assert {"tips_removed": stats.tips_removed,
            "bulges_removed": stats.bulges_removed,
            "ec_removed": stats.ec_removed, "passes": stats.passes,
            "tip_removal": s.tip_removal, "bubble_removal": s.bubble_removal,
            "ec_removal": s.ec_removal} \
        == {f: ref.stats[f] for f in D.STATS}
    assert sorted(contigs) == sorted(ref.contigs)


def test_identity_is_the_programs():
    """The reference's integer Needleman-Wunsch against the port's float32
    one, on pairs with substitutions, insertions and deletions."""
    from gatb_core_tpu_torch.debruijn.traversal import \
        needleman_wunsch_identity

    rng = np.random.default_rng(3)
    for _ in range(40):
        a = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 30))))
        b = list(a)
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(len(b) + 1))
            op = int(rng.integers(3))
            if op == 0 and p < len(b):
                b[p] = "ACGT"[int(rng.integers(4))]
            elif op == 1:
                b.insert(p, "ACGT"[int(rng.integers(4))])
            elif b:
                del b[min(p, len(b) - 1)]
        b = "".join(b)
        assert M.identity(a, b) == needleman_wunsch_identity(a, b)

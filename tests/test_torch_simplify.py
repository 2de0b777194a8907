"""gatb_core_tpu_torch.debruijn.simplifications against the JAX package's
module, with no tolerance: integers, bools and strings equal, float32 means
and float64 sums bit for bit.

Each table is built by the port's ``Graph.create`` on the CPU; the JAX
``Graph`` is made from that table (``Graph(k, limbs, counts)``), never by
its own ``create``. One JAX and one port ``Simplifications`` run per
module-scoped case, and everything is compared from that run: node_state
after every pass, the stats, pass counters and removal strings, the full
sweep, the first compaction (its lazy sequences spelled only after the
later deletions), the RCTC test of every extremity, the bulge walker on
every bulge candidate, and the unitig graph of the simplified graph.

Cases: the motifs of tests/test_simplifications.py (Y-fork, short tip,
long tip, bulge, EC, full simplify), the bubbly graphs of
tests/test_traversal_batched.py (seeds 1-2), three parallel paths (one
extremity with several accepted bulge links), and reads with 1%
substitutions at k=21 and k=63. The ``slow`` test holds the constants
chip_smoke.py phase 12 checks the card against."""

import importlib.util
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gatb_core_tpu.debruijn import graph_unitigs as jgu
from gatb_core_tpu.debruijn import simplifications as jsm
from gatb_core_tpu.debruijn.graph import Graph as JGraph
from gatb_core_tpu_torch import BankStrings, Graph
from gatb_core_tpu_torch.debruijn import graph_unitigs as tgu
from gatb_core_tpu_torch.debruijn import simplifications as tsm
from gatb_core_tpu_torch.debruijn.unitigs import LazySequences

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASSES = ("remove_tips", "remove_bulges", "remove_erroneous_connections")


def _rand(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def _graph(seqs, k, amin=1):
    return Graph.create(BankStrings(*seqs), kmer_size=k, abundance_min=amin,
                        batch_reads=64, batch_len=256, mphf_kind="none",
                        bloom_kind="none", build_branching=False,
                        superbatch_rows=1 << 13, device="cpu")


# ---- the cases (reads, k, abundance-min) ---------------------------------

def _fork():
    k, rng = 11, np.random.default_rng(5)
    stem = _rand(rng, 40)
    return [stem, stem[-(k - 1):] + "A" + _rand(rng, 20),
            stem[-(k - 1):] + "C" + _rand(rng, 20)], k, 1


def _short_tip():
    k, rng = 11, np.random.default_rng(6)
    main = _rand(rng, 120)
    nt = "G" if main[40 + k - 1] == "T" else "T"
    return [main, main, main[40:40 + k - 1] + nt + _rand(rng, 5)], k, 1


def _long_tip():
    k, rng = 11, np.random.default_rng(7)
    main = _rand(rng, 150)
    nt = "G" if main[40 + k - 1] == "T" else "T"
    return [main, main[40:40 + k - 1] + nt + _rand(rng, 12 * k)], k, 1


def _bulge():
    rng = np.random.default_rng(8)
    left, right = _rand(rng, 40), _rand(rng, 40)
    hi, lo = _rand(rng, 30), _rand(rng, 30)
    return [left + hi + right] * 10 + [left + lo + right], 11, 1


def _ec():
    k, rng = 11, np.random.default_rng(9)
    a, b = _rand(rng, 80), _rand(rng, 80)
    bridge = a[60:60 + k - 1] + _rand(rng, 12) + b[10:10 + k - 1]
    return [a] * 12 + [b] * 12 + [bridge], k, 1


def _full():
    k, rng = 11, np.random.default_rng(10)
    genome = _rand(rng, 300)
    reads = [genome[i:i + 60] for i in range(0, 240, 10)] * 3
    for _ in range(5):
        p = int(rng.integers(0, 200))
        reads.append(genome[p:p + k - 1] + _rand(rng, 8))
    return reads, k, 1


def _bubbly(seed, glen=2500, k=21, n_mut=10, amin=2):
    """tests/test_traversal_batched.py:_bubbly_graph's reads (at
    abundance-min 1 its SNP re-reads stay, as bubbles)."""
    rng = np.random.default_rng(seed)
    genome = _rand(rng, glen)
    reads = [genome[s:s + 120]
             for s in rng.integers(0, glen - 120, size=glen // 6)]
    for _ in range(n_mut):
        s = int(rng.integers(0, glen - 120))
        r = list(genome[s:s + 120])
        r[60] = "ACGT"[int(rng.integers(4))]
        reads.append("".join(r))
    return reads, k, amin


def _triple():
    """Three paths between two junctions, 10x / 2x / 2x: both weak paths
    are accepted bulges of the same extremity, and only the first of them
    in link order is deleted there."""
    rng = np.random.default_rng(13)
    left, right = _rand(rng, 40), _rand(rng, 40)
    mids = [_rand(rng, 30) for _ in range(3)]
    return ([left + mids[0] + right] * 10 + [left + mids[1] + right] * 2
            + [left + mids[2] + right] * 2), 11, 1


def _errors(k, seed, glen=3000, rate=0.01, cover=30):
    """``cover``x of 150 bp reads, each base replaced with probability ``rate``
    by one of the other three (the shape of chip_smoke.py's phase-12
    banks, at a small size)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=glen, dtype=np.uint8)
    starts = rng.integers(0, glen - 150, size=glen * cover // 150)
    reads = codes[starts[:, None] + np.arange(150)]
    hit = rng.random(reads.shape) < rate
    reads = np.where(hit, (reads + rng.integers(1, 4, size=reads.shape,
                                                dtype=np.uint8)) & 3, reads)
    nts = np.frombuffer(b"ACTG", np.uint8)
    return [nts[r].tobytes().decode() for r in reads], k, 2


CASES = {
    "fork": _fork, "short_tip": _short_tip, "long_tip": _long_tip,
    "bulge": _bulge, "ec": _ec, "full": _full,
    "bubbly1": lambda: _bubbly(1), "bubbly2": lambda: _bubbly(2),
    "triple": _triple, "errors_k21": lambda: _errors(21, 3),
    "errors_k63": lambda: _errors(63, 4, rate=0.02, cover=100),
}


def _record(simp):
    """Wrap the three pass methods of one instance: each call logs (pass,
    removed, node_state after it)."""
    log = []
    for name in PASSES:
        def wrapped(f=getattr(simp, name), name=name):
            n = f()
            log.append((name, n, simp.graph.node_state.copy()))
            return n
        setattr(simp, name, wrapped)
    return log


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    seqs, k, amin = CASES[request.param]()
    tg = _graph(seqs, k, amin)
    jg = JGraph(k, tg.solid_limbs, tg.solid_counts)
    js, ts = jsm.Simplifications(jg), tsm.Simplifications(tg)
    # the first compaction (all live), kept from the run itself: simplify
    # reuses it from the cache
    jfirst = js._compact(jg.solid_limbs, jg.solid_counts)
    tfirst = ts._compact(*ts._rows(ts._live()))
    jlog, tlog = _record(js), _record(ts)
    return SimpleNamespace(name=request.param, k=k, tg=tg, jg=jg, js=js,
                           ts=ts, jfirst=jfirst, tfirst=tfirst, jlog=jlog,
                           tlog=tlog, jstats=js.simplify(),
                           tstats=ts.simplify())


def test_simplify_matches_jax(run):
    """node_state after every pass, the stats, the pass counters and the
    removal strings."""
    assert vars(run.tstats) == vars(run.jstats)
    assert isinstance(run.tstats, tsm.SimplifyStats)
    for f in ("nb_tip_passes", "nb_bulge_passes", "nb_ec_passes",
              "tip_removal", "bubble_removal", "ec_removal"):
        assert getattr(run.ts, f) == getattr(run.js, f), f
    assert [x[:2] for x in run.tlog] == [x[:2] for x in run.jlog]
    for (name, _, a), (_, _, b) in zip(run.tlog, run.jlog):
        assert a.dtype == b.dtype == np.uint8
        assert np.array_equal(a, b), name
    assert np.array_equal(run.tg.node_state, run.jg.node_state)
    expect_removal = {"short_tip", "bulge", "ec", "full", "triple",
                      "errors_k21", "errors_k63"}
    if run.name in expect_removal:
        assert (run.tg.node_state & 1).any()


def test_full_sweep_matches_jax(run):
    r, f = run.ts._full_ranks, run.ts._full_flips
    assert r.dtype == torch.int32 and f.dtype == torch.int8
    assert r.shape == (run.tg.nb_nodes, 8)
    assert np.array_equal(r.numpy(), run.js._full_ranks)
    assert np.array_equal(f.numpy(), run.js._full_flips)


def test_first_compaction_matches_jax(run):
    """build_unitigs(precomputed=, lazy_sequences=True) and
    link_unitigs(precomputed=): the node maps, means, links, and the
    sequences, spelled only now, after the later passes deleted nodes."""
    (tus, tug), (jus, jug) = run.tfirst, run.jfirst
    assert isinstance(tus.sequences, LazySequences)
    assert tus.sequences._mat is None          # not spelled by any pass
    assert np.array_equal(tus.sequences.lengths(), jus.sequences.lengths())
    for f in ("kmer_counts", "node_unitig", "node_pos", "node_strand"):
        x, y = getattr(tus, f), getattr(jus, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert tus.mean_abundance.tobytes() == jus.mean_abundance.tobytes()
    for f in ("link_offsets", "link_targets"):
        x, y = getattr(tug, f), getattr(jug, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert list(tug.sequences) == list(jug.sequences)
    assert tus.sequences._mat is not None
    # the port's links of the same set without the sweep
    again = tgu.link_unitigs(run.tg._padded_table(), tus, run.k,
                             device="cpu")
    assert np.array_equal(again.link_targets, jug.link_targets)


def test_rctc_on_every_extremity(run):
    (_, tug), (_, jug) = run.tfirst, run.jfirst
    chain = run.js._chain_abundance(jug)
    got = run.ts._chain_abundance(tug)
    assert got.dtype == torch.float64 and got.numpy().tobytes() == \
        chain.tobytes()
    ends = np.arange(2 * jug.nb_unitigs)
    for cutoff in (2.0, 4.0):
        want = run.js._satisfy_rctc_batch(jug, ends, chain[ends >> 1],
                                          cutoff)
        ok = run.ts._satisfy_rctc_batch(tug, ends, chain[ends >> 1], cutoff)
        assert ok.dtype == torch.bool
        assert np.array_equal(ok.numpy(), want)


def _bulge_candidates(simp, ug, k):
    """(starts, targets, avoids, maxlens) of JAX's remove_bulges, numpy."""
    deg = np.asarray(ug.out_degree_oriented(), np.int64)
    nk = np.asarray(ug.kmer_counts, np.int64)
    lens = np.asarray(ug.unitig_lengths(), np.int64)
    link_t, link_o = ug.link_targets, ug.link_offsets
    max_bulge = max(int(k * simp.BULGE_LEN_KMULT), k + simp.BULGE_LEN_KADD)
    rows = []
    for a in np.nonzero(deg >= 2)[0]:
        for t in link_t[link_o[a]:link_o[a + 1]]:
            a, t = int(a), int(t)
            ui = t >> 1
            if t == (a ^ 1) or nk[ui] <= 1 or lens[ui] > max_bulge \
                    or deg[t] == 0:
                continue
            f0 = int(link_t[link_o[t]])
            if deg[f0 ^ 1] > 1:
                pl = int(nk[ui]) - 1
                rows.append((a, f0, t, max(int(pl * 1.1), pl + 3)))
    return np.asarray(rows, np.int64).reshape(-1, 4)


def test_hmcp_batch_on_every_bulge_candidate(run):
    """The lockstep walker's result (NaN positions included) and fallback
    flags, and the recursion on each flagged candidate."""
    (_, tug), (_, jug) = run.tfirst, run.jfirst
    backtrack = run.k + jsm.Simplifications.BULGE_ALTPATH_KADD
    c = _bulge_candidates(run.js, jug, run.k)
    res, fb = run.js._hmcp_batch(jug, c[:, 0], c[:, 1], c[:, 2], c[:, 3],
                                 backtrack)
    got, gfb = run.ts._hmcp_batch(tug, c[:, 0], c[:, 1], c[:, 2], c[:, 3],
                                  backtrack)
    assert got.dtype == torch.float64 and gfb.dtype == torch.bool
    assert np.array_equal(gfb.numpy(), fb)
    assert got.numpy().tobytes() == res.tobytes()
    for i in np.nonzero(fb)[0]:
        a, f0, t, ml = (int(x) for x in c[i])
        assert run.ts._hmcp_unitigs(tug, a, f0, avoid=t, maxlen=ml,
                                    backtrack_limit=backtrack) == \
            run.js._hmcp_unitigs(jug, a, f0, avoid=t, maxlen=ml,
                                 backtrack_limit=backtrack)
    if run.name in ("bulge", "triple", "errors_k21"):
        assert len(c) and not np.isnan(res).all()


def test_unitig_graph_of_simplified_graph(run):
    ug, want = run.tg.unitig_graph(), run.jg.unitig_graph()
    assert list(ug.sequences) == list(want.sequences)
    assert ug.mean_abundance.tobytes() == want.mean_abundance.tobytes()
    for f in ("kmer_counts", "link_offsets", "link_targets"):
        assert np.array_equal(getattr(ug, f), getattr(want, f)), f
    assert "postsolid_time.unitigs" in run.tg.info


def test_several_accepted_links_of_one_extremity():
    """On the three-path motif both weak paths are accepted at the same
    extremity; the first in link order is the one deleted, as in JAX."""
    seqs, k, amin = _triple()
    tg = _graph(seqs, k, amin)
    jg = JGraph(k, tg.solid_limbs, tg.solid_counts)
    js, ts = jsm.Simplifications(jg), tsm.Simplifications(tg)
    _, jug = js._compact(jg.solid_limbs, jg.solid_counts)
    c = _bulge_candidates(js, jug, k)
    alt, fb = js._hmcp_batch(jug, c[:, 0], c[:, 1], c[:, 2], c[:, 3],
                             k + 50)
    for i in np.nonzero(fb)[0]:
        got = js._hmcp_unitigs(jug, int(c[i, 0]), int(c[i, 1]),
                               avoid=int(c[i, 2]), maxlen=int(c[i, 3]),
                               backtrack_limit=k + 50)
        alt[i] = np.nan if got is None else got
    chain = js._chain_abundance(jug)
    accept = ~np.isnan(alt) & (chain[c[:, 2] >> 1] <= alt * 1.1)
    assert np.bincount(c[accept, 0]).max() >= 2
    assert ts.remove_bulges() == js.remove_bulges() > 0
    assert np.array_equal(tg.node_state, jg.node_state)


def test_rctc_sum_order_matches_numpy():
    """Three contributions 2^53, 1, 1 to one branching entry: numpy adds
    them in array order (the 1s are lost one at a time), another order
    keeps them, and the decision flips with it."""
    big = float(2 ** 53)
    # unitig 0 is the path; its end 0 enters unitig 1 (single k-mer) at
    # oriented id 2; out_links(3) = [1 (back to the path), 4, 6] and
    # out_links(2) = [8]
    links = {0: [2], 2: [8], 3: [1, 4, 6]}
    offs = np.zeros(11, np.int64)
    for o, t in links.items():
        offs[o + 1] = len(t)
    offs = np.cumsum(offs)
    targets = np.asarray([t for o in range(10) for t in links.get(o, [])],
                         np.int64)
    means = np.asarray([1.0, 1.0, big, 1.0, 1.0], np.float32)
    kc = np.ones(5, np.int32)
    seqs = ["A" * 11] * 5
    jug = jgu.UnitigGraph(11, seqs, means, kc, offs, targets)
    tug = tgu.UnitigGraph(11, seqs, means, kc, offs, targets)
    forward = (big + 1.0) + 1.0
    assert forward != big + (1.0 + 1.0)
    path = np.asarray([forward / 3.0 / 2.0])
    ends = np.asarray([0])
    g = SimpleNamespace(kmer_size=11, device=torch.device("cpu"))
    want = jsm.Simplifications(g)._satisfy_rctc_batch(jug, ends, path, 2.0)
    got = tsm.Simplifications(g)._satisfy_rctc_batch(tug, ends, path, 2.0)
    assert not want[0] and got.tolist() == want.tolist()
    # the other order would have accepted it
    assert (big + (1.0 + 1.0)) / 3.0 > 2.0 * path[0]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_phase12_constants_match_jax():
    """chip_smoke.py phase 12(a)'s JAX constants: JAX's simplify() and
    Monument contigs on the error bank (k=31, abundance-min 2, 1.16M
    nodes), the table counted by the port on the CPU. About 4 minutes."""
    from gatb_core_tpu_torch import count_kmers

    cs = _chip_smoke()
    bank = cs.ERROR_BANKS["a"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.fa")
        with open(path, "wb") as f:
            cs.write_reads(f, cs.error_reads(**bank["reads"]), 0)
        res = count_kmers(path, kmer_size=bank["k"], abundance_min=2,
                          device="cpu")
    jg = JGraph(bank["k"], res.solid_kmers, res.solid_counts)
    stats = jg.simplify()
    simp = jg._simplifications
    seqs, _ = jg.contigs(traversal="monument")
    assert cs.simplify_record(jg, simp, stats, seqs) == cs.JAX_BANK_A

"""The port's span recorder (``misc/time_info``): spans nest per thread
and share their root, recording is on only under a profiler or inside
``recording()``, the ``TimeInfo`` stopwatches read the spans' stamps, and
a graph build, its unitigs, the query API, ``simplify()`` and Monument
``contigs()`` record every layer's span under the parents they belong
to, with their counts and with ``info`` unchanged. The ``cuda``
test holds the spans to the device's events on one clock.

The file imports neither jax nor gatb_core_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import contextlib
import math
import threading
import time

import numpy as np
import pytest
import torch

from gatb_core_tpu_torch import BankStrings, Graph, count_kmers
from gatb_core_tpu_torch.kmer.counting import CountConfig, SortingCount
from gatb_core_tpu_torch.misc import time_info as T


@pytest.fixture(autouse=True)
def fresh():
    T.clear_spans()
    yield
    T.clear_spans()


def _reads(k=31, n=400, seed=7):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=n))
    step = max(1, k // 3)
    return [genome[i:i + 2 * k] for i in range(0, n - 2 * k, step)] * 2


def _create(seqs, k=31, device="cpu", **kw):
    return Graph.create(BankStrings(*seqs), kmer_size=k, abundance_min=1,
                        batch_reads=16, batch_len=128, device=device,
                        superbatch_rows=1 << 13, **kw)


def _by_name(spans):
    out = {}
    for sp in spans:
        out.setdefault(sp.name, []).append(sp)
    return out


def test_spans_nest_per_thread():
    seen = {}
    with T.recording():
        with T.span("a.outer") as a:
            with T.span("a.inner") as b:
                with T.span("a.leaf") as c:
                    pass

            def other():
                # this thread's stack is empty: a root, unless named
                with T.span("t.alone") as x:
                    seen["alone"] = x
                with T.span("t.child", parent=a) as y:
                    with T.span("t.grandchild") as z:
                        seen["child"], seen["grand"] = y, z

            t = threading.Thread(target=other)
            t.start()
            t.join()
        with T.span("b.next") as d:
            pass
    assert a.parent is None and a.root == a.id
    assert (b.parent, b.root) == (a.id, a.id)
    assert (c.parent, c.root) == (b.id, a.id)
    assert d.parent is None and d.root == d.id != a.id
    x, y, z = seen["alone"], seen["child"], seen["grand"]
    assert x.parent is None and x.root == x.id
    assert (y.parent, y.root) == (a.id, a.id)
    assert (z.parent, z.root) == (y.id, a.id)
    assert x.thread == y.thread == z.thread != a.thread
    assert a.t0_ns <= b.t0_ns <= c.t0_ns <= c.t1_ns <= b.t1_ns <= a.t1_ns
    # kept when they close: innermost first
    names = [sp.name for sp in T.spans()]
    assert names.index("a.leaf") < names.index("a.inner") \
        < names.index("a.outer")
    assert set(names) == {"a.outer", "a.inner", "a.leaf", "t.alone",
                          "t.child", "t.grandchild", "b.next"}
    assert T.current() is T.NULL_SPAN


def test_off_by_default_and_the_shared_null_span():
    assert not T.is_recording()
    s1, s2 = T.span("x.y"), T.span("x.z", sync=True, parent=None)
    assert s1 is s2 is T.NULL_SPAN
    with s1 as got:
        got.count(n=3)
    assert T.spans() == [] and T.dropped() == 0
    # a stopwatch still times with recording off
    ti = T.TimeInfo()
    with ti.section("a", span="x.a") as sec:
        time.sleep(0.002)
    assert sec.seconds >= 0.002 and ti.entries["a"] == sec.seconds
    assert T.spans() == []


def test_on_under_a_profiler_and_inside_recording():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert T.is_recording()
        with T.span("p.on") as sp:
            sp.count(k=2)
            sp.count(k=1)
    assert not T.is_recording() and T.span("p.off") is T.NULL_SPAN
    with T.recording():
        with T.recording():
            pass
        assert T.is_recording()
        with T.span("r.on"):
            pass
    assert not T.is_recording() and T.span("r.off") is T.NULL_SPAN
    got = _by_name(T.spans())
    assert got["p.on"][0].counts == {"k": 3}
    assert set(got) == {"p.on", "r.on"}


def test_the_list_is_bounded(monkeypatch):
    monkeypatch.setattr(T, "SPAN_CAP", 5)
    with T.recording():
        for i in range(8):
            with T.span(f"b.{i}"):
                pass
    assert [sp.name for sp in T.spans()] == [f"b.{i}" for i in range(5)]
    assert T.dropped() == 3
    T.clear_spans()
    assert T.spans() == [] and T.dropped() == 0


def test_threads_lose_no_span(monkeypatch):
    """More threads than cores record at once into a list that fills:
    every span is kept or counted as dropped, none lost."""
    import os
    import sys

    monkeypatch.setattr(T, "SPAN_CAP", 3000)
    n_threads, each = 2 * (os.cpu_count() or 2) + 2, 400
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with T.recording():
            def work():
                for _ in range(each):
                    with T.span("w.outer"):
                        with T.span("w.inner"):
                            pass

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    kept = T.spans()
    assert len(kept) == 3000
    assert len(kept) + T.dropped() == 2 * n_threads * each
    assert len({sp.id for sp in kept}) == len(kept)
    for sp in kept:
        if sp.name == "w.inner":
            assert sp.parent is not None


def test_sync_is_a_no_op_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with T.recording():
        with T.span("s.synced", sync=True):
            pass
        with T.TimeInfo().section("s", span="s.section", sync=True):
            pass
    assert not torch.cuda.is_initialized()
    assert {sp.name for sp in T.spans()} == {"s.synced", "s.section"}


def test_time_info_reads_its_spans_stamps():
    ti = T.TimeInfo()
    with T.recording():
        for _ in range(3):
            with ti.section("a", span="ti.a"):
                time.sleep(0.001)
        with ti.section("b"):                  # a stopwatch with no span
            pass
    spans = _by_name(T.spans())
    assert set(spans) == {"ti.a"}
    total = 0.0
    for sp in spans["ti.a"]:
        total += (sp.t1_ns - sp.t0_ns) / 1e9
    assert math.isclose(ti.entries["a"], total, rel_tol=1e-12)
    props = ti.get_properties("time")
    assert set(props) == {"time", "time.a", "time.b"}
    assert set(ti.get_properties("t", total=False)) == {"t.a", "t.b"}


def test_exec_time_is_the_count_span():
    seqs = _reads()
    dsk = SortingCount(CountConfig(kmer_size=31, abundance_min=1,
                                   batch_reads=16, batch_len=128,
                                   superbatch_rows=1 << 13, device="cpu"))
    with T.recording():
        dsk.run(BankStrings(*seqs))
    (count,) = _by_name(T.spans())["count"]
    secs = (count.t1_ns - count.t0_ns) / 1e9
    assert dsk.info["exec_time"] == round(secs, 3)
    assert math.isclose(dsk.time_info.entries["execute"], secs,
                        rel_tol=1e-12)
    assert count.counts["superbatches"] >= 1


def test_replays_are_counted():
    """A distinct-ratio hint far below the bank's makes the fold's
    compact table overflow: those superbatches are dispatched again."""
    seqs = _reads(n=3000, seed=11)
    kw = dict(kmer_size=31, abundance_min=1, batch_reads=16, batch_len=128,
              superbatch_rows=1 << 13, device="cpu")
    want = count_kmers(BankStrings(*seqs), **kw)
    with T.recording():
        got = count_kmers(BankStrings(*seqs), distinct_ratio_hint=1e-6,
                          **kw)
    (count,) = _by_name(T.spans())["count"]
    assert count.counts["replays"] >= 1
    assert count.counts["superbatches"] > count.counts["replays"]
    assert got.as_dict() == want.as_dict()


def _count_spans(nb_passes, **kw):
    """(result, the count's spans by name, every span by id) of a count
    of one bank in ``nb_passes`` passes."""
    T.clear_spans()
    with T.recording():
        res = count_kmers(BankStrings(*_reads(n=3000, seed=11)),
                          kmer_size=31, abundance_min=1, batch_reads=16,
                          batch_len=128, superbatch_rows=1 << 13,
                          device="cpu", nb_passes=nb_passes, **kw)
    spans = T.spans()
    return res, _by_name(spans), {sp.id: sp for sp in spans}


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "no_cache"])
def test_passes_and_the_bank_cache_are_counted(cache):
    """The ``count`` span counts the ``passes`` run and the later passes'
    superbatches ``cached`` or ``reparsed``, and the cache's bytes after
    pass 0; ``count.collect`` opens once under ``count.process`` where
    several passes have solid rows to merge, never in one pass."""
    one, got, _ = _count_spans(1)
    (c1,) = got["count"]
    assert "count.collect" not in got
    s0 = c1.counts["superbatches"]
    assert s0 >= 2 and "replays" not in c1.counts
    assert {n: c1.counts[n] for n in ("passes", "cached", "reparsed",
                                      "cache_bytes")} \
        == {"passes": 1, "cached": 0, "reparsed": 0, "cache_bytes": 0}
    three, got, byid = _count_spans(3, **({} if cache
                                          else {"bank_cache_bytes": 0}))
    (c3,) = got["count"]
    (collect,) = got["count.collect"]
    assert byid[collect.parent].name == "count.process"
    assert c3.counts["passes"] == 3 and "replays" not in c3.counts
    assert c3.counts["superbatches"] == 3 * s0
    if cache:
        assert (c3.counts["cached"], c3.counts["reparsed"]) == (2 * s0, 0)
        assert c3.counts["cache_bytes"] > 0
    else:
        assert (c3.counts["cached"], c3.counts["reparsed"]) == (0, 2 * s0)
        assert c3.counts["cache_bytes"] == 0
    assert three.as_dict() == one.as_dict()


@pytest.mark.parametrize("k", [31, 63])
def test_count_and_build_counters(k):
    """The ``count`` span counts its row width (``limbs``), the k-mer
    ``windows`` counted and the ``distinct`` rows after the reduce;
    ``graph.build`` its row width and ``nodes``: the info's numbers."""
    seqs = _reads(k=k)
    with T.recording():
        g = _create(seqs, k=k)
    got = _by_name(T.spans())
    (count,), (build,) = got["count"], got["graph.build"]
    w = (2 * k + 31) // 32
    assert count.counts["limbs"] == build.counts["limbs"] == w
    assert count.counts["windows"] == g.info["kmers_nb_valid"] > 0
    assert count.counts["distinct"] == g.info["kmers_nb_distinct"] > 0
    assert build.counts["nodes"] == g.nb_nodes == len(g.solid_counts)


# (span, its parent's name, on the build's main thread)
EXPECTED = [
    ("count", None, True),
    ("count.parse", "count", False),
    ("count.parse_wait", "count", True),
    ("count.stage", "count", True),
    ("count.dispatch", "count", True),
    ("count.resolve", "count", True),
    ("count.merge", "count", True),
    ("count.merge_wait", "count.merge", True),
    ("count.process", "count", True),
    ("count.fetch_wait", "count.process", True),
    ("graph.build", None, True),
    ("graph.mphf", "graph.build", True),
    ("graph.debloom", "graph.build", True),
    ("graph.branching", "graph.build", True),
    ("graph.adjacency", "graph.branching", True),
    ("unitigs.build", None, True),
    ("graph.node_index", None, True),
    ("graph.adjacency_masks", None, True),
]
QUERY = {"graph.node_index": ["query.staging", "query.fetch"],
         "graph.adjacency_masks": ["query.staging", "query.candidates",
                                   "query.fetch"]}


def test_a_build_and_its_queries_record_every_span():
    # the device chain waits for its solid rows' copy in count.fetch_wait
    seqs = _reads()
    with T.recording():
        g = _create(seqs)
        g.unitig_graph()
        q = g.solid_limbs[:32]
        g.node_index(q)
        g.adjacency_masks(q)
    spans = T.spans()
    byid = {sp.id: sp for sp in spans}
    got = _by_name(spans)
    main = threading.get_ident()
    for name, parent, on_main in EXPECTED:
        assert name in got, name
        for sp in got[name]:
            up = byid[sp.parent].name if sp.parent is not None else None
            assert up == parent, (name, up)
            assert (sp.thread == main) == on_main, name
            assert sp.t0_ns <= sp.t1_ns
    for root, kids in QUERY.items():
        (r,) = got[root]
        assert {sp.name for sp in spans if sp.parent == r.id} == set(kids)
        assert all(sp.root == r.id for sp in spans if sp.parent == r.id)
    # every span of the build lies under its root, and only the spans of
    # the table above are recorded (the build's adjacency sweep opens no
    # query span)
    assert set(got) == {n for n, _, _ in EXPECTED} | {
        n for kids in QUERY.values() for n in kids}
    for sp in spans:
        root = byid[sp.root]
        assert root.parent is None
        assert root.t0_ns <= sp.t0_ns <= sp.t1_ns <= root.t1_ns
    assert {byid[sp.root].name for sp in got["query.staging"]} == set(QUERY)
    (count,) = got["count"]
    assert count.counts["superbatches"] >= 1
    assert count.counts.get("replays", 0) == 0
    # the stopwatches read the spans' stamps
    assert g.info["exec_time"] == round(
        (count.t1_ns - count.t0_ns) / 1e9, 3)
    assert g.info["fillsolid_time.4.process"] == round(
        sum((sp.t1_ns - sp.t0_ns) / 1e9 for sp in got["count.process"]), 3)


# Graph.info after Graph.create with the defaults, then unitig_graph();
# and a count's info: the reference's surface, held as it was
GRAPH_INFO = {
    "abundance_max", "abundance_min", "bloom_nb_hash", "bloom_size_bits",
    "debloom_kind", "device", "exec_time", "fillsolid_time",
    "fillsolid_time.1.stack", "fillsolid_time.2.sort",
    "fillsolid_time.3.merge", "fillsolid_time.4.process", "kmer_size",
    "kmers_nb_distinct", "kmers_nb_invalid", "kmers_nb_solid",
    "kmers_nb_valid", "kmers_nb_weak", "nb_cfp", "nb_passes_effective",
    "nbits_per_kmer", "parser", "postsolid_time",
    "postsolid_time.adjacency", "postsolid_time.branching",
    "postsolid_time.debloom", "postsolid_time.mphf", "seq_size_deviation",
    "seq_size_max", "seq_size_mean", "seq_size_min", "sequences_number",
    "sequences_size", "time.fill_partitions", "time.fill_solid_kmers",
    "time_fill", "time_merge"}
COUNT_INFO = GRAPH_INFO - {
    "bloom_nb_hash", "bloom_size_bits", "debloom_kind", "exec_time",
    "nb_cfp", "nbits_per_kmer", "postsolid_time", "postsolid_time.adjacency",
    "postsolid_time.branching", "postsolid_time.debloom",
    "postsolid_time.mphf"}


@pytest.mark.parametrize("recording", [False, True])
def test_info_keys_unchanged(recording):
    seqs = _reads()
    with T.recording() if recording else contextlib.nullcontext():
        g = _create(seqs)
        assert set(g.info) == GRAPH_INFO
        g.unitig_graph()
        assert set(g.info) == GRAPH_INFO | {"postsolid_time.unitigs"}
        r = count_kmers(BankStrings(*seqs), kmer_size=31, abundance_min=1,
                        device="cpu")
        assert set(r.info) == COUNT_INFO


def _error_reads(k=21, glen=3000, seed=11):
    """Reads with 1% substitutions at 40x: tips and bubbles to remove."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, glen)
    reads = []
    for st in rng.integers(0, glen - 100, glen * 40 // 100):
        r = genome[st:st + 100].copy()
        hit = rng.random(100) < 0.01
        r[hit] = (r[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        reads.append("".join("ACGT"[c] for c in r))
    return reads


MINIA = {"simplify": {"simplify.tips", "simplify.bulges", "simplify.ecs",
                      "simplify.compact"},
         "contigs": {"contigs.compact", "contigs.view", "contigs.walk"}}


def test_minia_spans_nest_and_count():
    """``simplify()`` and Monument ``contigs()`` each record one synced
    root whose stages nest under it, with the counts of what they did;
    nothing records outside ``recording()``, and ``info`` gains the same
    two keys either way."""
    seqs = _error_reads()
    g = Graph.create(BankStrings(*seqs), kmer_size=21, abundance_min=2,
                     batch_reads=64, batch_len=128, device="cpu",
                     superbatch_rows=1 << 13)
    before = set(g.info)
    plain = g.simplify(), g.contigs(traversal="monument")[0]
    assert T.spans() == []
    assert set(g.info) - before == {"postsolid_time.simplify",
                                    "postsolid_time.contigs"}
    g.reset_node_state()
    with T.recording():
        stats = g.simplify()
        contigs, _ = g.contigs(traversal="monument")
    assert (stats, contigs) == plain
    got = _by_name(T.spans())
    assert set(got) == {"simplify", "contigs"} | MINIA["simplify"] \
        | MINIA["contigs"]
    for root, stages in MINIA.items():
        (top,) = got[root]
        assert top.parent is None
        for name in stages:
            assert all(sp.root == top.id for sp in got[name]), name
            assert top.t0_ns <= min(sp.t0_ns for sp in got[name])
            assert max(sp.t1_ns for sp in got[name]) <= top.t1_ns
    for name in ("simplify.tips", "simplify.bulges", "simplify.ecs"):
        assert all(sp.parent == got["simplify"][0].id for sp in got[name])
    s = g._simplifications
    assert got["simplify"][0].counts == {
        "passes": stats.passes, "tips": stats.tips_removed,
        "bulges": stats.bulges_removed, "ecs": stats.ec_removed,
        "deleted": int((g.node_state & 1).sum()), "walker": s.walked,
        "fallbacks": s.fallbacks}
    assert stats.tips_removed > 0 and stats.bulges_removed > 0
    assert s.walked >= stats.bulges_removed
    for name, total in (("simplify.tips", stats.tips_removed),
                        ("simplify.bulges", stats.bulges_removed),
                        ("simplify.ecs", stats.ec_removed)):
        assert sum(sp.counts["removed"] for sp in got[name]) == total
    c = got["contigs"][0].counts
    assert c["contigs"] == len(contigs) and c["bases"] == sum(
        map(len, contigs))
    assert c["starts"] >= len(contigs) > 0
    assert c["consensuses"] <= c["branchings"]
    assert set(c) == {"starts", "contigs", "bases", "branchings",
                      "consensuses"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _device_events(prof):
    dev = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == dev and e.duration_ns() > 0]


# the bound of "inside": in a process's first profiling session, as
# here and in the benchmark's traced runs, the profiler's device times
# were measured on the H100 to wander from time.time_ns() by up to 3.5
# ms (PERF.md §7); later sessions of one process wander further
SLACK_NS = 8_000_000


@pytest.mark.cuda
def test_spans_and_device_events_share_a_clock(cuda):
    """Under the profiler (CUDA activity only, as the benchmark traces):
    every ``extract_planes`` kernel lies inside its ``count`` span and
    starts after the first ``count.dispatch`` opened; the kernel of each
    query call (the last ``rank_rows`` launched for ``node_index`` and the
    last ``neighbor_masks`` for ``adjacency_masks``, by correlation id, so
    paired with no clock) lies inside the call's root span. Both within
    ``SLACK_NS``. Its profile must be the first with CUDA
    activity in its process: run the file alone, as the module's
    docstring does."""
    from torch.profiler import ProfilerActivity, profile

    seqs = _reads(n=20000, seed=3)
    _create(seqs, device=cuda)            # builds the kernels, unprofiled
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g = _create(seqs, device=cuda)
        q_rows = g.solid_limbs[::7]
        torch.cuda.synchronize()
        g.node_index(q_rows)
        g.adjacency_masks(q_rows)
        torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA
    events = [(e.name(), e.correlation_id(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == dev and e.duration_ns() > 0]
    got = _by_name(T.spans())
    (count,) = got["count"]
    first = min(sp.t0_ns for sp in got["count.dispatch"])
    extract = [e for e in events if "extract_planes" in e[0]]
    assert extract
    for _, _, s, e in extract:
        assert first - SLACK_NS <= s and e <= count.t1_ns + SLACK_NS
    calls = sorted(got["graph.node_index"] + got["graph.adjacency_masks"],
                   key=lambda sp: sp.t0_ns)
    assert [sp.name for sp in calls] == ["graph.node_index",
                                         "graph.adjacency_masks"]
    kernels = [max((e for e in events if name in e[0]), key=lambda e: e[1])
               for name in ("rank_rows", "neighbor_masks")]
    for (_, _, s, e), sp in zip(kernels, calls):
        assert sp.t0_ns - SLACK_NS <= s and e <= sp.t1_ns + SLACK_NS, \
            (sp.name, s - sp.t0_ns, sp.t1_ns - e)

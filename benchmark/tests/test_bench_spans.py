"""``benchmark/spans.py`` and the metrics that read the program's spans:
self time over planted spans, the traced steps' bounds, no reading
without spans, and the readers over the program's own spans in a CPU
run of each cell's driver."""

import json
import os
import shutil
import tempfile
from types import SimpleNamespace

import pytest

from bench_small import spec
from benchmark import harness, spans

MS = 1_000_000
NEW = {"ecoli_k31.dbg": ["count.parse_s", "count.parse_wait_s",
                         "count.device_wait_s", "count.fetch_wait_s",
                         "count.replay_pct", "graph.build_s",
                         "unitigs.build_s"],
       "chr14q_k31.query": ["query.staging_ms", "query.candidates_ms",
                            "query.fetch_ms"]}


def _span(i, name, t0, t1, parent=None, thread=1, **counts):
    return SimpleNamespace(id=i, parent=parent, root=None, name=name,
                           thread=thread, t0_ns=t0 * MS, t1_ns=t1 * MS,
                           counts=counts)


def _run(steps, traced=None, cell="ecoli_k31.dbg"):
    recs = [{"t0": a * MS, "t1": b * MS} for a, b in steps]
    return harness.Run(harness.load_spec(cell), 0.0, recs, 1.0, 0,
                       {"steps": len(recs) if traced is None else traced})


# one bank from 0 to 100 ms: count [0, 60] with its parse on another
# thread, dispatch [10, 20], resolve [20, 25] and a merge [30, 50] whose
# wait [40, 45]; graph.build [60, 90] with graph.mphf [60, 70]
PLANTED = [
    _span(1, "count", 0, 60, superbatches=4, replays=1),
    _span(2, "count.parse", 0, 55, parent=1, thread=2),
    _span(3, "count.dispatch", 10, 20, parent=1),
    _span(4, "count.resolve", 20, 25, parent=1),
    _span(5, "count.merge", 30, 50, parent=1),
    _span(6, "count.merge_wait", 40, 45, parent=5),
    _span(7, "graph.build", 60, 90),
    _span(8, "graph.mphf", 60, 70, parent=7),
]


def test_self_time_leaves_other_threads_children():
    got = spans.self_seconds(PLANTED)
    assert got["count"] == pytest.approx(0.060 - 0.010 - 0.005 - 0.020)
    assert got["count.parse"] == pytest.approx(0.055)
    assert got["count.merge"] == pytest.approx(0.015)
    assert got["graph.build"] == pytest.approx(0.020)
    assert spans.total_seconds(PLANTED)["graph.build"] == \
        pytest.approx(0.030)
    assert spans.counts(PLANTED, "count") == {"superbatches": 4,
                                              "replays": 1}
    # overlapping children are taken off once
    both = PLANTED + [_span(9, "count.stage", 12, 28, parent=1)]
    assert spans.self_seconds(both)["count"] == pytest.approx(
        0.060 - 0.018 - 0.020)


def test_per_step_reads_only_the_traced_steps():
    late = [_span(20 + s.id, s.name, s.t0_ns // MS + 200, s.t1_ns // MS
                  + 200, None if s.parent is None else 20 + s.parent,
                  s.thread, **s.counts) for s in PLANTED]
    run = _run([(0, 100), (200, 300)], traced=1)
    both = PLANTED + late
    assert len(spans.traced(run, both)) == len(PLANTED)
    assert spans.per_step(run, ["count.resolve", "count.merge_wait"],
                          within="count", spans=both) == \
        pytest.approx(0.010)
    assert spans.per_step(_run([(0, 100), (200, 300)]), ["count.resolve"],
                          within="count", spans=both) == \
        pytest.approx(0.005)
    # a span past its step's end, or in no step, is left out
    stray = [_span(40, "count", 90, 110), _span(41, "count", 150, 160)]
    assert spans.traced(run, stray) == []
    assert spans.per_step(run, ["count"], within="count",
                          spans=stray) is None
    # the holding call present, the stage never opened: 0
    assert spans.per_step(run, ["count.fetch_wait"], within="count",
                          spans=both) == 0


def test_per_step_reads_only_under_the_holding_calls(monkeypatch):
    """A build and a query in one step: the build's sweep opens a stage
    named as the query's; only the spans under the named calls count."""
    step = [
        _span(1, "graph.build", 0, 40),
        _span(2, "graph.adjacency", 5, 35, parent=1),
        _span(3, "query.candidates", 10, 30, parent=2),
        _span(4, "graph.node_index", 50, 60),
        _span(5, "query.staging", 50, 52, parent=4),
        _span(6, "graph.adjacency_masks", 60, 80),
        _span(7, "query.staging", 60, 63, parent=6),
        _span(8, "query.candidates", 63, 70, parent=6),
        _span(9, "query.fetch", 75, 80, parent=6),
    ]
    run = _run([(0, 100)])
    assert spans.per_step(run, ["query.candidates"],
                          within="graph.adjacency_masks", spans=step) == \
        pytest.approx(0.007)
    assert spans.per_step(run, ["query.staging"], within=spans.QUERY_CALLS,
                          spans=step) == pytest.approx(0.005)
    assert [sp.id for sp in spans.under(step, spans.QUERY_CALLS)] == \
        [4, 5, 6, 7, 8, 9]
    assert [sp.id for sp in spans.under(step, "graph.build")] == [1, 2, 3]
    # the readers, over the same step
    monkeypatch.setattr(spans, "program_spans", lambda: step)
    qrun = _run([(0, 100)], cell="chr14q_k31.query")
    for name, want in (("query.candidates_ms", 7), ("query.staging_ms", 5),
                       ("query.fetch_ms", 5)):
        assert harness.metric(name).read(qrun) == pytest.approx(want)
    # no holding call in the step: None, whatever stages were opened
    assert spans.per_step(run, ["query.candidates"],
                          within="graph.adjacency_masks",
                          spans=step[:3]) is None


def test_innermost_names_each_instant_once():
    got = spans.innermost(PLANTED, thread=1)
    assert [(n, s // MS, e // MS) for n, s, e in got] == [
        ("count", 0, 10), ("count.dispatch", 10, 20),
        ("count.resolve", 20, 25), ("count", 25, 30),
        ("count.merge", 30, 40), ("count.merge_wait", 40, 45),
        ("count.merge", 45, 50), ("count", 50, 60),
        ("graph.mphf", 60, 70), ("graph.build", 70, 90)]


@pytest.mark.parametrize("name", sum(NEW.values(), []))
def test_readers_find_nothing_without_spans(name, monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: [])
    cell = next(c for c, names in NEW.items() if name in names)
    assert harness.metric(name).read(_run([(0, 100)], cell=cell)) is None
    untraced = _run([(0, 100)], cell=cell)
    untraced.trace = None
    monkeypatch.setattr(spans, "program_spans", lambda: PLANTED)
    assert harness.metric(name).read(untraced) is None


def test_the_new_entries():
    bench = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    entries = {m["name"]: m for m in bench["per_layer"]}
    for cell, names in NEW.items():
        for name in names:
            m = entries[name]
            assert m["workloads"] == [cell]
            assert m["source"] == ("program_counter"
                                   if name == "count.replay_pct"
                                   else "program_span")
            assert name in {x["name"] for x in
                            harness.load_spec(cell).per_layer}
    # added at the end, after every entry that was there
    order = [m["name"] for m in bench["per_layer"]]
    assert order[-10:] == sum(NEW.values(), [])


def _traced_steps(cell, n):
    """``n`` steps of the cell's driver at a small size on the CPU, with
    the program's spans recorded, as a traced ``Run``."""
    from gatb_core_tpu_torch.misc import time_info

    s = spec(cell)
    work = tempfile.mkdtemp()
    try:
        ctx = harness.Context("cpu", 2**31 + 9, work)
        drv = s.driver.Driver(s.config, s.traffic, ctx)
        drv.setup()
        time_info.clear_spans()
        with time_info.recording():
            steps = [drv.step() for _ in range(n)]
        return harness.Run(s, 0.0, steps, 1.0, 0, {"steps": n})
    finally:
        shutil.rmtree(work, ignore_errors=True)


def test_dbg_readers_over_the_program():
    run = _traced_steps("ecoli_k31.dbg", 2)
    got = {n: harness.metric(n).read(run) for n in NEW["ecoli_k31.dbg"]}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["count.replay_pct"] == 0
    count = harness.metric("dbg.count_s").read(run)
    waits = sum(got[n] for n in ("count.parse_wait_s",
                                 "count.device_wait_s",
                                 "count.fetch_wait_s"))
    assert waits + harness.metric("count.process_s").read(run) \
        <= count + 0.002
    # the in-program twins of the spans the benchmark takes from outside
    for mine, outside in (("graph.build_s", "dbg.graph_s"),
                          ("unitigs.build_s", "dbg.unitigs_s")):
        ref = harness.metric(outside).read(run)
        assert abs(got[mine] - ref) <= max(0.1 * ref, 0.05), (mine, ref)
    json.dumps(got)


def test_query_readers_over_the_program():
    run = _traced_steps("chr14q_k31.query", 3)
    got = {n: harness.metric(n).read(run) for n in NEW["chr14q_k31.query"]}
    assert all(v is not None and v > 0 for v in got.values()), got
    mean_ms = sum(s["latency_s"] for s in run.steps) / 3 * 1e3
    assert sum(got.values()) <= mean_ms

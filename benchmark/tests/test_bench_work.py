"""The roofline's work functions, the trace reduction and the metric
readers on made-up runs."""

import os

import pytest

from benchmark import harness, trace, work


def test_query_bytes():
    # row 8 + bracketing row 8 + rank 4 + 8 candidate rows 64 + mask 1
    assert work.query_bytes(1, 2, 4) == 85
    assert work.query_bytes(72_704, 2, 8) == 72_704 * 89
    assert work.bound_s(3.35e12) == pytest.approx(1.0)
    assert work.bound_s(0, 67e12) == pytest.approx(1.0)


def test_summarize_union_and_gaps():
    ev = [("k1", 10, 20), ("k2", 15, 30), ("Memcpy HtoD", 50, 60),
          ("k1", 95, 120)]
    spans = [("a", 0, 40), ("b", 40, 100)]
    s = trace.summarize(ev, 0, 100, spans)
    assert s["busy_s"] == pytest.approx(35e-9)      # 10-30, 50-60, 95-100
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["device_s"] == pytest.approx(60e-9)
    assert s["kernel_s"] == pytest.approx(50e-9)
    gaps = dict(s["idle_gaps"])
    assert gaps["a"] == pytest.approx(10e-9)       # 0-10 (and 30-50 at 40)
    assert gaps["b"] == pytest.approx(55e-9)       # 30-50, 60-95
    assert s["device_ops"][0] == ("k1", pytest.approx(35e-9))


def test_summarize_empty():
    s = trace.summarize([], 0, 10, [])
    assert s["busy_s"] == 0 and dict(s["idle_gaps"]) == {
        "harness": pytest.approx(1e-8)}


def metric(name):
    return harness.load_module(os.path.join(harness.BENCH_DIR, "metrics",
                                            name + ".py"))


def test_readers():
    spec = harness.load_spec("chr14q_k31.query")
    steps = [{"t0": 0, "t1": 1, "work": 1000, "latency_s": x / 1000,
              "rank_bytes": 4, "spans": {}} for x in range(1, 101)]
    tr = {"window_s": 2.0, "busy_s": 0.5, "device_s": 0.1, "kernel_s": 0.05,
          "steps": 100}
    r = harness.Run(spec, 3.0, steps, 2.0, 2**30, tr)
    assert metric("queries_per_s").read(r) == pytest.approx(0.05)
    assert metric("query_p95_ms").read(r) == pytest.approx(95.05)
    assert metric("setup_s").read(r) == 3.0
    assert metric("query.device_ms").read(r) == pytest.approx(1.0)
    assert metric("query.host_ms").read(r) == pytest.approx(50.5 - 1.0)
    assert metric("device.idle_pct.query").read(r) == pytest.approx(75.0)
    assert metric("device.peak_gib.query").read(r) == 1.0
    least = 100_000 * 85 / 3.35e12
    assert metric("query_roofline").read(r) == pytest.approx(
        least / 0.05 * 100)
    r.trace = None
    assert metric("query_roofline").read(r) is None
    assert metric("device.idle_pct.query").read(r) is None


def test_dbg_readers():
    spec = harness.load_spec("ecoli_k31.dbg")
    steps = [{"t0": 0, "t1": 1, "work": 464e6,
              "spans": {"count": 5.0, "process": 2.0, "create": 6.5,
                        "unitigs": 0.8}}] * 4
    r = harness.Run(spec, 20.0, steps, 40.0, 0, {"device_s": 2.0,
                                                   "window_s": 40.0,
                                                   "busy_s": 4.0,
                                                   "kernel_s": 1.0,
                                                   "steps": 4})
    assert metric("bases_per_s").read(r) == pytest.approx(46.4)
    assert metric("dbg.count_s").read(r) == 5.0
    assert metric("count.process_s").read(r) == 2.0
    assert metric("dbg.graph_s").read(r) == 1.5
    assert metric("dbg.unitigs_s").read(r) == pytest.approx(0.8)
    assert metric("dbg.device_ms").read(r) == 500.0
    assert metric("device.idle_pct.build").read(r) == 90.0


def test_readers_use_the_traced_steps():
    """With a trace of the window's first steps, the device metrics are per
    traced step."""
    spec = harness.load_spec("chr14q_k31.query")
    steps = [{"t0": 0, "t1": 1, "work": 1000, "latency_s": 0.004 if i < 10
              else 0.002, "rank_bytes": 4, "spans": {}} for i in range(40)]
    tr = {"window_s": 1.0, "busy_s": 0.1, "device_s": 0.01,
          "kernel_s": 0.005, "steps": 10}
    r = harness.Run(spec, 3.0, steps, 2.0, 0, tr)
    assert metric("query.device_ms").read(r) == pytest.approx(1.0)
    assert metric("query.host_ms").read(r) == pytest.approx(3.0)
    assert metric("query_roofline").read(r) == pytest.approx(
        10_000 * 85 / 3.35e12 / 0.005 * 100)

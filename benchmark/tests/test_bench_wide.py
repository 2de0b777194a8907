"""The k 63 cell (``ecoli_k63.dbg``, judged by the exact wide reference)
and the count cell (``chr14q_k31.count``) at small sizes on the CPU:
through the harness, their controls, a planted fault, their sizes, the
count's roofline reader and what their modules load."""

from types import SimpleNamespace

import pytest

from bench_small import run
from benchmark import count_work, harness, spans, work
from test_bench_isolation import loaded_after

CELLS = ["ecoli_k63.dbg", "chr14q_k31.count"]
SIZES = {"ecoli_k63.dbg": {"genome_len": 6000},
         "chr14q_k31.count": {"genome_len": 6000}}
# the 32-bit fingerprints of the count's control collide only in a larger
# bank
CONTROL_SIZES = {"ecoli_k63.dbg": {"genome_len": 6000},
                 "chr14q_k31.count": {"genome_len": 60000}}


def spec(cell, sizes=SIZES):
    s = harness.load_spec(cell)
    s.config.update(sizes[cell])
    return s


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    rc, line, err = run(spec(cell))
    assert rc == 0, err
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"bases_per_s", "setup_s"}
    names = {"solid_kmers_diff", "count_diff", "histogram_diff",
             "valid_kmers_diff"}
    if cell == "ecoli_k63.dbg":
        names |= {"mask_diff", "branching_diff", "unitig_banks_differ",
                  "unitig_errors", "unitig_abundance_diff", "link_diff"}
    assert set(line["compared"]) == names
    assert all(v["limit"] == 0 and v["value"] == 0
               for v in line["compared"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    s = spec(cell, CONTROL_SIZES)
    compared, failed = s.driver.control(s.config, s.traffic, 2**31 + 17,
                                        "cpu")
    assert failed == 1
    assert compared["solid_kmers_diff"][0] > compared["solid_kmers_diff"][1]


def test_dropped_high_limb_is_not_correct(monkeypatch):
    from gatb_core_tpu_torch.debruijn.graph import Graph

    create = Graph.create.__func__

    def broken(cls, *a, **kw):
        g = create(cls, *a, **kw)
        g.solid_limbs = g.solid_limbs.copy()
        g.solid_limbs[:, 0] = 0
        return g

    monkeypatch.setattr(Graph, "create", classmethod(broken))
    rc, line, _ = run(spec("ecoli_k63.dbg"))
    assert rc == 0 and line["correct"] is False
    assert line["compared"]["solid_kmers_diff"]["value"] >= 1


def test_sizes_as_the_cells_state():
    e = spec("ecoli_k63.dbg", {"ecoli_k63.dbg": {}}).config
    q = spec("chr14q_k31.count", {"chr14q_k31.count": {}}).config
    e_reads = round(e["genome_len"] * e["coverage"] / e["read_len"])
    q_reads = round(q["genome_len"] * q["coverage"] / q["read_len"])
    assert (e["kmer_size"], e["read_len"]) == (63, 250)
    assert e_reads == 1_856_661 and e_reads * 250 == 464_165_250
    assert e_reads * (250 - 63 + 1) == 349_052_268
    assert q_reads == 9_178_616 and q_reads * 101 == 927_040_216
    assert q_reads * (101 - 31 + 1) == 651_681_736
    assert e["reduced"] == []


def _span(name, t0, t1, **counts):
    return SimpleNamespace(id=t0, parent=None, root=t0, name=name, thread=1,
                           t0_ns=t0, t1_ns=t1, counts=counts)


def _traced(steps, kernel_s):
    return harness.Run(harness.load_spec("chr14q_k31.count"), 0.0, steps,
                       1.0, 0, {"steps": len(steps), "kernel_s": kernel_s,
                                "device_s": kernel_s})


def test_count_roofline_reads_the_counters(monkeypatch):
    steps = [{"t0": 0, "t1": 100, "work": 1000},
             {"t0": 200, "t1": 300, "work": 1000}]
    planted = [_span("count", 10, 90, limbs=2, windows=700, distinct=300),
               _span("count", 210, 290, limbs=2, windows=700, distinct=300),
               _span("count", 400, 500, limbs=2, windows=10**9,
                     distinct=1)]
    monkeypatch.setattr(spans, "program_spans", lambda: planted)
    least = 2 * (2 * 700 * 8 + 300 * 12) + 2000 // 4
    assert count_work.count_bytes(700, 2, 300, 1000) \
        == 2 * 700 * 8 + 300 * 12 + 250
    got = harness.metric("count_roofline").read(_traced(steps, 1e-6))
    assert got == pytest.approx(least / work.PEAK_BYTES_S / 1e-6 * 100)
    assert harness.metric("count.device_ms").read(_traced(steps, 0.5)) \
        == pytest.approx(250.0)


def test_count_roofline_reads_nothing_without_counters(monkeypatch):
    """The program before the counters: its ``count`` spans carry only
    ``superbatches``, and the reader returns None."""
    steps = [{"t0": 0, "t1": 100, "work": 1000}]
    monkeypatch.setattr(spans, "program_spans",
                        lambda: [_span("count", 10, 90, superbatches=3)])
    assert harness.metric("count_roofline").read(_traced(steps, 1.0)) \
        is None
    monkeypatch.setattr(spans, "program_spans", lambda: [])
    assert harness.metric("count_roofline").read(_traced(steps, 1.0)) \
        is None


def test_new_modules_load_nothing_forbidden():
    """The wide reference loads nothing of the program; the new drivers,
    metrics and yardstick load no JAX."""
    top = loaded_after("import benchmark.reference.wide, "
                       "benchmark.reference.dbg_wide, benchmark.count_work\n")
    assert not top & {"gatb_core_tpu_torch", *harness.FORBIDDEN}
    top = loaded_after(
        "from benchmark import harness\n"
        "for c in ('ecoli_k63.dbg', 'chr14q_k31.count'):\n"
        "    s = harness.load_spec(c)\n"
        "    s.driver.Driver, s.driver.control\n"
        "    for m in s.per_layer + s.end_to_end:\n"
        "        harness.metric(m['name']).read\n")
    assert not top & set(harness.FORBIDDEN)

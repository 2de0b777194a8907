"""The Minia cell (``ecoli_rep_k31.minia``, driver ``minia_bank``) at a
small size on the CPU: through the harness against the plain reference,
with the program broken underneath, its control, its per-layer readers
over the program's own spans, and its entries in ``BENCHMARK.json``."""

import os
import shutil
import tempfile

import pytest

from bench_small import run
from benchmark import harness, spans
from test_bench_isolation import loaded_after

CELL = "ecoli_rep_k31.minia"
NEW = ["simplify.build_s", "contigs.build_s", "contigs.walk_s",
       "simplify.compact_s", "simplify.fallback_pct"]
COMPARED = {"solid_kmers_diff", "count_diff", "histogram_diff",
            "valid_kmers_diff", "mask_diff", "branching_diff",
            "deleted_diff", "simplify_stats_diff", "contig_diff",
            "minia_steps_differ"}


def spec():
    """The cell on a 20 kbp genome with its repeat families scaled down
    in step (4 rRNA-like copies of 600 bp, IS-like copies of two 350 bp
    types), every other number the configuration's."""
    s = harness.load_spec(CELL)
    s.config["genome_len"] = 20000
    rrn, is_ = s.config["repeats"]["families"]
    rrn.update(copies=4, mb=0.0024, share=0.12, consensus_len=600)
    is_.update(copies=8, mb=0.0024, share=0.1, consensus_len=350,
               consensi=2)
    return s


def test_cell_runs_correct():
    rc, line, err = run(spec())
    assert rc == 0, err
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"bases_per_s", "setup_s"}
    assert set(line["compared"]) == COMPARED
    assert all(v["limit"] == 0 and v["value"] == 0
               for v in line["compared"].values())


@pytest.mark.parametrize("fault", ["ec_pass_off", "contig_dropped"])
def test_broken_program_is_not_correct(monkeypatch, fault):
    from gatb_core_tpu_torch.debruijn.graph import Graph
    from gatb_core_tpu_torch.debruijn.simplifications import \
        Simplifications

    if fault == "ec_pass_off":
        def no_ec(self):
            self.nb_ec_passes += 1
            return 0

        monkeypatch.setattr(Simplifications, "remove_erroneous_connections",
                            no_ec)
        name = "simplify_stats_diff"
    else:
        contigs = Graph.contigs

        def dropped(self, *a, **kw):
            seqs, ab = contigs(self, *a, **kw)
            return seqs[1:], ab

        monkeypatch.setattr(Graph, "contigs", dropped)
        name = "contig_diff"
    rc, line, _ = run(spec())
    assert rc == 0 and line["correct"] is False
    assert line["compared"][name]["value"] >= 1
    assert line["failed"] >= 1


def test_control_is_not_correct():
    s = spec()
    compared, failed = s.driver.control(s.config, s.traffic, 2**31 + 17,
                                        "cpu")
    assert failed == 1
    assert compared["simplify_stats_diff"][0] > 0
    assert compared["solid_kmers_diff"][0] == 0


def _traced_steps(n):
    from gatb_core_tpu_torch.misc import time_info

    s = spec()
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


def test_readers_over_the_program():
    run_ = _traced_steps(2)
    got = {n: harness.metric(n).read(run_) for n in NEW}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["contigs.walk_s"] <= got["contigs.build_s"]
    assert got["simplify.compact_s"] <= got["simplify.build_s"]
    assert got["simplify.fallback_pct"] <= 100
    steps = run_.steps
    for metric, key in (("simplify.build_s", "simplify"),
                        ("contigs.build_s", "contigs")):
        outside = sum(st["spans"][key] for st in steps) / len(steps)
        assert got[metric] <= outside + 0.005


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_spans(name, monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: [])
    r = harness.Run(harness.load_spec(CELL), 0.0, [{"t0": 0, "t1": 10}],
                    1.0, 0, {"steps": 1})
    assert harness.metric(name).read(r) is None


def test_the_entries():
    bench = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    assert bench["workloads"][-1] == {
        "name": CELL, "config": "ecoli_rep_k31", "traffic": "minia",
        "chips": 1, "why": bench["workloads"][-1]["why"]}
    assert bench["configs"][-1]["name"] == "ecoli_rep_k31"
    assert bench["configs"][-1]["reduced"] == []
    order = [m["name"] for m in bench["per_layer"]]
    assert order[-len(NEW):] == NEW
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "bases_per_s"
    for name in ("device.idle_pct.build", "device.peak_gib.build",
                 "dbg.device_ms"):
        assert entries[name]["workloads"][-1] == CELL
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["bases_per_s"]["workloads"][-1] == CELL
    got = {m["name"] for m in harness.load_spec(CELL).per_layer}
    assert got == set(NEW) | {"device.idle_pct.build",
                              "device.peak_gib.build", "dbg.device_ms"}


def test_sizes_as_the_cell_states():
    c = harness.load_spec(CELL).config
    reads = round(c["genome_len"] * c["coverage"] / c["read_len"])
    assert reads == 3_094_435 and reads * 150 == 464_165_250
    assert (c["kmer_size"], c["abundance_min"]) == (31, 2)
    fams = {f["name"]: f for f in c["repeats"]["families"]}
    assert fams["rrn"]["copies"] == 7 and fams["IS"]["copies"] == 40
    # every rrn copy is a whole 5 kb operon; IS copies 1,100-1,400 bp
    rrn = fams["rrn"]
    assert rrn["mb"] * 1e6 / rrn["copies"] == rrn["consensus_len"] == 5000
    is_ = fams["IS"]
    mean = is_["mb"] * 1e6 / is_["copies"]
    assert (2 * mean - is_["consensus_len"], is_["consensus_len"]) \
        == (1100, 1400)


def test_the_reference_loads_nothing_of_the_program():
    top = loaded_after("import benchmark.reference.minia\n")
    assert not top & {"gatb_core_tpu_torch", *harness.FORBIDDEN}
    top = loaded_after("import sys\nsys.path.insert(0, 'benchmark/tests')\n"
                       "import test_bench_minia as t\n"
                       "rc, line, err = t.run(t.spec())\n"
                       "assert rc == 0 and line['correct'], err\n")
    assert "gatb_core_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)

"""The three-pass count cell (``chr14q_k31.count_lowmem``, driver
``count_bank_passes``) at a small size on the CPU: through the harness
against the plain reference, with the program broken underneath, its
control, its per-layer readers over the program's own spans, the plain
reference of the pass split, and its entries in ``BENCHMARK.json``."""

import os
import shutil
import tempfile

import numpy as np
import pytest

from bench_small import run
from benchmark import harness, spans
from test_bench_isolation import loaded_after

CELL = "chr14q_k31.count_lowmem"
NEW = ["count.collect_s", "count.cache_pct"]
OLD = ["bases_per_s", "dbg.count_s", "count.process_s", "count.parse_s",
       "count.parse_wait_s", "count.device_wait_s", "count.fetch_wait_s",
       "count.replay_pct", "count.device_ms", "count_roofline",
       "device.idle_pct.build", "device.peak_gib.build"]
COMPARED = {"solid_kmers_diff", "count_diff", "histogram_diff",
            "valid_kmers_diff", "passes_differ", "rows_unsorted",
            "pass_split_diff"}


def spec():
    """The cell on a 6 kbp genome, every other number the
    configuration's."""
    s = harness.load_spec(CELL)
    s.config["genome_len"] = 6000
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


@pytest.mark.parametrize("fault", ["one_pass", "pass_dropped", "unmerged",
                                   "all_in_pass_0"])
def test_broken_program_is_not_correct(monkeypatch, fault):
    from gatb_core_tpu_torch.kmer import counting as tc

    if fault == "one_pass":
        count = tc.count_kmers

        def one_pass(*a, **kw):
            kw["nb_passes"] = 1
            return count(*a, **kw)

        monkeypatch.setattr(tc, "count_kmers", one_pass)
        name = "passes_differ"
    elif fault == "pass_dropped":
        end_pass = tc._DeviceChain.end_pass

        def dropped(self, *a):
            end_pass(self, *a)
            if self.parts and len(self.parts) == 2:
                self.parts.pop()

        monkeypatch.setattr(tc._DeviceChain, "end_pass", dropped)
        name = "solid_kmers_diff"
    elif fault == "all_in_pass_0":
        # a pass filter that keeps every k-mer in pass 0 and none after:
        # the table comes out right, in one pass's memory
        dispatch = tc._FoldDriver.dispatch

        def all_in_pass_0(self, staged, pass_i, *a):
            if pass_i:
                return
            keep, self.nb_passes = self.nb_passes, 1
            try:
                dispatch(self, staged, pass_i, *a)
            finally:
                self.nb_passes = keep

        monkeypatch.setattr(tc._FoldDriver, "dispatch", all_in_pass_0)
        name = "pass_split_diff"
    else:
        import torch

        monkeypatch.setattr(tc, "_merge_solid_parts", lambda parts: (
            torch.cat([r for r, _ in parts]),
            torch.cat([c for _, c in parts])))
        name = "rows_unsorted"
    rc, line, _ = run(spec())
    assert rc == 0 and line["correct"] is False
    assert line["compared"][name]["value"] >= 1
    assert line["failed"] >= 1
    if fault == "all_in_pass_0":
        assert {n: v["value"] for n, v in line["compared"].items()
                if v["value"]} == {"pass_split_diff":
                                   line["compared"][name]["value"]}


def test_a_program_without_a_split_is_not_held_to_one():
    """A count that records no pass split (as before ``pass_distinct``)
    is judged on every other number."""
    s = spec()
    d = s.driver
    out = {"limbs": np.zeros((1, 2), np.uint32),
           "counts": np.full(1, 5, np.int32),
           "info": {"nb_passes_effective": 3}, "pass_distinct": None}
    compared, failed = d.judge(s.config, s.traffic, 5, "cpu", [out])
    assert "pass_split_diff" not in compared and failed == 1
    assert d.split_diff([3, 4, 5], [3, 4, 5]) == 0
    assert d.split_diff([12], [3, 4, 5]) == 9 + 4 + 5


def test_control_is_not_correct():
    """At the size ``test_bench_control`` takes: enough k-mers for the
    32-bit keys to collide."""
    s = spec()
    s.config["genome_len"] = 60000
    compared, failed = s.driver.control(s.config, s.traffic, 2**31 + 17,
                                        "cpu")
    assert failed == 1
    assert compared["solid_kmers_diff"][0] > 0


def test_ascending():
    d = harness.load_spec(CELL).driver
    rows = np.array([[0, 5], [0, 7], [1, 0], [2**32 - 1, 0]], np.uint32)
    assert d.ascending(rows) and d.ascending(rows[:1])
    assert not d.ascending(rows[::-1])
    assert not d.ascending(rows[[0, 0, 1]])


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
    run_ = _traced_steps(1)
    got = {n: harness.metric(n).read(run_) for n in NEW}
    assert got["count.cache_pct"] == 100
    assert 0 < got["count.collect_s"] \
        <= harness.metric("count.process_s").read(run_) + 0.005


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_spans(name, monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: [])
    r = harness.Run(harness.load_spec(CELL), 0.0, [{"t0": 0, "t1": 10}],
                    1.0, 0, {"steps": 1})
    assert harness.metric(name).read(r) is None


def test_the_entries():
    bench = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    (cell,) = [c for c in bench["workloads"] if c["name"] == CELL]
    assert cell == {"name": CELL, "config": "chr14q_k31_lowmem",
                    "traffic": "count_lowmem", "chips": 1,
                    "why": cell["why"]}
    assert harness.load_spec(CELL).traffic["nb_passes"] == 3
    entries = {m["name"]: m for m in bench["per_layer"] + bench["end_to_end"]}
    for name in NEW:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "bases_per_s"
        assert entries[name]["layer"] == entries["count.process_s"]["layer"]
    for name in OLD:
        assert CELL in entries[name]["workloads"]
    got = {m["name"] for m in harness.load_spec(CELL).per_layer}
    assert got == set(NEW) | set(OLD) - {"bases_per_s"}


def test_the_configuration_is_the_count_cells_bank_in_three_passes():
    """The deployment's file: ``chr14q_k31``'s bank, key for key, and the
    passes its table needs, which the mix runs."""
    s = harness.load_spec(CELL)
    q = harness.load_spec("chr14q_k31.count").config
    bank = set(q) - {"name", "source", "source_genome_len", "reduced",
                     "why_reduced", "program_defaults"}
    assert {k: s.config[k] for k in bank} == {k: q[k] for k in bank}
    assert s.config["reduced"] == ["genome_len"]
    d = s.config["deployment"]
    assert s.config["source_genome_len"] * d["distinct_per_base"] \
        == pytest.approx(d["distinct_rows"], rel=1e-4)
    assert d["distinct_rows"] * d["row_bytes"] == d["table_bytes"]
    assert s.config["nb_passes"] == s.traffic["nb_passes"] \
        == -(-d["table_bytes"] // d["card_bytes"])


def test_the_pass_split_matches_the_program_model():
    """The plain split's minimizer against the port's host model
    (``kmer/model.py``, the rule the extraction kernel is held to)."""
    import torch

    from benchmark.reference import passes as P
    from gatb_core_tpu_torch.kmer.model import (ModelMinimizer, canonical,
                                                 mmer_allowed_py)

    mm = torch.arange(1 << 12)
    assert [not b for b in P.banned(mm, 6).tolist()] \
        == [mmer_allowed_py(v, 6) for v in range(1 << 12)]
    rng = np.random.default_rng(3)
    for k in (21, 31):
        fwd = [int(x) for x in rng.integers(0, 1 << (2 * k), 2000)]
        model = ModelMinimizer(k, 10)
        got = P.minimizers(torch.tensor([canonical(v, k) for v in fwd]), k)
        assert got.tolist() == [model.minimizer(v) for v in fwd]


def test_the_reference_loads_nothing_of_the_program():
    top = loaded_after("import benchmark.reference.passes\n")
    assert not top & {"gatb_core_tpu_torch", *harness.FORBIDDEN}

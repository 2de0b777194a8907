"""BENCHMARK.json against the benchmark's contract, and the harness
finding every configuration, mix, driver and metric by its name."""

import json
import math
import os
import re

import pytest

from benchmark import harness

BENCH = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c[k] for c in BENCH["configs"] for k in ("source", "why")]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text
        assert "\t" not in text


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entry_keys(group, keys):
    """Each entry has exactly its group's keys; a metric may add
    ``workloads``."""
    for entry in BENCH[group]:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") \
            else set()
        assert keys <= set(entry) <= keys | extra, entry["name"]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


def test_check_fits_its_budget():
    runs = 2 + 14 * 24
    need = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    spec = harness.load_spec(cell)
    assert spec.cell["chips"] == 1
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "drivers",
                                       spec.traffic["driver"] + ".py"))
    assert hasattr(spec.driver, "Driver") and hasattr(spec.driver,
                                                      "control")
    e2e = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer
    for m in spec.end_to_end + spec.per_layer:
        path = os.path.join(harness.BENCH_DIR, "metrics",
                            m["name"] + ".py")
        assert hasattr(harness.load_module(path), "read")
    for m in spec.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(entry):
    path = os.path.join(harness.ROOT, entry["file"])
    assert entry["file"].startswith("benchmark/")
    cfg = harness.read_json(path)
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    reads = round(cfg["genome_len"] * cfg["coverage"] / cfg["read_len"])
    assert reads * cfg["read_len"] >= cfg["genome_len"]


def test_sizes_as_the_cells_state():
    e = harness.read_json(os.path.join(harness.BENCH_DIR, "configs",
                                       "ecoli_k31.json"))
    q = harness.read_json(os.path.join(harness.BENCH_DIR, "configs",
                                       "chr14q_k31.json"))
    assert round(e["genome_len"] * e["coverage"] / e["read_len"]) \
        == 3_094_435
    assert round(q["genome_len"] * q["coverage"] / q["read_len"]) \
        == 9_178_616
    assert math.isclose(q["genome_len"] * 4, q["source_genome_len"],
                        rel_tol=1e-6)


def test_a_new_metric_is_a_new_file(tmp_path):
    """A metric without ``workloads`` is reported by every cell that
    reports the metric it moves, and by no other."""
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({
        "name": "later.metric", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "ops kernels",
        "moves": "bases_per_s"})
    spec = harness.load_spec("ecoli_k31.dbg", bench=bench)
    assert "later.metric" in {m["name"] for m in spec.per_layer}
    spec = harness.load_spec("chr14q_k31.query", bench=bench)
    assert "later.metric" not in {m["name"] for m in spec.per_layer}

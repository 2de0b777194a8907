"""Runs one cell of ``BENCHMARK.json``: everything is found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
``configs/<config>.json`` holds the sizes, and a traffic mix, whose file
``traffic/<traffic>.json`` holds its parameters and names the driver
``drivers/<driver>.py`` that generates and runs it. Each metric the cell
reports (the end-to-end ones without a trace, the per-layer ones with)
is read from the run by ``metrics/<metric>.py``. A later cell, mix,
driver or metric is a new file and a new entry: nothing here changes.

A driver module defines ``Driver(config, traffic, ctx)`` with
``setup()`` (make the inputs, build what the cell holds, warm up every
shape), ``step()`` (one unit of the window's work; returns its record),
``release()`` (drop the program's state) and ``check()`` (the comparison
with the plain reference: ``({name: (value, limit)}, failed steps)``).
A step's record has ``t0`` and ``t1`` (``time.time_ns()``), ``work``
(the unit the cell's rate counts), ``spans`` (seconds by name) and
``host_spans`` ((name, start ns, end ns) of the host's stages, which
name the device's idle gaps).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that must not be loaded in a run: JAX, and the
# JAX package that the port ``gatb_core_tpu_torch`` is held to
FORBIDDEN = ("jax", "jaxlib", "flax", "gatb_core_tpu")


def load_module(path: str):
    name = "bench_" + os.path.relpath(path, BENCH_DIR).replace(
        "_", "__").replace(os.sep, "_s").replace(".", "_d")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric(name: str):
    """The reader module ``metrics/<name>.py``."""
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"))


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Spec:
    """One cell with what it names, loaded from the files."""

    cell: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def driver(self):
        return load_module(os.path.join(BENCH_DIR, "drivers",
                                        self.traffic["driver"] + ".py"))


def load_spec(name: str, bench: dict | None = None) -> Spec:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``)."""
    if bench is None:
        bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = read_json(os.path.join(ROOT, cfg["file"]))
    traffic = read_json(os.path.join(BENCH_DIR, "traffic",
                                     cell["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    return Spec(cell, config, traffic, e2e, per_layer)


class Context:
    """What a driver is given: the device, the seed, a private work
    directory under ``TMPDIR``, and the device's clock and memory."""

    def __init__(self, device: str, seed: int, workdir: str):
        import torch

        self.torch = torch
        self.device = device
        self.seed = int(seed)
        self.workdir = workdir
        self.cuda = torch.device(device).type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0


@dataclass
class Run:
    """What the metric readers read: one run's set-up, window, steps and
    (with ``--trace 1``) the device's trace reduced by ``trace.summarize``."""

    spec: Spec
    setup_s: float
    steps: list
    window_s: float
    window_peak_bytes: int
    trace: dict | None = None


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run(spec: Spec, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, out=sys.stdout, err=sys.stderr) -> int:
    """Set up, warm up, measure for ``seconds``, check, and print the
    result's line. Returns the exit code."""
    from .trace import DeviceTrace, summarize

    workdir = tempfile.mkdtemp(prefix="gatb_bench_")
    try:
        ctx = Context(device, seed, workdir)
        drv = spec.driver.Driver(spec.config, spec.traffic, ctx)
        drv.setup()
        ctx.sync()
        setup_s = time.perf_counter() - t_start
        setup_peak = ctx.peak()
        ctx.reset_peak()
        tracer = DeviceTrace(ctx.torch) if trace else None
        # a mix may trace only the first ``trace_seconds`` of the window
        # (whole steps): the profiler's cost grows with its events
        trace_stop = min(spec.traffic.get("trace_seconds", seconds), seconds)
        traced = 0
        if tracer:
            tracer.start()
        steps = []
        w0 = time.time_ns()
        deadline = w0 + int(seconds * 1e9)
        while True:
            steps.append(drv.step())
            now = time.time_ns()
            if tracer and not traced and now >= w0 + trace_stop * 1e9:
                tracer.stop()
                traced = len(steps)
            if now >= deadline:
                break
        ctx.sync()
        window_s = (steps[-1]["t1"] - w0) / 1e9
        window_peak = ctx.peak()
        found = forbidden_modules()
        if found:
            print("loaded in the run's process: " + ", ".join(found),
                  file=err)
            return 3
        summary = None
        if tracer:
            t_red = time.perf_counter()
            spans = [h for s in steps[:traced]
                     for h in s.get("host_spans", ())]
            summary = summarize(tracer.events(), tracer.t0, tracer.t1,
                                spans)
            summary["steps"] = traced
            del tracer
            print(f"trace reduced in {time.perf_counter() - t_red:.1f} s",
                  file=err)
        metrics = read_metrics(spec, Run(spec, setup_s, steps, window_s,
                                         window_peak, summary), trace)
        # the reference runs once the program's state is freed
        drv.release()
        ctx.free()
        compared, failed = drv.check()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    line = {
        "correct": all(v <= lim for v, lim in compared.values()),
        "attempted": len(steps),
        "failed": failed,
        "metrics": metrics,
        "device": device_record(ctx, spec.cell["chips"],
                                max(setup_peak, window_peak),
                                summary),
    }
    if summary:
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in compared.items()}
    print(f"setup_s {setup_s:.3f}; window {window_s:.3f} s; steps (s): "
          + " ".join(f"{(s['t1'] - s['t0']) / 1e9:.3f}" for s in steps[:12])
          + (" ..." if len(steps) > 12 else ""), file=err)
    for k, (v, lim) in compared.items():
        print(f"compared {k} {v} limit {lim}", file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return 0


def read_metrics(spec: Spec, r: Run, trace: bool) -> dict:
    """Each of the cell's metrics by its reader; a per-layer reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in spec.per_layer if trace else spec.end_to_end:
        v = metric(m["name"]).read(r)
        if v is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_record(ctx: Context, chips: int, peak: int,
                  summary: dict | None) -> dict:
    from .work import card

    torch = ctx.torch
    rec = {"platform": "gpu" if ctx.cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if ctx.cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if ctx.cuda:
        rec["power_limit"] = card().get("power_limit", "not read")
    if summary:
        rec["busy_s"] = summary["busy_s"]
        rec["window_s"] = summary["window_s"]
    return rec

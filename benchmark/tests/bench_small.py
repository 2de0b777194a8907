"""Small sizes of the two cells for the CPU tests."""

import io
import json
import time

from benchmark import harness

SIZES = {"ecoli_k31.dbg": {"genome_len": 6000},
         "chr14q_k31.query": {"genome_len": 6000}}
QUERY = {"pool_batches": 4, "batch_reads": 64, "sample_every": 2,
         "max_kept": 3}


def spec(cell: str, **traffic):
    s = harness.load_spec(cell)
    s.config.update(SIZES[cell])
    if s.traffic["driver"] == "graph_query":
        s.traffic.update(QUERY)
    s.traffic.update(traffic)
    return s


def run(cell_spec, seed=2**31 + 5, seconds=0.3, trace=False,
        device="cpu"):
    """Run a cell through the harness; (exit code, result line or None,
    standard error)."""
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell_spec, seed, seconds, trace, device,
                     time.perf_counter(), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err.getvalue()

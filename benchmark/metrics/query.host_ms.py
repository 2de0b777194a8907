"""Host time per batch: the traced batches' mean latency less the device
time per batch (``query.device_ms``), in ms."""

import numpy as np


def read(run):
    if not run.trace or run.trace["device_s"] <= 0:
        return None
    n = run.trace["steps"]
    mean = float(np.mean([s["latency_s"] for s in run.steps[:n]]))
    return (mean - run.trace["device_s"] / n) * 1e3

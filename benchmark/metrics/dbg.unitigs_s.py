"""``graph.unitig_graph()`` per bank: the benchmark's span around it,
ending after a device synchronise."""

import numpy as np


def read(run):
    return float(np.mean([s["spans"]["unitigs"] for s in run.steps]))

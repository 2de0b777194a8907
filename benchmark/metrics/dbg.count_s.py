"""The count inside ``Graph.create`` (parse, superbatches, fetch, sweep)
per bank: the program's ``info["exec_time"]``, a host clock around a
count that ends with its table on the host."""

import numpy as np


def read(run):
    return float(np.mean([s["spans"]["count"] for s in run.steps]))

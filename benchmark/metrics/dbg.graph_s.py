"""The graph build after the count (``Graph()``'s upload and discretize,
MPHF, Bloom, cascading debloom, branching) per bank: the benchmark's span
around ``Graph.create``, ending after a device synchronise, less the
count."""

import numpy as np


def read(run):
    return float(np.mean([s["spans"]["create"] - s["spans"]["count"]
                          for s in run.steps]))

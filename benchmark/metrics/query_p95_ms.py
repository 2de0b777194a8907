"""95th percentile over all the window's batches of the time from the
``node_index`` call to the return of ``adjacency_masks``' host array."""

import numpy as np


def read(run):
    return float(np.percentile([s["latency_s"] for s in run.steps], 95)
                 * 1e3)

"""The count's processor chain (numpy, on the host) per bank: the
program's ``info["fillsolid_time.4.process"]``."""

import numpy as np


def read(run):
    return float(np.mean([s["spans"]["process"] for s in run.steps]))

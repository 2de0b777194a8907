"""The graph build after the count per bank: the program's
``graph.build`` span (``Graph()``'s upload and discretize, MPHF, Bloom,
cascading debloom, branching; ended by a synchronise), whole, in s. The
in-program twin of ``dbg.graph_s``."""

from benchmark import spans


def read(run):
    return spans.per_step(run, ["graph.build"], within="graph.build",
                          whole=True)

"""``adjacency_masks``' neighbour candidates per batch: the eager torch
ops of ``neighbor_candidates`` (the self time of the program's
``query.candidates`` spans under ``adjacency_masks``), in ms."""

from benchmark import spans


def read(run):
    s = spans.per_step(run, ["query.candidates"],
                       within="graph.adjacency_masks")
    return None if s is None else s * 1e3

"""The count's main thread waiting for the parse per bank: the self
time of the program's ``count.parse_wait`` spans (the prefetch queue's
``get``), in s."""

from benchmark import spans


def read(run):
    return spans.per_step(run, ["count.parse_wait"], within="count")

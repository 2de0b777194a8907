"""The count's processor chain waiting for the streamed table fetch per
bank: the self time of the program's ``count.fetch_wait`` spans, in s
(0 where the chain never waited)."""

from benchmark import spans


def read(run):
    return spans.per_step(run, ["count.fetch_wait"], within="count")

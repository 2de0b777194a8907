"""The count's main thread waiting for the card per bank: the self time
of the program's ``count.resolve`` spans (each superbatch's scalars read
back) and ``count.merge_wait`` spans (the merge's blocking reads: the
pass's row count and overflow flags), in s."""

from benchmark import spans


def read(run):
    return spans.per_step(run, ["count.resolve", "count.merge_wait"],
                          within="count")

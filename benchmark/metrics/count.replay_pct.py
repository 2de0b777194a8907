"""Superbatches dispatched again after an overflow, as a share of the
superbatches dispatched: the ``replays`` and ``superbatches`` counts of
the program's ``count`` spans in the traced banks, in %."""

from benchmark import spans


def read(run):
    got = spans.counts(spans.traced(run), "count")
    if not got.get("superbatches"):
        return None
    return got.get("replays", 0) / got["superbatches"] * 100

"""Later passes' superbatches dispatched from the bank cache, as a share
of those the later passes dispatched from the cache or staged again from
a fresh parse: ``cached / (cached + reparsed)`` of the program's ``count``
spans in the traced banks, in %. None where the program records no such
counters, or ran no later pass."""

from benchmark import spans


def read(run):
    got = spans.counts(spans.traced(run), "count")
    later = got.get("cached", 0) + got.get("reparsed", 0)
    if not later:
        return None
    return got.get("cached", 0) / later * 100

"""The count's cross-pass collect per bank: the passes' solid rows merged
on the card and their one copy to the host, waited for (the self time of
the program's ``count.collect`` spans, under ``count.process``), in s.
None where the program opened no such span."""

from benchmark import spans


def read(run):
    got = spans.traced(run)
    if not any(sp.name == "count.collect" for sp in got):
        return None
    return spans.per_step(run, ["count.collect"], within="count", spans=got)

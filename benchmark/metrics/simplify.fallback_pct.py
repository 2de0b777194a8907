"""Bulge candidates the lockstep walker sent to the host recursion, as a
share of those it walked: the ``fallbacks`` and ``walker`` counts of the
program's ``simplify`` spans in the traced steps, in %. None where the
program records no such counts."""

from benchmark import spans


def read(run):
    got = spans.counts(spans.traced(run), "simplify")
    if not got.get("walker"):
        return None
    return got.get("fallbacks", 0) / got["walker"] * 100

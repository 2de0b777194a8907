"""The work of all the window's whole steps over the time from the
window's start to the last step's end: read bases in Mbp/s for banks
(``queries_per_s`` reads k-mers in Mkmer/s by the same formula)."""


def read(run):
    return sum(s["work"] for s in run.steps) / run.window_s / 1e6

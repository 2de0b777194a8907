"""Share of the bandwidth bound that a batch's kernels reach: the least
bytes of a batch (``work.query_bytes``) over the card's published
3.35 TB/s, divided by the traced batches' kernel time (copies and
fills left out), in %. The card's power limit is in the result's
``device`` record."""

from benchmark import work


def read(run):
    if not run.trace or run.trace["kernel_s"] <= 0:
        return None
    n = sum(s["work"] for s in run.steps[:run.trace["steps"]])
    limbs = 1 if run.spec.config["kmer_size"] <= 16 else 2
    least = work.bound_s(work.query_bytes(n, limbs,
                                          run.steps[0]["rank_bytes"]))
    return least / run.trace["kernel_s"] * 100

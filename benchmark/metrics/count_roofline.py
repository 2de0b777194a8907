"""Share of the bandwidth bound that a count's kernels reach: the least
bytes of the traced counts (``count_work.count_bytes`` of the counters
``limbs``, ``windows`` and ``distinct`` on each of the program's
``count`` spans, and of the steps' read bases) over the card's published
3.35 TB/s, divided by the traced steps' kernel time (copies and fills
left out), in %. None where the program records no such counters."""

from benchmark import count_work, spans, work


def read(run):
    if not run.trace or run.trace["kernel_s"] <= 0:
        return None
    roots = [sp for sp in spans.traced(run) if sp.name == "count"]
    if not roots or any("windows" not in sp.counts for sp in roots):
        return None
    bases = sum(s["work"] for s in run.steps[:run.trace["steps"]])
    least = sum(count_work.count_bytes(sp.counts["windows"],
                                       sp.counts["limbs"],
                                       sp.counts["distinct"], 0)
                for sp in roots) + count_work.count_bytes(0, 0, 0, bases)
    return work.bound_s(least) / run.trace["kernel_s"] * 100

"""The program's own spans inside a run's traced steps.

``gatb_core_tpu_torch.misc.time_info`` records a span at each layer
boundary while a torch profiler runs, so in a ``--trace 1`` run: its
name (``<layer>.<stage>``), its thread, its parent and root ids, its
``time.time_ns()`` stamps (the clock of the steps' records and of the
device's events) and its counts. A reader takes the spans that lie
inside the traced steps (``run.steps[:run.trace["steps"]]``, each from
its ``t0`` to its ``t1``), and a name's self time: its spans' durations
less what their child spans on the same thread cover (a child on
another thread, such as the count's parse, runs beside its parent and
is not taken off). A program without the recorder records nothing, and
every reader then returns None.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict


# the roots of the program's query API calls
QUERY_CALLS = ("graph.node_index", "graph.adjacency_masks")


def program_spans() -> list:
    """Every span the program has recorded (none without a recorder)."""
    try:
        from gatb_core_tpu_torch.misc import time_info
    except ImportError:
        return []
    read = getattr(time_info, "spans", None)
    return read() if read else []


def traced(run, spans=None) -> list:
    """The spans that lie inside one of the run's traced steps."""
    if spans is None:
        spans = program_spans()
    if not run.trace or not spans:
        return []
    steps = sorted((s["t0"], s["t1"])
                   for s in run.steps[:run.trace["steps"]])
    starts = [t0 for t0, _ in steps]
    out = []
    for sp in spans:
        if sp.t1_ns is None:
            continue
        i = bisect.bisect_right(starts, sp.t0_ns) - 1
        if i >= 0 and sp.t1_ns <= steps[i][1]:
            out.append(sp)
    return out


def _covered(ivs) -> int:
    """Nanoseconds in the union of the intervals."""
    total, end = 0, None
    for s, e in sorted(ivs):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def self_seconds(spans) -> dict:
    """Self time by name, in seconds."""
    kids = defaultdict(list)
    for sp in spans:
        if sp.parent is not None:
            kids[sp.parent].append(sp)
    out = defaultdict(float)
    for sp in spans:
        inner = [(max(c.t0_ns, sp.t0_ns), min(c.t1_ns, sp.t1_ns))
                 for c in kids.get(sp.id, ()) if c.thread == sp.thread]
        inner = [(s, e) for s, e in inner if e > s]
        out[sp.name] += (sp.t1_ns - sp.t0_ns - _covered(inner)) / 1e9
    return dict(out)


def total_seconds(spans) -> dict:
    """Whole durations by name, in seconds."""
    out = defaultdict(float)
    for sp in spans:
        out[sp.name] += (sp.t1_ns - sp.t0_ns) / 1e9
    return dict(out)


def counts(spans, name: str) -> dict:
    """The counts of the spans named ``name``, summed."""
    out = defaultdict(int)
    for sp in spans:
        if sp.name == name:
            for k, v in sp.counts.items():
                out[k] += v
    return dict(out)


def under(spans, within) -> list:
    """The spans named ``within`` (a name or a tuple of names) and those
    opened under one of them: the calls that hold a metric's stages, and
    not the same stages opened by another caller."""
    names = {within} if isinstance(within, str) else set(within)
    byid = {sp.id: sp for sp in spans}
    inside = {}

    def held(sp) -> bool:
        path = []
        while sp is not None and sp.id not in inside:
            if sp.name in names:
                inside[sp.id] = True
                break
            path.append(sp.id)
            sp = byid.get(sp.parent)
        got = sp is not None and inside[sp.id]
        for i in path:
            inside[i] = got
        return got

    return [sp for sp in spans if held(sp)]


def per_step(run, names, within, whole: bool = False,
             spans=None) -> float | None:
    """Seconds per traced step in the spans named ``names`` that lie
    under a span named ``within`` (a name or a tuple of names: the calls
    that hold them), as self time or with ``whole`` their whole
    durations; None where no such call lies in the traced steps, 0 where
    one does and none of ``names`` was opened in it."""
    got = under(traced(run, spans), within)
    if not got:
        return None
    times = total_seconds(got) if whole else self_seconds(got)
    return sum(times.get(n, 0.0) for n in names) / run.trace["steps"]


def innermost(spans, thread: int | None = None) -> list:
    """(name, start ns, end ns) of the innermost open span of one thread
    (the main thread by default), in time order and without overlaps:
    what ``trace.summarize`` takes as ``host_spans`` to name each idle
    gap of the device by the program's stage."""
    if thread is None:
        thread = threading.main_thread().ident
    mine = sorted((sp for sp in spans if sp.thread == thread),
                  key=lambda sp: (sp.t0_ns, -sp.t1_ns))
    out, stack, cur = [], [], None

    def emit(name, s, e):
        if e > s:
            out.append((name, s, e))

    for sp in mine:
        while stack and stack[-1][1] <= sp.t0_ns:
            name, end = stack.pop()
            emit(name, cur, end)
            cur = end
        if stack:
            emit(stack[-1][0], cur, sp.t0_ns)
        stack.append((sp.name, min(sp.t1_ns, stack[-1][1]) if stack
                      else sp.t1_ns))
        cur = sp.t0_ns
    while stack:
        name, end = stack.pop()
        emit(name, cur, end)
        cur = end
    return out

"""The device's timeline from ``torch.profiler``, reduced to what the
per-layer metrics read.

Taken from ``chip_smoke.py --profile`` (device time by name, busy
share) and widened: the busy time is the union of the device's activity
intervals (kernels, copies, fills) inside the traced window, and each
idle gap is named by the benchmark's own host span that was open at its
middle. Kineto's event times and ``time.time_ns()`` share one clock, so
the host spans line up with the device's events.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

TOP = 10                      # entries kept in each list of the breakdown
NAME_CHARS = 120              # a kernel's demangled name is cut to this


class DeviceTrace:
    """Profiles the device (CUDA activity only) between ``start`` and
    ``stop``."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.stop()

    def events(self):
        """(name, start ns, end ns) of every device event."""
        cuda = self.torch.autograd.DeviceType.CUDA
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda and e.duration_ns() > 0:
                out.append((e.name(), e.start_ns(), e.end_ns()))
        return out


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def summarize(events, t0: int, t1: int, host_spans) -> dict:
    """Busy seconds (union of the events' intervals within [t0, t1]),
    device seconds (their sum), kernel seconds (without copies and
    fills), the device time by name and the idle gaps by host span.
    ``host_spans``: (name, start ns, end ns), in time order."""
    by_name = defaultdict(float)
    device_s = kernel_s = 0.0
    iv = []
    for name, s, e in events:
        d = (e - s) / 1e9
        device_s += d
        if not is_copy(name):
            kernel_s += d
        by_name[name] += d
        s, e = max(s, t0), min(e, t1)
        if e > s:
            iv.append((s, e))
    iv.sort()
    busy = 0
    gaps = []
    cur_s = cur_e = None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            gaps.append((t0 if cur_e is None else cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, t1))
    else:
        gaps.append((t0, t1))
    idle = defaultdict(float)
    starts = [h[1] for h in host_spans]
    for gs, ge in gaps:
        if ge <= gs:
            continue
        mid = (gs + ge) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "harness"
        if i >= 0 and host_spans[i][1] <= mid < host_spans[i][2]:
            name = host_spans[i][0]
        idle[name] += (ge - gs) / 1e9
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy / 1e9,
        "device_s": device_s,
        "kernel_s": kernel_s,
        "device_ops": [(n[:NAME_CHARS], v) for n, v in sorted(
            by_name.items(), key=lambda r: -r[1])[:TOP]],
        "idle_gaps": sorted(idle.items(), key=lambda r: -r[1])[:TOP],
    }

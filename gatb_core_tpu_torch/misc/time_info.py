"""Named stopwatches, the span recorder, and progress reporting.

Ports of gatb-core TimeInfo (tools/misc/impl/TimeInfo.hpp: named
stopwatches merged into every algorithm's info properties) and Progress /
ProgressTimerAndSystem (impl/Progress.cpp: progress bar with ETA + RSS).

The span recorder is the port's own: ``span(name)`` records an interval
of ``time.time_ns()`` stamps, the clock of ``torch.profiler``'s device
events, so a span lines up with the kernels it enqueued or waited for
(on an H100 the profiler's device times wander from it by up to 3.5
ms in a process's first profiling session, and further in later ones).
Spans nest per thread (each thread keeps a stack of open spans; a span
opened on another thread names its ``parent``) and share the id of their
root. Recording is on while a torch profiler runs or inside
``recording()``; off, ``span`` returns one shared null object and reads
no clock. ``TimeInfo.section`` records its span and times its stopwatch
from the same stamps. Read the spans with ``spans()``; at most
``SPAN_CAP`` are kept and the rest counted in ``dropped()``.
"""

from __future__ import annotations

import functools
import itertools
import sys
import threading
import time

import torch
import torch.autograd.profiler as _profiler

SPAN_CAP = 1 << 20

_kept: list = []
_dropped = [0]
_forced = [0]                 # open ``recording()`` blocks
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()      # for the list, the drop count and the switch


def is_recording() -> bool:
    return bool(_forced[0] or _profiler._is_profiler_enabled)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(sp: "Span") -> None:
    with _lock:
        if len(_kept) < SPAN_CAP:
            _kept.append(sp)
        else:
            _dropped[0] += 1


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Span:
    """One recorded interval: ids (its own, its parent's, its root's),
    name, thread, ``t0_ns``/``t1_ns`` and a dict of counts."""

    __slots__ = ("id", "parent", "root", "name", "thread", "t0_ns",
                 "t1_ns", "counts", "_sync", "_up")

    def __init__(self, name: str, sync: bool = False, parent=None):
        self.id = next(_ids)
        self.name = name
        self.counts: dict = {}
        self._sync = sync
        self._up = parent
        self.parent = self.root = self.thread = None
        self.t0_ns = self.t1_ns = None

    def __enter__(self) -> "Span":
        stack = _stack()
        up = self._up if self._up is not None else (
            stack[-1] if stack else None)
        if up is not None and up.id is not None:
            self.parent, self.root = up.id, up.root
        else:
            self.root = self.id
        self.thread = threading.get_ident()
        stack.append(self)
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._sync:
            _sync()
        self.t1_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._up = None
        _keep(self)
        return False

    def count(self, **counts) -> None:
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v


class _NullSpan:
    """What ``span`` returns while recording is off: does nothing."""

    __slots__ = ()
    id = parent = root = t0_ns = t1_ns = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


NULL_SPAN = _NullSpan()


def span(name: str, sync: bool = False, parent=None):
    """A span named ``name`` (``<layer>.<stage>``) to enter with ``with``.
    ``sync``: synchronise the card before it closes, so that it times the
    stage and not its enqueue (a no-op without CUDA). ``parent``: the open
    span it belongs to where that is another thread's."""
    if not (_forced[0] or _profiler._is_profiler_enabled):
        return NULL_SPAN
    return Span(name, sync, parent)


_open_span = span        # for ``TimeInfo.section``, whose argument is ``span``


def spanned(name: str):
    """Decorator: each call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap


def current():
    """This thread's innermost open span (the null span if none)."""
    stack = _stack()
    return stack[-1] if stack else NULL_SPAN


class recording:
    """Records spans inside the block, with or without a profiler."""

    def __enter__(self) -> "recording":
        with _lock:
            _forced[0] += 1
        return self

    def __exit__(self, *exc) -> bool:
        with _lock:
            _forced[0] -= 1
        return False


def spans() -> list:
    """The recorded spans, in the order they closed."""
    with _lock:
        return list(_kept)


def dropped() -> int:
    """Spans not kept because ``SPAN_CAP`` were held."""
    return _dropped[0]


def clear_spans() -> None:
    with _lock:
        _kept.clear()
        _dropped[0] = 0


class _Section:
    """One timing of a ``TimeInfo`` stopwatch, with its span."""

    __slots__ = ("_ti", "_name", "_span", "_t0", "seconds")

    def __init__(self, ti: "TimeInfo", name: str, sp):
        self._ti, self._name, self._span = ti, name, sp
        self.seconds = 0.0

    def __enter__(self) -> "_Section":
        self._span.__enter__()
        self._t0 = self._span.t0_ns or time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self._span.__exit__(*exc)
        t1 = self._span.t1_ns or time.time_ns()
        self.seconds = (t1 - self._t0) / 1e9
        self._ti.add(self._name, self.seconds)
        return False


class TimeInfo:
    """Accumulating named stopwatches (TimeInfo.hpp:1-170)."""

    def __init__(self):
        self.entries: dict[str, float] = {}
        self._starts: dict[str, int] = {}

    def start(self, name: str) -> None:
        self._starts[name] = time.time_ns()

    def stop(self, name: str) -> None:
        t0 = self._starts.pop(name, None)
        if t0 is not None:
            self.add(name, (time.time_ns() - t0) / 1e9)

    def add(self, name: str, seconds: float) -> None:
        self.entries[name] = self.entries.get(name, 0.0) + seconds

    def section(self, name: str, span: str | None = None,
                sync: bool = False) -> _Section:
        """RAII equivalent of the TIME_INFO macro; with ``span``, also a
        span of that name, whose stamps the stopwatch reads. The
        section's ``seconds`` hold this timing alone."""
        sp = _open_span(span, sync) if span else NULL_SPAN
        return _Section(self, name, sp)

    def merge(self, other: "TimeInfo") -> None:
        for k, v in other.entries.items():
            self.add(k, v)

    def get_properties(self, root: str = "time",
                       total: bool = True) -> dict:
        """``root`` (the sum, unless ``total`` is False) and
        ``root.<name>`` for each stopwatch, in seconds to the ms."""
        out = {root: round(sum(self.entries.values()), 3)} if total else {}
        for k, v in self.entries.items():
            out[f"{root}.{k}"] = round(v, 3)
        return out


def max_rss_mb() -> float:
    """Current max RSS in MB (SystemInfo equivalent, /proc based)."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    except Exception:  # pragma: no cover
        return 0.0


class Progress:
    """Terminal progress listener (Progress.cpp): init/inc/finish with
    percentage, ETA and memory, throttled to ~1 update/sec."""

    def __init__(self, total: int, message: str = "", verbose: bool = True,
                 stream=None):
        self.total = max(total, 1)
        self.message = message
        self.done = 0
        self.verbose = verbose
        self.stream = stream or sys.stderr
        self.t0 = time.time()
        self._last = 0.0

    def inc(self, n: int = 1) -> None:
        self.done += n
        now = time.time()
        if self.verbose and (now - self._last) > 1.0:
            self._last = now
            pct = 100.0 * self.done / self.total
            elapsed = now - self.t0
            eta = elapsed / max(self.done, 1) * (self.total - self.done)
            self.stream.write(
                f"\r[{self.message}]  {pct:5.1f}%   elapsed: {elapsed:6.1f}s"
                f"   remaining: {eta:6.1f}s   mem: {max_rss_mb():7.1f} MB")
            self.stream.flush()

    def finish(self) -> None:
        if self.verbose:
            elapsed = time.time() - self.t0
            self.stream.write(
                f"\r[{self.message}]  100.0%   elapsed: {elapsed:6.1f}s"
                f"{' ' * 30}\n")
            self.stream.flush()

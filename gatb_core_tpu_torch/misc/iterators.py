"""Iterator adaptors + dispatcher (designpattern layer equivalents).

The reference's designpattern layer (src/gatb/tools/designpattern) is the
library's entire intra-node parallel substrate: pull iterators with
adaptors (IteratorHelpers.hpp: Truncate, Filter, Composite, Paired,
Subject) and a thread-pool Dispatcher (ICommand.hpp:137-239) whose
``iterate`` pulls batches of items under a mutex and fans them out.

In this engine the heavy parallelism lives on the device mesh
(parallel/), so these adaptors exist for API/workflow parity — host-side
stream utilities used by banks and drivers. ``Dispatcher`` maps the
batched-fanout contract onto the host: it groups items into batches and
applies the functor per batch (optionally with threads for IO-bound
host work like gzip decompression).
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")


def truncate(it: Iterable[T], n: int) -> Iterator[T]:
    """TruncateIterator: at most n items."""
    return itertools.islice(it, n)


def filter_it(it: Iterable[T], predicate: Callable[[T], bool]) -> Iterator[T]:
    """FilterIterator."""
    return (x for x in it if predicate(x))


def composite(*its: Iterable[T]) -> Iterator[T]:
    """CompositeIterator: concatenation."""
    return itertools.chain(*its)


def paired(a: Iterable, b: Iterable) -> Iterator[tuple]:
    """PairedIterator: strict zip (stops at the shorter)."""
    return zip(a, b)


def product(a: Iterable, b: Iterable) -> Iterator[tuple]:
    """ProductIterator (cartesian)."""
    return itertools.product(a, b)


class SubjectIterator:
    """SubjectIterator: notifies listeners every ``period`` items
    (IteratorHelpers.hpp progress-notify)."""

    def __init__(self, it: Iterable[T], period: int = 1000):
        self.it = iter(it)
        self.period = period
        self.listeners: list[Callable[[int], None]] = []
        self.count = 0

    def add_listener(self, fn: Callable[[int], None]) -> None:
        self.listeners.append(fn)

    def __iter__(self):
        for item in self.it:
            self.count += 1
            if self.count % self.period == 0:
                for fn in self.listeners:
                    fn(self.count)
            yield item


class CancellableIterator:
    """CancellableIterator: stops when .cancel() is called."""

    def __init__(self, it: Iterable[T]):
        self.it = iter(it)
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __iter__(self):
        for item in self.it:
            if self.cancelled:
                return
            yield item


class SerialDispatcher:
    """SerialDispatcher: in-order execution (impl/Command.hpp)."""

    def iterate(self, it: Iterable[T], functor: Callable[[T], None],
                group_size: int = 1000) -> int:
        n = 0
        for item in it:
            functor(item)
            n += 1
        return n

    def dispatch_commands(self, commands) -> None:
        for cmd in commands:
            cmd()


class Dispatcher(SerialDispatcher):
    """Dispatcher: batched fan-out (ICommand.hpp:137-239). Threads only
    help host-side IO in Python; device work goes through the mesh."""

    def __init__(self, nb_cores: int = 0):
        import os

        self.nb_cores = nb_cores or (os.cpu_count() or 1)

    def iterate(self, it: Iterable[T], functor: Callable[[T], None],
                group_size: int = 1000) -> int:
        n = 0
        if self.nb_cores <= 1:
            return super().iterate(it, functor, group_size)
        with ThreadPoolExecutor(self.nb_cores) as pool:
            batch = []
            futures = []
            for item in it:
                batch.append(item)
                n += 1
                if len(batch) >= group_size:
                    futures.append(pool.submit(
                        lambda b: [functor(x) for x in b], batch))
                    batch = []
            if batch:
                futures.append(pool.submit(
                    lambda b: [functor(x) for x in b], batch))
            for f in futures:
                f.result()
        return n

    def dispatch_commands(self, commands) -> None:
        with ThreadPoolExecutor(self.nb_cores) as pool:
            futures = [pool.submit(cmd) for cmd in commands]
            for f in futures:
                f.result()

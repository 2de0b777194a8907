"""Container layer leftovers: hash tables and file-backed bags.

Port of gatb_core_tpu/collections/containers.py: host Python, as there.
Host-side equivalents of the reference's remaining collection types
(tools/collections/impl): OAHash (open addressing, OAHash.hpp:48-230),
Hash16 (chained block hash with counts + sorted iteration,
Hash16.hpp:50-343), BagFile/BagCache (file-backed bag with write-behind
buffer, BagFile.hpp/BagCache.hpp), IteratorFile (binary file iterator,
IteratorFile.hpp) and ContainerSet (sorted-vector membership,
ContainerSet.hpp:51 — the device-resident twin is
collections.sortedset.SortedKmerSet).

In this engine the counting kernel is sort-based on device, so these
hash tables serve the auxiliary roles the reference uses them for
(debloom partitioning fallbacks, small exact sets) rather than the hot
counting loop. OAHash reproduces the reference's oahash64 probe
sequence, so slots and the order of ``items()`` are the JAX package's.
"""

from __future__ import annotations

import os
import struct
from bisect import bisect_left
from typing import Iterator

import numpy as np


class OAHash:
    """Open-addressing hash with linear probing over oahash64
    (OAHash.hpp:48-230): insert-or-increment semantics, bounded size."""

    def __init__(self, max_items: int):
        self.capacity = max(8, int(max_items * 1.33))
        self.keys = np.full(self.capacity, -1, np.int64)
        self.values = np.zeros(self.capacity, np.int32)
        self.nb_items = 0

    @staticmethod
    def _oahash64(key: int) -> int:
        M = (1 << 64) - 1
        code = key & M
        code ^= code >> 14
        code = ((~code) + (code << 18)) & M
        code ^= code >> 31
        code = (code * 21) & M
        code ^= code >> 11
        code = (code + (code << 6)) & M
        code ^= code >> 22
        return code

    def _slot(self, key: int) -> int:
        idx = self._oahash64(key) % self.capacity
        for _ in range(self.capacity):
            k = self.keys[idx]
            if k == -1 or k == key:
                return idx
            idx = (idx + 1) % self.capacity
        raise RuntimeError("OAHash: max rehashes reached (table full)")

    def increment(self, key: int, delta: int = 1) -> None:
        idx = self._slot(key)
        if self.keys[idx] == -1:
            self.keys[idx] = key
            self.nb_items += 1
        self.values[idx] += delta

    def get(self, key: int, default=None):
        idx = self._slot(key)
        if self.keys[idx] == -1:
            return default
        return int(self.values[idx])

    def __contains__(self, key: int) -> bool:
        return self.get(key) is not None

    def items(self) -> Iterator[tuple[int, int]]:
        for k, v in zip(self.keys, self.values):
            if k != -1:
                yield int(k), int(v)


class Hash16:
    """Insert/increment hash with *sorted* iteration (Hash16.hpp:50-343:
    chained block-allocated table; iteration sorts — matched here).

    Reference role note: PartitionsByHashCommand uses Hash16 to count
    partitions LARGER than memory by filling/spilling the table in rounds
    (PartitionsCommand.cpp:372-460). In this engine that role is served
    structurally: the DSK plan (kmer/configuration.py, wired through
    dbgh5 -max-memory/-max-disk/-nb-passes) bounds each pass's superbatch
    volume, so no single sort ever exceeds the memory budget — this class
    remains as the API-parity host container (legacy callers, tests).
    ``max_memory_mb`` bounds the table like the reference ctor arg."""

    _EMPTY = -1

    def __init__(self, max_memory_mb: int = 0, initial_capacity: int = 1024):
        # open-addressing table (linear probing, pow2 capacity, grow at
        # 70% load) with int64 keys + int64 counts — 16 B/entry, the
        # reference's cell size (Hash16.hpp:84); keys must be >= 0
        # (2k-bit kmer values)
        cap = 1
        while cap < initial_capacity:
            cap <<= 1
        self._keys = np.full(cap, self._EMPTY, np.int64)
        self._vals = np.zeros(cap, np.int64)
        self._n = 0
        self._max_items = (max_memory_mb * (1 << 20)) // 16 \
            if max_memory_mb else 0

    @property
    def is_full(self) -> bool:
        """True when the memory budget is reached (callers must flush,
        like PartitionsByHashCommand's spill rounds,
        PartitionsCommand.cpp:372-460)."""
        return bool(self._max_items) and self._n >= self._max_items

    def _slot(self, key: int) -> int:
        mask = len(self._keys) - 1
        i = (key * 0x9E3779B97F4A7C15 & (2**64 - 1)) >> 40
        i &= mask
        keys = self._keys
        while keys[i] != self._EMPTY and keys[i] != key:
            i = (i + 1) & mask
        return i

    def _grow(self) -> None:
        old_k, old_v = self._keys, self._vals
        cap = len(old_k) * 2
        self._keys = np.full(cap, self._EMPTY, np.int64)
        self._vals = np.zeros(cap, np.int64)
        self._n = 0
        for k, v in zip(old_k, old_v):
            if k != self._EMPTY:
                i = self._slot(int(k))
                self._keys[i] = k
                self._vals[i] = v
                self._n += 1

    def insert(self, key: int, delta: int = 1) -> None:
        if 10 * (self._n + 1) > 7 * len(self._keys):
            self._grow()
        i = self._slot(key)
        if self._keys[i] == self._EMPTY:
            self._keys[i] = key
            self._n += 1
        self._vals[i] += delta

    def get(self, key: int, default=0) -> int:
        i = self._slot(key)
        return int(self._vals[i]) if self._keys[i] != self._EMPTY \
            else default

    @property
    def nb_items(self) -> int:
        return self._n

    def sorted_items(self) -> Iterator[tuple[int, int]]:
        live = self._keys != self._EMPTY
        order = np.argsort(self._keys[live], kind="stable")
        ks, vs = self._keys[live][order], self._vals[live][order]
        for k, v in zip(ks, vs):
            yield int(k), int(v)

    def clear(self) -> None:
        self._keys.fill(self._EMPTY)
        self._vals.fill(0)
        self._n = 0


class ContainerSet:
    """Sorted-vector membership via binary search (ContainerSet.hpp:51).
    Host twin of collections.sortedset.SortedKmerSet."""

    def __init__(self, values):
        self.values = sorted(values)

    def contains(self, value) -> bool:
        i = bisect_left(self.values, value)
        return i < len(self.values) and self.values[i] == value

    def __contains__(self, value) -> bool:
        return self.contains(value)

    def __len__(self) -> int:
        return len(self.values)


class BagFile:
    """File-backed bag of fixed-size records (BagFile.hpp). Records are
    little-endian int64 (the reference templates over item type; kmer
    values wider than 64 bits use multiple records per item)."""

    FMT = "<q"

    def __init__(self, path: str, mode: str = "wb"):
        self.path = path
        self._f = open(path, mode)

    def insert(self, value: int) -> None:
        self._f.write(struct.pack(self.FMT, value))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BagCache:
    """Write-behind cache in front of a bag (BagCache.hpp: N-item buffer
    flushed in one block; the reference adds a mutex for concurrent
    producers, unnecessary under the GIL single-producer pattern)."""

    def __init__(self, bag: BagFile, cache_size: int = 16 * 1024):
        self.bag = bag
        self.cache_size = cache_size
        self._buf: list[int] = []

    def insert(self, value: int) -> None:
        self._buf.append(value)
        if len(self._buf) >= self.cache_size:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            data = b"".join(struct.pack(BagFile.FMT, v) for v in self._buf)
            self.bag._f.write(data)
            self._buf.clear()
        self.bag.flush()


class BagPartition:
    """Bag writing into one collection of an N-way partition
    (BagPartition.hpp: BagCachePartition caches items then flushes them
    under the partition's synchronizer into collection ``idx``). Here a
    partition is a directory of N BagFiles."""

    def __init__(self, directory: str, nb_collections: int,
                 cache_size: int = 16 * 1024):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.nb_collections = nb_collections
        self._bags = [BagFile(os.path.join(directory, f"part_{i}"))
                      for i in range(nb_collections)]
        self._caches = [BagCache(b, cache_size) for b in self._bags]

    def insert(self, idx: int, value: int) -> None:
        self._caches[idx].insert(value)

    def flush(self) -> None:
        for c in self._caches:
            c.flush()

    def iterator(self, idx: int) -> "IteratorFile":
        return IteratorFile(self._bags[idx].path)

    def close(self) -> None:
        self.flush()
        for b in self._bags:
            b.close()


class IteratorFile:
    """Binary file iterator over BagFile records (IteratorFile.hpp)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[int]:
        size = struct.calcsize(BagFile.FMT)
        with open(self.path, "rb") as f:
            while True:
                chunk = f.read(size * 4096)
                if not chunk:
                    return
                for (v,) in struct.iter_unpack(BagFile.FMT, chunk):
                    yield v

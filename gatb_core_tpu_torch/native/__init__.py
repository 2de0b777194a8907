"""Native host runtime (C++): FASTA/FASTQ parsing + 2-bit batch encoding.

Port of gatb_core_tpu/native: the native counterpart of the reference's
C++ host plumbing (BankFasta parser, bank/impl/BankFasta.cpp), which
feeds the device pipeline without Python per-character overhead. It is
built lazily with g++ into ``gatb_core_tpu_torch/_build/`` (named by a
hash of the source, never next to the source); where g++ or zlib is
missing, ``available()`` is False and counting uses the pure-Python
parser, as the JAX package does. That choice is host code only.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastx.cpp")
_lock = threading.Lock()
_lib = None
_lib_failed = False
# why the native parser is unavailable ("" while it loads fine)
unavailable_reason = ""


def _build() -> str:
    from ..ops._build import compile_shared

    return compile_shared(["g++"], _SRC,
                          ["-O3", "-shared", "-fPIC", "-std=c++17"],
                          "fastx", extra_args=["-lz"])


def get_lib():
    """Load (building at first use) the native library, or None if
    unavailable."""
    global _lib, _lib_failed, unavailable_reason
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, RuntimeError) as e:
            _lib_failed = True
            unavailable_reason = str(e).strip().splitlines()[0]
            return None
        lib.fastx_open.restype = ctypes.c_void_p
        lib.fastx_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int]
        for fill in (lib.fastx_fill, lib.fastx_fill_packed):
            fill.restype = ctypes.c_int
            fill.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
                ctypes.c_void_p] * 4
        lib.fastx_stats_full.restype = None
        lib.fastx_stats_full.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)]
        lib.fastx_parse_counters.restype = None
        lib.fastx_parse_counters.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.fastx_close.restype = None
        lib.fastx_close.argtypes = [ctypes.c_void_p]
        lib.fastx_open_reader.restype = ctypes.c_void_p
        lib.fastx_open_reader.argtypes = [ctypes.c_char_p]
        lib.fastx_next_seq.restype = ctypes.c_int64
        lib.fastx_next_seq.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_char_p)]
        lib.fastx_reader_close.restype = None
        lib.fastx_reader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeBatcher:
    """Iterator of (codes, valid, lengths, rows) batches over a FASTA/FASTQ
    path, shaped exactly like kmer/counting.py _BatchBuilder output."""

    def __init__(self, path: str, k: int, batch_reads: int, batch_len: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native fastx library unavailable")
        self._lib = lib
        self.k = k
        self.B = batch_reads
        self.L = max(batch_len, 2 * k)
        self._h = lib.fastx_open(path.encode(), k, self.B, self.L)
        if not self._h:
            raise FileNotFoundError(path)
        self._stats_full = (0, 0, 0, 0, 0.0)
        self._counters = (0, 0)

    def __iter__(self):
        return self.batches(packed=False)

    def iter_packed(self):
        """Packed-transfer batches: (words (B, ceil(L/16)) uint32,
        vmask (B, ceil(L/32)) uint32, lengths, rows) — the 2.25 bits/base
        host->device format (pack_words/pack_valid layout, packed in C++)."""
        return self.batches(packed=True)

    def batches(self, packed: bool, group: int = 1):
        """The batches, packed or as (codes (B, L) uint8, valid (B, L)
        bool, lengths, rows); each C call fills ``group`` of them into
        fresh arrays, yielded as views (a consumer may hold them all)."""
        if group < 1:
            raise ValueError(f"group must be at least 1, got {group}")
        lib, B, L = self._lib, self.B, self.L
        if packed:
            shapes = ((L + 15) // 16, np.uint32), ((L + 31) // 32, np.uint32)
            fill = lib.fastx_fill_packed
        else:
            shapes = (L, np.uint8), (L, np.uint8)
            fill = lib.fastx_fill
        rows = np.zeros((group,), np.int32)
        try:
            while True:
                a, b = (np.empty((group, B, n), dt) for n, dt in shapes)
                lengths = np.empty((group, B), np.int32)
                got = fill(self._h, group, _ptr(a), _ptr(b), _ptr(lengths),
                           _ptr(rows))
                if not packed:
                    b = b.view(bool)
                for g in range(got):
                    yield a[g], b[g], lengths[g], int(rows[g])
                if got < group:
                    break
        finally:
            self.close()

    def stats_full(self) -> tuple[int, int, int, int, float]:
        """(nb, total, min_len, max_len, sumsq) — the BankStats block
        (seq_size_min/max/mean/deviation, SortingCountAlgorithm.cpp:
        735-742)."""
        if self._h:
            nb = ctypes.c_int64()
            total = ctypes.c_int64()
            mn = ctypes.c_int64()
            mx = ctypes.c_int64()
            sq = ctypes.c_double()
            self._lib.fastx_stats_full(
                self._h, ctypes.byref(nb), ctypes.byref(total),
                ctypes.byref(mn), ctypes.byref(mx), ctypes.byref(sq))
            self._stats_full = (nb.value, total.value, mn.value, mx.value,
                                sq.value)
        return self._stats_full

    def parse_counters(self) -> tuple[int, int]:
        """(input bytes read, decompressed for .gz; sequences that took a
        copy: FASTA records, and those longer than a row or than the
        scan buffer)."""
        if self._h:
            nbytes = ctypes.c_int64()
            carried = ctypes.c_int64()
            self._lib.fastx_parse_counters(self._h, ctypes.byref(nbytes),
                                           ctypes.byref(carried))
            self._counters = (nbytes.value, carried.value)
        return self._counters

    def close(self):
        if self._h:
            self.stats_full()    # cache before the handle is freed
            self.parse_counters()
            self._lib.fastx_close(self._h)
            self._h = None


class NativeSeqReader:
    """Sequence-payload iterator over a FASTA/FASTQ path (native parse)."""

    def __init__(self, path: str, initial_cap: int = 1 << 16):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native fastx library unavailable")
        self._lib = lib
        self._h = lib.fastx_open_reader(path.encode())
        if not self._h:
            raise FileNotFoundError(path)
        self._cap = initial_cap
        self._buf = ctypes.create_string_buffer(self._cap)

    def __iter__(self):
        lib = self._lib
        big = ctypes.c_char_p()
        try:
            while True:
                n = lib.fastx_next_seq(self._h, self._buf, self._cap,
                                       ctypes.byref(big))
                if n == -1:
                    break
                if n == -2:
                    yield (big.value or b"").decode("ascii")
                    continue
                yield self._buf.raw[:n].decode("ascii")
        finally:
            self.close()

    def close(self):
        if self._h:
            self._lib.fastx_reader_close(self._h)
            self._h = None

"""ClearCache equivalent (tools/ClearCache.cpp): evict the OS page cache
before benchmarking by allocating and touching the requested amount of
memory. Port of gatb_core_tpu/tools/clear_cache.py (host code).
Usage: python -m gatb_core_tpu_torch.tools.clear_cache [MB]."""

from __future__ import annotations

import os
import sys

import numpy as np

from ..misc.time_info import Progress


def clear(n_bytes: int, chunk_mb: int = 64, verbose: bool = True) -> int:
    """Touch n_bytes of fresh memory in chunks (the reference's clear()
    loop with a ProgressTimer, ClearCache.cpp:40-60). n_bytes=0 means
    the machine's total physical RAM (ClearCache.cpp:38); allocation
    failures are tolerated like the reference's unchecked callocs —
    evict as much as possible. Returns bytes touched."""
    if n_bytes <= 0:
        try:
            n_bytes = os.sysconf("SC_PAGE_SIZE") * os.sysconf(
                "SC_PHYS_PAGES")
        except (ValueError, OSError, AttributeError):
            n_bytes = 1 << 30
    chunk = chunk_mb << 20
    nb_iter = max(1, (n_bytes + chunk - 1) // chunk)
    progress = Progress(nb_iter, "clear cache", verbose=verbose)
    touched = 0
    blocks = []
    for _ in range(nb_iter):
        size = min(chunk, n_bytes - touched)
        if size <= 0:
            break
        try:
            block = np.empty(size, np.uint8)
            block[::4096] = 1      # touch every page
        except MemoryError:
            break                  # evicted what we could
        blocks.append(block)
        touched += size
        progress.inc(1)
    progress.finish()
    del blocks
    return touched


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mb = int(argv[0]) if argv else 0
    clear(mb << 20)
    return 0


if __name__ == "__main__":
    sys.exit(main())

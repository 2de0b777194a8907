"""Time ``tile_sort`` and the whole limb sort over tile sizes and rows per
thread on one CUDA card.

    python -m gatb_core_tpu_torch.tools.sort_sweep [--shape P,LOG2_ROWS ...]

For every shape (default: 2 and 3 planes x 2^25 rows, 5 x 2^24) and for
builds of the kernels with 4, 8 and 16 rows per thread (``-DSORT_ITEMS``,
each a library of its own under ``_build/``) it times, for tiles of 2^9 ..
2^14 rows that the build takes: ``tile_sort`` alone through its C entry
point, and the whole sort (that ``tile_sort``, then the wrapper's merge
levels), on a fresh copy of the same random rows made outside the clock
(CUDA events, median of 7 after 2 warm-up calls), the sorted rows held
against the plain sort. Beside them: ``Tensor.copy_`` of the same bytes, the
plain sort, and for two planes one ``torch.sort`` of the rows joined into
int64 keys. Then ``bitonic_sort_u64`` on 2^14 and 2^22 pairs over the same
tiles and builds beside ``torch.sort``, each call alone (CUDA
events, the device idle before it) and 2000 calls back to back (host clock,
one synchronise at the end: what a caller in a loop pays per call, host
work included). The wrappers' own choice
(``limb_sort.sort_tile_rows``, ``U64_TILE_ROWS``, ``SORT_ITEMS``) is marked
with ``*``.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from ..ops import limb_sort as S

DEFAULT_SHAPES = ("2,25", "3,25", "5,24")
TILES = tuple(1 << t for t in range(9, 15))


def event_ms(fn, setup=None, warm: int = 2, reps: int = 7) -> float:
    times = []
    for r in range(warm + reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if r >= warm:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def back_to_back_ms(fn, calls: int = 2000) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def checked(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def sweep(P: int, n: int, gen) -> None:
    x = torch.randint(-2**31, 2**31 - 1, (P, n), dtype=torch.int32,
                      device="cuda", generator=gen)
    y = torch.empty_like(x)
    ref = S.sort_u32_limbs_plain(x)
    shape = f"{P} x 2^{n.bit_length() - 1} rows"
    chosen = min(S.sort_tile_rows(P), n)
    for items in (4, 8, 16):
        lib = S.load_library(items)
        for tile in TILES:
            if tile > min(S.sort_tile_max(P, items), n):
                print(f"{shape}: tile {tile:5d}, {items:2d} rows per thread: "
                      "does not fit one block", flush=True)
                continue

            def tile_sort():
                checked(lib.limb_tile_sort(y.data_ptr(), n, P, tile,
                                           S._stream(y)), "tile_sort")

            out = []

            def whole():
                tile_sort()
                out[:] = [S._merge_levels(y, tile, None)]

            tile_ms = event_ms(tile_sort, setup=lambda: y.copy_(x))
            whole_ms = event_ms(whole, setup=lambda: y.copy_(x))
            if not torch.equal(out[0], ref):
                raise RuntimeError(f"the sort differs at tile {tile}, "
                                   f"{items} rows per thread")
            mark = "*" if (tile, items) == (chosen, S.SORT_ITEMS) else " "
            print(f"{shape}: tile {tile:5d}, {items:2d} rows per thread{mark} "
                  f"tile_sort {tile_ms:.4f} ms, whole sort {whole_ms:.4f} ms",
                  flush=True)
    print(f"{shape}: copy_ of the same bytes "
          f"{event_ms(lambda: y.copy_(x)):.4f} ms, plain sort "
          f"{event_ms(lambda: S.sort_u32_limbs_plain(x), reps=3):.4f} ms",
          flush=True)
    if P == 2:
        keys = ((x[0].long() & 0xFFFFFFFF) << 32) | (x[1].long() & 0xFFFFFFFF)
        print(f"{shape}: torch.sort of the rows as int64 keys "
              f"{event_ms(lambda: torch.sort(keys)):.4f} ms", flush=True)


def sweep_u64(n: int, gen) -> None:
    x = torch.randint(-2**31, 2**31 - 1, (2, n), dtype=torch.int32,
                      device="cuda", generator=gen)
    ref = torch.stack(S.bitonic_sort_u64_plain(x[0], x[1]))
    out = torch.empty_like(x)
    shape = f"bitonic_sort_u64, 2^{n.bit_length() - 1} pairs"
    got = []

    def sort_at(lib, tile: int):
        def sort():
            checked(lib.limb_bitonic_u64(x[0].data_ptr(), x[1].data_ptr(),
                                         out.data_ptr(), n, tile,
                                         S._stream(x)), "bitonic_u64")
            got[:] = [S._merge_levels(out, tile, None)]
        return sort

    chosen = min(S.U64_TILE_ROWS, n)
    for items in (4, 8, 16):
        lib = S.load_library(items)
        for tile in TILES:
            if tile > min(items * S.sort_max_threads(2, items), n):
                continue
            ms = event_ms(sort_at(lib, tile))
            if not torch.equal(got[0], ref):
                raise RuntimeError(f"bitonic_u64 differs at tile {tile}, "
                                   f"{items} rows per thread")
            mark = "*" if (tile, items) == (chosen, S.SORT_ITEMS) else " "
            print(f"{shape}: tile {tile:5d}, {items:2d} rows per thread{mark} "
                  f"{ms:.4f} ms", flush=True)
    keys = ((x[0].long() & 0xFFFFFFFF) << 32) | (x[1].long() & 0xFFFFFFFF)
    print(f"{shape}: the wrapper "
          f"{event_ms(lambda: S.bitonic_sort_u64(x[0], x[1])):.4f} ms, "
          f"torch.sort of int64 keys "
          f"{event_ms(lambda: torch.sort(keys)):.4f} ms", flush=True)
    bare = sort_at(S.load_library(), chosen)
    print(f"{shape}, back to back: the wrapper "
          f"{back_to_back_ms(lambda: S.bitonic_sort_u64(x[0], x[1])):.4f} "
          f"ms, without its checks and its allocation of the result (tile "
          f"{chosen}) {back_to_back_ms(bare):.4f} ms, torch.sort of int64 "
          f"keys {back_to_back_ms(lambda: torch.sort(keys)):.4f} ms",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", action="append",
                    help="planes,log2(rows); may be repeated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sort_sweep: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}; {card}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for spec in args.shape or DEFAULT_SHAPES:
        P, lg_n = (int(v) for v in spec.split(","))
        sweep(P, 1 << lg_n, gen)
    for lg_n in (14, 22):
        sweep_u64(1 << lg_n, gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

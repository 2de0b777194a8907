"""Time ``merge_tiles`` over tile sizes and rows per thread on one CUDA card.

    python -m gatb_core_tpu_torch.tools.merge_sweep [--shape P,LOG2_ROWS,LOG2_RUN ...]

For every shape (default: the fold merge of the stress count, 3 planes x
2^26 rows at run 2^25; a sort level, 2 x 2^25 at run 2^14; 5 x 2^24 and
9 x 2^23 at half the rows) it sorts random runs, then times the kernel
through its C entry point for tiles of 512 .. 8192 rows and 4, 8 and 16
rows per thread (CUDA events, median of 9 after 2 warm-up launches), each
output held against the wrapper's. Beside them: ``merge_partition`` at the
same tile, and ``Tensor.copy_`` of the same bytes, the practical floor of
one trip through device memory. The wrapper's own choice
(``limb_sort.merge_tile_rows``, ``MERGE_ITEMS``) is marked with ``*``.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from ..ops import limb_sort as S

DEFAULT_SHAPES = ("3,26,25", "2,25,14", "5,24,23", "9,23,22")


def event_ms(fn, warm: int = 2, reps: int = 9) -> float:
    times = []
    for r in range(warm + reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if r >= warm:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def sweep(P: int, n: int, run: int, gen) -> None:
    x = torch.randint(-2**31, 2**31 - 1, (P, n), dtype=torch.int32,
                      device="cuda", generator=gen)
    x = S.tile_sort_plain(x, run)
    out = torch.empty_like(x)
    lib = S._lib()
    chosen = min(S.merge_tile_rows(P), 2 * run)
    ref = S.merge_sorted_runs(x, run)
    shape = f"{P} x 2^{n.bit_length() - 1} rows, run 2^{run.bit_length() - 1}"
    for tile in (512, 1024, 2048, 4096, 8192):
        if tile > 2 * run or S.merge_smem_bytes(P, tile) > S.SMEM_BYTES:
            continue
        split = S.merge_partition(x, run, tile)
        part_ms = event_ms(lambda: S.merge_partition(x, run, tile))
        for items in (4, 8, 16):
            if tile // items > 1024:
                continue

            def launch():
                rc = lib.limb_merge_tiles(x.data_ptr(), out.data_ptr(),
                                          split.data_ptr(), n, P, run, tile,
                                          items, S._stream(x))
                if rc != 0:
                    raise RuntimeError(f"merge_tiles: CUDA error {rc}")

            ms = event_ms(launch)
            if not torch.equal(out, ref):
                raise RuntimeError(f"merge_tiles differs at tile {tile}, "
                                   f"{items} rows per thread")
            mark = "*" if (tile, items) == (chosen, S.MERGE_ITEMS) else " "
            print(f"{shape}: tile {tile:5d}, {items:2d} rows per thread{mark} "
                  f"merge_tiles {ms:.4f} ms, merge_partition {part_ms:.4f} ms",
                  flush=True)
    print(f"{shape}: copy_ of the same bytes "
          f"{event_ms(lambda: out.copy_(x)):.4f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", action="append",
                    help="planes,log2(rows),log2(run); may be repeated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("merge_sweep: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}; {card}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for spec in args.shape or DEFAULT_SHAPES:
        P, lg_n, lg_run = (int(v) for v in spec.split(","))
        sweep(P, 1 << lg_n, 1 << lg_run, gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

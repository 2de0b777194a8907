"""Run a cell's control: the plain reference with 32-bit k-mer keys in
the program's place (``reference/control.py``), judged as a run of the
cell is, at the cell's own size, on each seed given.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed with the numbers compared and whether the
control came out correct; it has to come out not correct. The
benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from benchmark import harness

    spec = harness.load_spec(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        compared, failed = spec.driver.control(spec.config, spec.traffic,
                                               seed, "cuda")
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": all(v <= lim for v, lim in compared.values()),
            "failed": failed, "seconds": time.perf_counter() - t0,
            "compared": {k: {"value": v, "limit": lim}
                         for k, (v, lim) in compared.items()}}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

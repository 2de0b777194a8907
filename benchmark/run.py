"""Run one cell of the port's benchmark on the card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether
the window's outputs equal the plain reference's (``correct``), the
steps attempted and failed, the cell's metrics (the end-to-end ones, or
with ``--trace 1`` the per-layer ones), the device, and last the numbers
compared, each with its limit (also the last lines of standard error).
Exits non-zero with no result where there is no CUDA card, or too few.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.load_spec(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the port on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec.cell["chips"]:
        print(f"{spec.cell['chips']} cards needed, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    return harness.run(spec, args.seed, args.seconds, bool(args.trace),
                       "cuda", T_START)


if __name__ == "__main__":
    sys.exit(main())

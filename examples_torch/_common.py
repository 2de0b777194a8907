"""The device flag every example mirror takes.

    python examples_torch/debruijn4_simplify.py                # on the card
    python examples_torch/debruijn4_simplify.py --device cpu   # on the CPU
"""

from __future__ import annotations

import sys


def device() -> str:
    """Read ``--device NAME`` (or ``--device=NAME``) and remove it from
    ``sys.argv``, so that the script reads its own arguments after it;
    ``"cuda"`` when the flag is absent. Nothing probes for a card: a
    script run on a machine without one and without ``--device cpu``
    fails."""
    argv = sys.argv
    for i, arg in enumerate(argv[1:], 1):
        if arg == "--device" and i + 1 < len(argv):
            name = argv[i + 1]
            del argv[i:i + 2]
            return name
        if arg.startswith("--device="):
            del argv[i]
            return arg.split("=", 1)[1]
    return "cuda"

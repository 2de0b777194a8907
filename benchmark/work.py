"""The yardstick of the roofline shares: the card's published peaks and
the least bytes each measured call needs.

Peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3): 3.35 TB/s of
device memory, 67 TFLOP/s outside the tensor cores (``chip_smoke.py``'s
``bound()`` used the same two). They hold at the card's full 700 W; the
card's ``power.limit`` is printed beside every share, since a card set
lower runs slower under load.
"""

from __future__ import annotations

import subprocess

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def query_bytes(n_kmers: int, limbs: int, rank_bytes: int) -> int:
    """Least bytes of one batch of node queries through ``node_index`` and
    ``adjacency_masks``, whatever implements them: per k-mer its row read
    once, the one table row that matches or brackets it, its rank written,
    the one table row each of its 8 neighbour candidates needs, and its
    mask written. Real random reads move whole 32-byte sectors, so the
    share this gives is a floor on how far the calls are from the card."""
    row = 4 * limbs
    return n_kmers * (row + row + rank_bytes + 8 * row + 1)


def bound_s(n_bytes: int, n_ops: int = 0) -> float:
    """Least seconds the card could take: the larger of the bytes over
    its memory rate and the operations over its peak."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S)


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them
    (empty where it is not there)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    name, _, limit = out[0].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}

"""The least bytes of a k-mer count, the yardstick of ``count_roofline``.

Whatever implements the count, it reads each read's 2-bit codes once,
writes each k-mer window's row (W 32-bit limbs) once and reads it once
to reduce it, and writes each distinct row with its 4-byte count once.
"""

from __future__ import annotations


def count_bytes(windows: int, limbs: int, distinct: int, bases: int) -> int:
    """Least bytes of one count: ``windows`` k-mer windows of ``limbs``
    limbs, ``distinct`` rows after the reduce, ``bases`` read bases."""
    row = 4 * limbs
    return 2 * windows * row + distinct * (row + 4) + (bases + 3) // 4

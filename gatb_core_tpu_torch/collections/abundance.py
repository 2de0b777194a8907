"""8-bit discretized abundance map (MapMPHF port).

Bit-exact port of the 257-breakpoint discretization scheme storing
abundances 0..50000 on 8 bits with <=5% error
(tools/collections/impl/MapMPHF.hpp:84-140) and the populate mapping
idx = upper_bound(breaks, abundance) - 1 (kmer/impl/MPHFAlgorithm.cpp:255-267).
``discretize``/``dediscretize`` are the host side (numpy);
``discretize_j``/``dediscretize_j`` keep the JAX module's names for the same
maps over tensors on any device.
"""

from __future__ import annotations

import numpy as np
import torch


def discretization_breaks() -> np.ndarray:
    """The 257-entry breakpoint table (MapMPHF.hpp initDiscretizationScheme)."""
    breaks = [0]
    total = 0
    for count, step in ((70, 1), (15, 2), (40, 10), (25, 20), (40, 100),
                        (25, 200), (40, 1000)):
        for _ in range(count):
            total += step
            breaks.append(total)
    breaks.append(total)  # [256] = max (50000)
    return np.asarray(breaks, dtype=np.int32)


_BREAKS = discretization_breaks()
MAX_ABUNDANCE_DISCRETE = int(_BREAKS[255])


def discretize(abundances: np.ndarray) -> np.ndarray:
    """Abundance -> 8-bit code (np.searchsorted == std::upper_bound - 1)."""
    a = np.asarray(abundances)
    idx = np.searchsorted(_BREAKS, a, side="right") - 1
    # above-precision values clamp to the last real cell (index 255)
    idx = np.where(a > MAX_ABUNDANCE_DISCRETE, 255, idx)
    return np.clip(idx, 0, 255).astype(np.uint8)


def dediscretize(codes: np.ndarray) -> np.ndarray:
    """8-bit code -> representative abundance (the cell's breakpoint)."""
    return _BREAKS[np.asarray(codes, dtype=np.int64)].astype(np.int32)


def discretize_j(abundances: torch.Tensor) -> torch.Tensor:
    """``discretize`` over a tensor, on its device: (N,) uint8 codes."""
    a = abundances.to(torch.int32)
    breaks = torch.from_numpy(_BREAKS).to(a.device)
    idx = torch.searchsorted(breaks, a, right=True) - 1
    idx = torch.where(a > MAX_ABUNDANCE_DISCRETE,
                      torch.full_like(idx, 255), idx)
    return idx.clamp(0, 255).to(torch.uint8)


def dediscretize_j(codes: torch.Tensor) -> torch.Tensor:
    """``dediscretize`` over a tensor, on its device: (N,) int32."""
    return torch.from_numpy(_BREAKS).to(codes.device)[codes.to(torch.int64)]

"""Nucleotide codecs: ASCII <-> 2-bit, validity masks, revcomp bit tricks.

Port of gatb_core_tpu/ops/bitpack.py. Conventions (must match gatb-core
bit-for-bit):
  - A=0, C=1, T=2, G=3 via ``(ascii >> 1) & 3``; complement is ``x ^ 2``
    (gatb-core: src/gatb/tools/misc/api/Data.hpp:185, kmer/api/IModel.hpp:73-84)
  - a character is valid iff it is one of ACGTacgt
    (gatb-core: Data.hpp validNucleotide[] table)

The host half is numpy. The device half takes torch integer tensors and
computes in int64 holding zero-extended uint32 values: torch has no
unsigned 32-bit shifts or comparisons, so every left shift is masked
back to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

NUCLEOTIDES = "ACTG"  # index == code

_VALID_NP = np.zeros(256, dtype=bool)
for _ch in b"ACGTacgt":
    _VALID_NP[_ch] = True


def ascii_to_codes_np(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 ASCII array -> (codes uint8, valid bool). Host-side numpy."""
    buf = np.asarray(buf, dtype=np.uint8)
    codes = (buf >> 1) & 3
    valid = _VALID_NP[buf]
    return codes, valid


def string_to_codes(seq: str) -> tuple[np.ndarray, np.ndarray]:
    return ascii_to_codes_np(np.frombuffer(seq.encode("ascii"), dtype=np.uint8))


def codes_to_string(codes: np.ndarray) -> str:
    return "".join(NUCLEOTIDES[c] for c in np.asarray(codes))


def ascii_to_codes(buf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side: uint8 ASCII tensor -> (codes uint8, valid bool), on
    the tensor's device."""
    buf = buf.to(torch.uint8)
    codes = (buf >> 1) & 3
    up = buf & 0xDF  # fold lowercase onto uppercase
    valid = (up == 65) | (up == 67) | (up == 71) | (up == 84)  # A C G T
    return codes, valid


def pack_batch_np(codes: np.ndarray, valid: np.ndarray):
    """Host-side packing of a (B, L) code/validity batch into the packed
    transfer format (2 bits/base + 1 bit/base): (words (B, ceil(L/16))
    uint32 MSB-first, vmask (B, ceil(L/32)) uint32 bit31-first).

    Matches ops/kmer_ops.pack_words / pack_valid bit-for-bit; used by the
    Python batch-builder fallback (the native batcher packs in C++)."""
    B, L = codes.shape
    pad = (-L) % 16
    c = codes.astype(np.uint32)
    if pad:
        c = np.concatenate([c, np.zeros((B, pad), np.uint32)], axis=1)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32))[None, None, :]
    words = (c.reshape(B, -1, 16) << shifts).sum(axis=2, dtype=np.uint32)
    padv = (-L) % 32
    v = valid.astype(np.uint32)
    if padv:
        v = np.concatenate([v, np.zeros((B, padv), np.uint32)], axis=1)
    shifts_v = (31 - np.arange(32, dtype=np.uint32))[None, None, :]
    vmask = (v.reshape(B, -1, 32) << shifts_v).sum(axis=2, dtype=np.uint32)
    return words, vmask


def as_u32_i64(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor holding uint32 bit patterns -> int64 tensor of
    the zero-extended values. int32 input is read as raw 32-bit storage
    (the port's plane layout)."""
    if x.dtype == torch.int64:
        return x
    if x.dtype == torch.int32:
        return x.to(torch.int64) & M32
    return x.to(torch.int64)


def revcomp_u32(mmer: torch.Tensor, m: int) -> torch.Tensor:
    """Reverse complement of an m-mer packed in uint32 (2 bits/base, m <= 16).

    Matches LargeInt revcomp semantics: reverse the base order and complement
    each base (complement = code ^ 2). int64 in, int64 out.
    """
    x = as_u32_i64(mmer)
    # Reverse 2-bit fields within 32 bits (classic bit-reversal by pairs).
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    x = ((x >> 16) | (x << 16)) & M32
    # complement every base: XOR with 0b10 pattern
    x = x ^ 0xAAAAAAAA
    # bases sit in the top 2m bits now; shift down
    return x >> (32 - 2 * m)


def mmer_allowed(mmer: torch.Tensor, m: int) -> torch.Tensor:
    """Lexicographic-mode banned-minimizer test, bit-exact port of
    ModelMinimizer::is_allowed (gatb-core: kmer/impl/Model.hpp:1219-1252).

    Bans m-mers containing 'AA' anywhere except at the start.
    """
    mm = as_u32_i64(mmer)
    mmask_m1 = (1 << ((m - 2) * 2)) - 1
    mask_ma1 = 0x55555555 & mmask_m1
    a1 = ~(mm | (mm >> 2)) & M32
    a1 = ((a1 >> 1) & a1) & mask_ma1
    return a1 == 0

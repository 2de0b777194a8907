"""Vectorized 64-bit unsigned arithmetic on ``torch.int64`` tensors.

Port of gatb_core_tpu/ops/u64.py. The JAX package carries every 64-bit
quantity (hash values, Bloom indices, k-mer words) as a pair of uint32
arrays ``(hi, lo)`` because its device has no 64-bit integer unit. torch
has int64 but no uint64 arithmetic, so here a 64-bit unsigned value is one
int64 holding the same 64 bits: add, subtract, multiply, xor and left shift
wrap around and give the right bits as they are; what differs from C's
``uint64_t`` is written out below: ``>>`` on int64 is arithmetic, so a
logical right shift masks after the shift; ``<`` is signed, so the unsigned
compare flips the sign bit of both sides first; there is no unsigned ``%``
and no 128-bit product, so ``u64_mod_u32`` and ``u64_mulhi`` work on 32- and
16-bit pieces that stay non-negative.

The ``U64`` class of the JAX module shrinks to helpers that make, join and
split such values: ``U64.from_int``, ``U64.from_u32``, ``u64_join``,
``u64_split``. All ops are elementwise and run on the device of their
inputs.

Bit-exact ports of the reference hash functions:
  - hash64   (gatb-core: src/gatb/tools/math/NativeInt64.hpp:175-188)
  - oahash64 (gatb-core: src/gatb/tools/math/NativeInt64.hpp:191-203)
"""

from __future__ import annotations

import torch

I64 = torch.int64
M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def s64(value: int) -> int:
    """The Python int whose int64 two's complement is ``value`` mod 2^64."""
    value &= 0xFFFFFFFFFFFFFFFF
    return value - (1 << 64) if value >> 63 else value


def u64_join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 halves (int32 storage or zero-extended int64) -> the
    64-bit value."""
    return ((hi.to(I64) & M32) << 32) | (lo.to(I64) & M32)


def u64_split(a: torch.Tensor):
    """The 64-bit value -> (hi, lo) halves as zero-extended int64."""
    return (a >> 32) & M32, a & M32


class U64:
    """Makers of 64-bit unsigned values (int64 tensors of the same bits)."""

    @staticmethod
    def from_int(value: int, like: torch.Tensor) -> torch.Tensor:
        return torch.full(like.shape, s64(value), dtype=I64,
                          device=like.device)

    @staticmethod
    def from_u32(lo: torch.Tensor) -> torch.Tensor:
        return lo.to(I64) & M32


def u64_xor(a, b):
    return a ^ b


def u64_not(a):
    return ~a


def u64_add(a, b):
    return a + b


def u64_sub(a, b):
    """a - b with C uint64_t wrap-around semantics."""
    return a - b


def u64_shl(a, n: int):
    """Left shift by a static amount 0 <= n < 64."""
    return a << n if n else a


def u64_shr(a, n: int):
    """Logical right shift by a static amount 0 <= n < 64: the arithmetic
    shift's copies of the sign bit are masked off."""
    return (a >> n) & ((1 << (64 - n)) - 1) if n else a


def u64_mul(a, b):
    """64x64 -> low 64 bits multiply (C uint64_t semantics)."""
    return a * b


def u64_eq(a, b):
    return a == b


def u64_lt(a, b):
    """Unsigned a < b: a signed compare after flipping the sign bits."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def u64_mulhi(a: torch.Tensor, bh: int, bl: int) -> torch.Tensor:
    """High 64 bits of the 64x64->128 product a * (bh*2^32 + bl), where
    (bh, bl) is a STATIC 64-bit constant. Exact: schoolbook over 32-bit
    halves, each partial product below 2^64 (so its wrapped int64 holds its
    exact bits), with the carries of the middle column tracked."""
    ah, al = u64_split(a)
    t_hi = u64_shr(al * bl, 32)                  # al*bl: only hi32 matters
    u = al * bh
    v = ah * bl
    w = ah * bh
    s1 = u + v
    c1 = u64_lt(s1, u).to(I64)                   # carry of u+v
    s2 = s1 + t_hi
    c2 = u64_lt(s2, s1).to(I64)                  # carry of +t_hi
    # hi128 = w + (mid >> 32) + carries*2^32
    return w + u64_shr(s2, 32) + ((c1 + c2) << 32)


def u64_mod_u32(a: torch.Tensor, m: int) -> torch.Tensor:
    """a mod m for a static modulus 1 <= m < 2^32, over the full unsigned
    64-bit range of a. Returns the remainder as int64 in [0, m).

    The JAX module reduces with a Barrett reciprocal because it has no
    64-bit divide; here the remainder is carried down the value in 32-,
    16- and 16-bit steps, ``r = ((r << 16) | next16) % m``, so every
    intermediate is non-negative and below 2^48 and int64's signed ``%`` is
    the unsigned one."""
    if not (1 <= m < (1 << 32)):
        raise ValueError(f"u64_mod_u32: modulus {m} out of range")
    if m == 1:
        return torch.zeros_like(a)
    if m & (m - 1) == 0:  # power of two
        return a & (m - 1)
    hi, lo = u64_split(a)
    r = hi % m
    r = ((r << 16) | (lo >> 16)) % m
    return ((r << 16) | (lo & 0xFFFF)) % m


# ---------------------------------------------------------------------------
# Reference hash functions (bit-exact ports)
# ---------------------------------------------------------------------------


def hash64(key: torch.Tensor, seed) -> torch.Tensor:
    """Bit-exact port of NativeInt64::hash64 (NativeInt64.hpp:175-188).
    ``seed`` is a tensor like ``key`` or a Python int (any sign)."""
    hash_ = seed if isinstance(seed, torch.Tensor) \
        else U64.from_int(seed, like=key)
    # hash ^= (hash << 7) ^ key * (hash >> 3) ^ ~((hash << 11) + (key ^ (hash >> 5)))
    t1 = hash_ << 7
    t2 = key * u64_shr(hash_, 3)
    t3 = ~((hash_ << 11) + (key ^ u64_shr(hash_, 5)))
    hash_ = hash_ ^ t1 ^ t2 ^ t3
    # hash = (~hash) + (hash << 21)
    hash_ = ~hash_ + (hash_ << 21)
    hash_ = hash_ ^ u64_shr(hash_, 24)
    # hash = (hash + (hash << 3)) + (hash << 8)
    hash_ = hash_ + (hash_ << 3) + (hash_ << 8)
    hash_ = hash_ ^ u64_shr(hash_, 14)
    # hash = (hash + (hash << 2)) + (hash << 4)
    hash_ = hash_ + (hash_ << 2) + (hash_ << 4)
    hash_ = hash_ ^ u64_shr(hash_, 28)
    return hash_ + (hash_ << 31)


def oahash64(elem: torch.Tensor) -> torch.Tensor:
    """Bit-exact port of NativeInt64::oahash64 (NativeInt64.hpp:191-203)."""
    code = elem
    code = code ^ u64_shr(code, 14)
    code = ~code + (code << 18)
    code = code ^ u64_shr(code, 31)
    code = code * 21
    code = code ^ u64_shr(code, 11)
    code = code + (code << 6)
    return code ^ u64_shr(code, 22)

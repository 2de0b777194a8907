"""BankBinary: 2-bit packed binary sequence bank + converter.

Port of gatb-core BankBinary (bank/impl/BankBinary.cpp: 2-bit packed
blocks) and BankConverterAlgorithm. Format (this engine's v1):

  magic 'GTBB' u32 | version u32 | nb_seqs u64
  per sequence: u32 length | u32 packed_bytes | packed 2-bit data
                (4 nt/byte, first nt in the low bits — numpy unpack order)

Invalid characters are not representable in 2 bits: like the reference
binary bank, they are converted to 'A' (validity is a property of the
original bank; binary banks exist as a fast re-read format for
multi-pass algorithms).
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

from .fasta import IBank, Sequence
from ..ops.bitpack import ascii_to_codes_np

MAGIC = 0x47544242  # 'GTBB'


def pack_codes(codes: np.ndarray) -> bytes:
    n = len(codes)
    padded = np.zeros((n + 3) // 4 * 4, np.uint8)
    padded[:n] = codes
    packed = (padded[0::4] | (padded[1::4] << 2) | (padded[2::4] << 4)
              | (padded[3::4] << 6))
    return packed.tobytes()


def unpack_codes(buf: bytes, n: int) -> np.ndarray:
    packed = np.frombuffer(buf, np.uint8)
    out = np.empty(len(packed) * 4, np.uint8)
    out[0::4] = packed & 3
    out[1::4] = (packed >> 2) & 3
    out[2::4] = (packed >> 4) & 3
    out[3::4] = (packed >> 6) & 3
    return out[:n]


class BankBinary(IBank):
    """Reader over the packed binary bank format."""

    NUCLEOTIDES = "ACTG"

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[Sequence]:
        with open(self.path, "rb") as f:
            magic, version = struct.unpack("<II", f.read(8))
            if magic != MAGIC:
                raise ValueError(f"{self.path}: not a binary bank")
            (nb,) = struct.unpack("<Q", f.read(8))
            for i in range(nb):
                length, nbytes = struct.unpack("<II", f.read(8))
                codes = unpack_codes(f.read(nbytes), length)
                data = "".join(self.NUCLEOTIDES[c] for c in codes)
                yield Sequence(f"seq_{i}", data, None, i)

    def get_size(self) -> int:
        import os

        return os.path.getsize(self.path) * 4


def convert_bank(bank, out_path: str) -> int:
    """BankConverterAlgorithm: any bank -> packed binary bank.
    Returns the number of sequences written."""
    from .fasta import open_bank

    bank = open_bank(bank)
    seqs = list(bank)
    with open(out_path, "wb") as f:
        f.write(struct.pack("<IIQ", MAGIC, 1, len(seqs)))
        for s in seqs:
            codes, valid = ascii_to_codes_np(
                np.frombuffer(s.data.encode("ascii"), np.uint8))
            codes = np.where(valid, codes, 0)  # invalid -> 'A'
            packed = pack_codes(codes)
            f.write(struct.pack("<II", len(codes), len(packed)))
            f.write(packed)
    return len(seqs)

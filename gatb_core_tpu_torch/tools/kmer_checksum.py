"""KmerChecksum-equivalent CLI: checksum a binary kmer file.

Port of gatb_core_tpu/tools/kmer_checksum.py (host code). Mirrors
reference tools/KmerChecksum.cpp:41-68: iterate a binary file of
kmer values (BagFile records), print count + wrapping sum. Optional second
arg dumps each value as hex.

Usage: python -m gatb_core_tpu_torch.tools.kmer_checksum FILE [dump] [--words W]
"""

from __future__ import annotations

import argparse
import sys

from ..collections.containers import IteratorFile
from .dbgcheck import largeint_hex


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmer_checksum")
    p.add_argument("file", help="binary kmer file (BagFile records)")
    p.add_argument("dump", nargs="?", default=None,
                   help="any value: dump each kmer as hex")
    p.add_argument("--words", type=int, default=1,
                   help="64-bit words per kmer value (reference kmer_type)")
    args = p.parse_args(argv)

    words = args.words
    mod = 1 << (64 * words)
    checksum = 0
    nb_items = 0
    vals = iter(IteratorFile(args.file))
    while True:
        parts = []
        for _ in range(words):
            v = next(vals, None)
            if v is None:
                break
            parts.append(v & 0xFFFFFFFFFFFFFFFF)
        if len(parts) < words:
            break
        value = 0
        for i, w in enumerate(parts):  # little-endian word order (LargeInt)
            value |= w << (64 * i)
        if args.dump:
            print(f"0x{largeint_hex(value, words) or '0'}")
        checksum = (checksum + value) % mod
        nb_items += 1

    print(f"FOUND {nb_items} WITH CHECKSUM {largeint_hex(checksum, words) or '0'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

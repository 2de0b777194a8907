"""leon-equivalent CLI: reference-free read compression
(reference tools/leon.cpp).

The compressors count k-mers (and build the reference container's Bloom
filter) on the CUDA card; the CLI has no device flag. The coders and the
decompressor are host code.

Usage:
  python -m gatb_core_tpu_torch.tools.leon -c -file reads.fastq [-kmer-size 31]
  python -m gatb_core_tpu_torch.tools.leon -d -file reads.fastq.leon [-out x.fastq]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="leon")
    p.add_argument("-file", dest="file", required=True)
    p.add_argument("-c", dest="compress", action="store_true",
                   help="compress")
    p.add_argument("-d", dest="decompress", action="store_true",
                   help="decompress")
    p.add_argument("-kmer-size", dest="kmer_size", type=int, default=31)
    p.add_argument("-abundance", dest="abundance", type=int, default=2,
                   help="min abundance for the anchor dictionary")
    p.add_argument("-out", dest="out", default=None)
    p.add_argument("-gtbl", dest="gtbl", action="store_true",
                   help="compress to this engine's own GTBL1 container "
                        "instead of the reference .leon HDF5 format")
    p.add_argument("-lossless", dest="lossless", action="store_true",
                   help="lossless FASTQ qualities (default: the "
                        "reference's lossy smoothing, Leon.cpp:409-412)")
    args = p.parse_args(argv)

    if args.compress == args.decompress:
        print("choose exactly one of -c / -d", file=sys.stderr)
        return 1

    t0 = time.time()
    if args.compress:
        out = args.out or (args.file + ".leon")
        if args.gtbl:
            from ..compression.leon import LeonCompressor

            info = LeonCompressor(kmer_size=args.kmer_size,
                                  abundance_min=args.abundance) \
                .compress(args.file, out)
            extra = f"dict {info['dict_size']} kmers, "
        else:
            # default: the reference .leon container — decodable by the
            # reference leon binary (compression/leon_ref.py)
            from ..compression.leon_ref import leon_ref_compress

            info = leon_ref_compress(args.file, out,
                                     kmer_size=args.kmer_size,
                                     abundance_min=args.abundance,
                                     lossless=args.lossless)
            extra = f"dict {info['nb_anchors']} anchors, "
        in_size = os.path.getsize(args.file)
        ratio = in_size / max(info["compressed_bytes"], 1)
        print(f"compressed {args.file} ({in_size} B) -> {out} "
              f"({info['compressed_bytes']} B), ratio {ratio:.2f}x, "
              f"{info['nb_reads']} reads, {extra}"
              f"{time.time() - t0:.1f}s")
    else:
        from ..compression.leon import LeonDecompressor

        base = args.file[:-5] if args.file.endswith(".leon") else args.file
        out = args.out or (base + ".d")
        seqs = LeonDecompressor().decompress(args.file, out)
        print(f"decompressed {args.file} -> {out}, {len(seqs)} reads, "
              f"{time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

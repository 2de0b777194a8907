"""Leon compression interop with the reference container format.

Compresses reads into a `.leon` HDF5 container that the REFERENCE leon
binary can decompress (and decodes reference-produced `.leon` files).
Reference analogue: tools/leon.cpp usage + test/db/leon1.fastq.leon-ref.
"""

import os
import tempfile

from gatb_core_tpu_torch.compression.leon_ref import (
    leon_ref_compress, leon_ref_decompress)

from _common import device

reads = [
    "TGTCATCTAGTTCAACAACCGTTATGCCGTCCGACTCTTGCGCTCGGAT",
    "TAGTTCAACAACCGTTATGCCGTCCGACTCTTGCGCTCGGATGTCCGCA",
    "AACCGTTATGCCGTCCGACTCTTGCGCTNNGATGTCCGCAATGGGTTAT",
] * 4

dev = device()
with tempfile.TemporaryDirectory() as tmp:
    src = os.path.join(tmp, "reads.fastq")
    with open(src, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@read{i} sample:{i}\n{r}\n+\n{'I' * len(r)}\n")

    out = os.path.join(tmp, "reads.fastq.leon")
    # lossless=True: the default is the reference's lossy qual smoothing
    info = leon_ref_compress(src, out, kmer_size=21, abundance_min=1,
                             lossless=True, device=dev)
    print(f"compressed {info['nb_reads']} reads, "
          f"{info['nb_anchors']} anchors, "
          f"{info['compressed_bytes']} payload bytes")

    decoded = leon_ref_decompress(out).decode()
    orig = open(src).read()
    dl, ol = decoded.splitlines(), orig.splitlines()
    assert dl[0::4] == ol[0::4]          # headers lossless
    assert dl[1::4] == ol[1::4]          # DNA lossless (incl. Ns)
    assert dl[3::4] == ol[3::4]          # qualities lossless
    print("round trip lossless (headers + DNA + qualities)")

"""Leon compression round-trip (ref: tools/leon — reads + qualities
through the range-coder container format)."""
import os
import tempfile
from gatb_core_tpu_torch.compression.leon import (LeonCompressor,
                                                  LeonDecompressor)

from _common import device

dev = device()
_fd, fastq = tempfile.mkstemp(suffix=".fastq")
os.close(_fd)
with open(fastq, "w") as f:
    for i, seq in enumerate(["ACGTACGTACGTGGCA", "TTGACCGTAGGCATAT"]):
        f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
out = fastq + ".leon"
LeonCompressor(device=dev).compress(fastq, out)
seqs = LeonDecompressor().decompress(out)
print("lossless:", [s.data for s in seqs])

"""CLI tour: dbgh5 -> dbginfo -> dbgcheck -> dbgtopology ->
KmerChecksum (ref: the L9 tool binaries).

The tools take no device flag, as in the JAX package: dbgh5 builds its
graph on the card. ``--device`` is taken and unused here; a test on the
CPU hands ``Graph.create`` the CPU itself."""
import os
import tempfile
import struct
from gatb_core_tpu_torch.tools import (dbgcheck, dbgh5, dbginfo,
                                       dbgtopology, kmer_checksum)

from _common import device

device()

db = "/root/reference/gatb-core/test/db/reads1.fa"
tmp = tempfile.mkdtemp()
out = os.path.join(tmp, "tour.h5")
assert dbgh5.main(["-in", db, "-kmer-size", "31", "-abundance-min", "3",
                   "-out", out, "-verbose", "0"]) == 0
assert dbginfo.main(["-in", out]) == 0
assert dbgcheck.main(["-in", out]) == 0
assert dbgtopology.main(["-in", out]) == 0
# KmerChecksum reads a binary BagFile of kmer values
kf = os.path.join(tmp, "kmers.bin")
with open(kf, "wb") as f:
    for v in (3, 17, 255):
        f.write(struct.pack("<q", v))
assert kmer_checksum.main([kf]) in (0, None)
print("CLI tour complete")

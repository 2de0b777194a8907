"""Reference-format MPHF in our .h5: the /dsk/mphf byte stream loads
under the reference's BooPHF loader and vice versa
(ref: kmer/impl/MPHFAlgorithm.cpp:150-330 persistence)."""
import numpy as np
from gatb_core_tpu_torch.collections.boophf_ref import RefBooPHF

from _common import device

device()  # host only: the flag is taken and unused

rng = np.random.default_rng(6)
keys = np.unique(rng.integers(0, 2**62, size=5000, dtype=np.uint64))
mphf = RefBooPHF.build(keys[:, None])
blob = mphf.to_bytes()
again = RefBooPHF.from_bytes(blob, 1)
codes = again.lookup(keys[:, None])
print(f"{len(keys)} keys -> perfect permutation:",
      len(np.unique(codes)) == len(keys),
      f"({len(blob)} serialized bytes, reference layout)")

"""Multi-span kmer models: k across limb widths, like the reference's
KSIZE_LIST template instantiation (ref: examples/kmer/kmer2-5.cpp)."""
from gatb_core_tpu_torch.kmer.model import (canonical, revcomp, string_to_kmer,
                                      kmer_to_string)
from gatb_core_tpu_torch.ops.kmer_ops import nb_limbs

from _common import device

device()  # host only: the flag is taken and unused

for k in (15, 31, 63, 95, 127):
    s = ("ACGTGGTCA" * 15)[:k]
    v = string_to_kmer(s)
    rc = revcomp(v, k)
    c = canonical(v, k)
    assert kmer_to_string(revcomp(rc, k), k) == s
    print(f"k={k}: W={nb_limbs(k)} limbs, canonical is "
          f"{'fwd' if c == v else 'rc'}")

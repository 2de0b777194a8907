"""Kmer model basics: encoding, canonical form, minimizers
(ref: examples/kmer/kmer1.cpp, kmer2.cpp)."""
from gatb_core_tpu_torch.kmer.model import (
    ModelMinimizer, kmer_to_string, revcomp, canonical, string_to_kmer)

from _common import device

device()  # host only: the flag is taken and unused

k, m = 11, 8
model = ModelMinimizer(k, m)
seq = "ACCGTAGCATTTCGGATACA"
for value, valid, minim in model.iter_kmers(seq):
    print(kmer_to_string(value, k), valid, f"minim={minim:x}")
v = string_to_kmer("ACCGTAGCATT")
print("revcomp:", kmer_to_string(revcomp(v, k), k),
      "canonical:", kmer_to_string(canonical(v, k), k))

"""Counting with histogram and auto cutoff (ref: examples/kmer/kmer8.cpp)."""
from gatb_core_tpu_torch import count_kmers

from _common import device

res = count_kmers("/root/reference/gatb-core/test/db/reads1.fa",
                  kmer_size=31, abundance_min="auto", device=device())
print("distinct:", res.info["kmers_nb_distinct"],
      "solid:", res.info["kmers_nb_solid"],
      "auto cutoff:", res.info["abundance_min"])
print("histogram head:", res.histogram.bins[:8])

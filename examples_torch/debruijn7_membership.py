"""Bloom + cFP membership oracle vs exact membership
(ref: debruijn/impl/ContainerNode.hpp:60-90 and the debloom contract)."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.debruijn.graph import Graph

from _common import device

dev = device()

rng = np.random.default_rng(7)
genome = "".join(rng.choice(list("ACGT"), size=900))
g = Graph.create(BankStrings(genome, genome), kmer_size=15,
                 abundance_min=1, build_branching=False, device=dev)
g.set_membership_mode("bloom_cfp")
nodes = g.solid_limbs[:200]
assert g.contains(nodes).all()        # exact on the traversal closure
print("bloom+cFP oracle agrees on", len(nodes), "nodes;",
      "cFP size:", g._debloom.nb_cfp, "kind:", g._debloom.kind)

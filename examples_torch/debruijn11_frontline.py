"""Frontline BFS + Terminator marking (ref: debruijn/impl/Frontline.cpp
examples debruijn20-24 family)."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.debruijn.graph import Graph
from gatb_core_tpu_torch.debruijn.traversal import (Frontline, NodeGraphView,
                                              Terminator)

from _common import device

dev = device()

rng = np.random.default_rng(21)
genome = "".join(rng.choice(list("ACGT"), size=300))
# a bubble: same locus with one substitution
alt = genome[:150] + ("A" if genome[150] != "A" else "C") + genome[151:]
reads = [genome[i:i + 60] for i in range(0, 240, 10)]
reads += [alt[i:i + 60] for i in range(120, 200, 10)]
g = Graph.create(BankStrings(*reads), kmer_size=21, abundance_min=1,
                 device=dev)
view = NodeGraphView(g)
term = Terminator(view)
start = 2 * int(np.nonzero(view.alive)[0][0])
fl = Frontline(view, term, start)
depths = []
while fl.go_next_depth() and fl.size() and fl.depth < 30:
    depths.append(fl.size())
print(f"frontier sizes over {len(depths)} depths:",
      depths[:10], "... max", max(depths))

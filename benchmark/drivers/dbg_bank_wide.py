"""Whole banks through the assembler's main path at k > 31, judged with
the exact wide reference.

Set-up, step and release are ``dbg_bank``'s, imported and not copied:
the bank written once as FASTQ, then each step ``Graph.create(<fastq>)``
at the configuration's k-mer size and abundance cut, every other argument
at the program's default, and ``graph.unitig_graph()``. One caller, a
closed loop; a step's work is the bank's read bases.

The check works the count and the graph out again from the same reads
with ``reference.dbg_wide``, whose keys hold k <= 63 exactly as two int64
words, and compares every bank of the window with it; the unitigs of one
bank, drawn from the seed, are judged in full, and the others' must equal
them.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from benchmark import gen as G
from benchmark.harness import BENCH_DIR, load_module
from benchmark.reference import dbg_wide as R
from benchmark.reference import wide as W
from benchmark.reference.kmers import popcount4

D = load_module(os.path.join(BENCH_DIR, "drivers", "dbg_bank.py"))
LOW62 = (1 << 62) - 1


def judge(config: dict, seed: int, device, outputs: list) -> tuple:
    """Each bank's outputs against the wide reference worked out from the
    configured reads: ({name: (value, limit)}, banks that differ)."""
    k, amin = config["kmer_size"], config["abundance_min"]
    truth = R.Truth.of(G.bank_blocks(config, seed, device)[2], k, amin)
    print(R.describe(truth), file=sys.stderr)
    worst: dict = {}
    failed = 0
    pick = None                           # the control has no unitigs
    if "ug" in outputs[0]:
        pick = outputs[np.random.default_rng(seed).integers(len(outputs))]
    for o in outputs:
        nums = R.compare_count(truth, o["limbs"], o["counts"], o["info"])
        nums.update(R.compare_graph(truth, o["limbs"], o["masks"],
                                    o["branching"]))
        if pick is not None:
            nums["unitig_banks_differ"] = int(not D.same_unitigs(o["ug"],
                                                                 pick["ug"]))
        if o is pick:
            nums.update(R.check_unitigs(truth, **D.unitig_arrays(o["ug"])))
        failed += any(nums.values())
        for name, v in nums.items():
            worst[name] = max(worst.get(name, 0), v)
    return {name: (v, 0) for name, v in worst.items()}, failed


def count_low_word(blocks, k: int):
    """``wide.count`` with every canonical key cut to its low 62 bits, the
    k-mer's last 31 bases: the count of a program that drops the high
    word. Keys that differ only above them merge."""
    keys = torch.cat([W.canonical_values(b, k).reshape(-1, 2)
                      for b in blocks])
    keys[:, 0] = 0
    keys[:, 1] &= LOW62
    uniq, counts = W.unique(keys)
    return uniq, counts, keys.shape[0]


def control(config: dict, traffic: dict, seed: int, device) -> tuple:
    """The control judged as a run is: the wide reference with its keys
    cut to their low 62 bits in the program's place, for one bank."""
    k, amin = config["kmer_size"], config["abundance_min"]
    ct = R.Truth.of(G.bank_blocks(config, seed, device)[2], k, amin,
                    count=count_low_word)
    branch = (popcount4(ct.masks) != 1) | (popcount4(ct.masks >> 4) != 1)
    limbs = W.keys_to_limbs(ct.nodes.cpu().numpy(), k)
    info = {"kmers_nb_distinct": ct.distinct.shape[0],
            "kmers_nb_weak": int((ct.distinct_counts < amin).sum()),
            "kmers_nb_valid": ct.windows}
    out = {"limbs": limbs, "counts": ct.counts.cpu().numpy(), "info": info,
           "masks": ct.masks.cpu().numpy(),
           "branching": limbs[branch.cpu().numpy()]}
    del ct
    return judge(config, seed, device, [out])


class Driver(D.Driver):
    def check(self) -> tuple:
        return judge(self.config, self.ctx.seed, self.ctx.device,
                     self.outputs)

"""Whole banks through the assembler's main path, back to back.

Set-up writes the configured bank once, as FASTQ, to the run's work
directory. Each step then runs ``Graph.create(<fastq>)`` (count, MPHF,
Bloom, cascading debloom, branching) with the configuration's k-mer size
and abundance cut, every other argument at the program's default, and
then ``graph.unitig_graph()``.

One caller, a closed loop: the next bank starts when the last has ended.
A step's work is the bank's read bases. The check works the count and
the graph out again from the same reads (``reference.dbg``) and compares
every bank of the window with it; the unitigs of one bank, drawn from
the seed, are judged in full, and the others' must equal them.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from benchmark import gen as G
from benchmark.reference import control as C
from benchmark.reference import dbg as R
from benchmark.reference import kmers as K


def unitig_arrays(ug) -> dict:
    """The unitig graph as the arrays ``reference.dbg.check_unitigs``
    reads; spelling the sequences is the one slow part (a Python string
    per unitig), so it is done after the window, for the judged bank."""
    return {"chars": "".join(ug.sequences).encode("ascii"),
            "lengths": ug.unitig_lengths(), "kmer_counts": ug.kmer_counts,
            "mean_abundance": ug.mean_abundance,
            "link_offsets": ug.link_offsets,
            "link_targets": ug.link_targets}


def same_unitigs(a, b) -> bool:
    """Two banks' unitig graphs agree in every array but the sequences."""
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in (
        (a.unitig_lengths(), b.unitig_lengths()),
        (a.kmer_counts, b.kmer_counts), (a.mean_abundance, b.mean_abundance),
        (a.link_offsets, b.link_offsets), (a.link_targets, b.link_targets)))


def judge(config: dict, seed: int, device, outputs: list) -> tuple:
    """Each bank's outputs against the reference worked out from the
    configured reads: ({name: (value, limit)}, banks that differ). The
    unitigs are judged in full on one bank drawn from the seed; every
    other bank's must equal that one's."""
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
            nums["unitig_banks_differ"] = int(not same_unitigs(o["ug"],
                                                               pick["ug"]))
        if o is pick:
            nums.update(R.check_unitigs(truth, **unitig_arrays(o["ug"])))
        failed += any(nums.values())
        for name, v in nums.items():
            worst[name] = max(worst.get(name, 0), v)
    return {name: (v, 0) for name, v in worst.items()}, failed


def control(config: dict, traffic: dict, seed: int, device) -> tuple:
    """The control judged as a run is: the reference with 32-bit k-mer
    keys (``reference.control``) in the program's place, for one bank."""
    k, amin = config["kmer_size"], config["abundance_min"]
    ct = R.Truth.of(G.bank_blocks(config, seed, device)[2], k, amin,
                    count=C.count_fp)
    masks = C.FingerprintIndex(ct.nodes).masks(ct.nodes, k)
    branch = (K.popcount4(masks) != 1) | (K.popcount4(masks >> 4) != 1)
    limbs = K.values_to_limbs(ct.nodes.cpu().numpy(), k)
    info = {"kmers_nb_distinct": ct.distinct.numel(),
            "kmers_nb_weak": int((ct.distinct_counts < amin).sum()),
            "kmers_nb_valid": ct.windows}
    out = {"limbs": limbs, "counts": ct.counts.cpu().numpy(), "info": info,
           "masks": masks.cpu().numpy(),
           "branching": limbs[branch.cpu().numpy()]}
    del ct
    return judge(config, seed, device, [out])


class Driver:
    def __init__(self, config: dict, traffic: dict, ctx):
        self.config, self.traffic, self.ctx = config, traffic, ctx
        self.path = os.path.join(ctx.workdir, "bank.fastq")
        self.bases = G.n_reads(config) * config["read_len"]
        self.outputs = []

    def setup(self) -> None:
        _, _, blocks = G.bank_blocks(self.config, self.ctx.seed,
                                     self.ctx.device)
        G.write_bank(self.path, self.config, blocks)
        del blocks
        self.ctx.free()
        self.ctx.reset_peak()
        self._bank()                      # the warm-up: one whole bank

    def _bank(self) -> tuple:
        from gatb_core_tpu_torch.debruijn.graph import Graph

        cfg, dev = self.config, self.ctx.device
        k, amin = cfg["kmer_size"], cfg["abundance_min"]
        t0 = time.time_ns()
        graph = Graph.create(self.path, kmer_size=k, abundance_min=amin,
                             device=dev)
        self.ctx.sync()
        t1 = time.time_ns()
        ug = graph.unitig_graph()
        self.ctx.sync()
        t2 = time.time_ns()
        count_s = graph.info["exec_time"]
        t_count = t0 + int(count_s * 1e9)
        spans = {"count": count_s,
                 "process": graph.info["fillsolid_time.4.process"],
                 "create": (t1 - t0) / 1e9, "unitigs": (t2 - t1) / 1e9}
        out = {"limbs": graph.solid_limbs, "counts": graph.solid_counts,
               "info": dict(graph.info),
               "masks": graph.precompute_adjacency(),
               "branching": graph.branching_nodes(), "ug": ug}
        return {"t0": t0, "t1": t2, "work": self.bases, "spans": spans,
                "host_spans": [("dbg.count", t0, t_count),
                               ("dbg.graph", t_count, t1),
                               ("dbg.unitigs", t1, t2)]}, out

    def step(self) -> dict:
        rec, out = self._bank()
        self.outputs.append(out)
        return rec

    def release(self) -> None:
        pass                              # each bank's graph is dropped

    def check(self) -> tuple:
        return judge(self.config, self.ctx.seed, self.ctx.device,
                     self.outputs)

"""Minia's assembly of one stored graph, again and again: ``simplify()``
and Monument contigs.

Set-up writes the configured bank once as FASTQ (as ``dbg_bank`` does),
builds the graph once with ``Graph.create(<fastq>)`` at the
configuration's k-mer size and abundance cut, every other argument at the
program's default, keeps what the count and the graph gave for the
check, and runs one warm step. Each step then assembles that graph
again: ``graph.reset_node_state()``, ``graph.simplify()`` (tips, bulges,
erroneous connections), ``graph.contigs(traversal="monument")`` (contigs
of at least 2k+1 bases) and a synchronise.

One caller, a closed loop. A step's work is the bank's read bases, so
``bases_per_s`` reads Mbp of reads assembled per second. The check works
the count and the graph out again from the same reads and compares the
graph the steps started from; then ``reference.minia`` simplifies the
reference's graph and walks its contigs, and one step drawn from the
seed is judged in full (its deleted nodes, its simplification's numbers,
its contigs); every other step's must equal that one's.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from benchmark import gen as G
from benchmark.reference import dbg as R
from benchmark.reference import kmers as K
from benchmark.reference import minia as M

# the simplification's numbers that are compared
STATS = ("tips_removed", "bulges_removed", "ec_removed", "passes",
         "tip_removal", "bubble_removal", "ec_removal")


def _same(a: dict, b: dict) -> bool:
    """Two steps gave the same deletions, numbers and contigs."""
    return a["deleted"] == b["deleted"] and a["stats"] == b["stats"] \
        and M.canonical_contigs(a["contigs"]) \
        == M.canonical_contigs(b["contigs"])


def judge(config: dict, seed: int, device, graph: dict, steps: list,
          truth=None) -> tuple:
    """The graph the steps started from and the steps' assemblies against
    the reference worked out from the configured reads: ({name: (value,
    limit)}, steps that are wrong)."""
    k, amin = config["kmer_size"], config["abundance_min"]
    t0 = time.perf_counter()
    if truth is None:
        truth = R.Truth.of(G.bank_blocks(config, seed, device)[2], k, amin)
    print(R.describe(truth), file=sys.stderr)
    nums = R.compare_count(truth, graph["limbs"], graph["counts"],
                           graph["info"])
    nums.update(R.compare_graph(truth, graph["limbs"], graph["masks"],
                                graph["branching"]))
    t1 = time.perf_counter()
    ref = M.Minia(truth)
    ref_stats = ref.simplify()
    ref_deleted = ref.deleted()
    t2 = time.perf_counter()
    ref_contigs = ref.contigs()
    t3 = time.perf_counter()
    print(f"reference: {ref_stats}; {len(ref_contigs)} contigs, "
          f"{sum(map(len, ref_contigs))} bases; graph {t1 - t0:.1f} s, "
          f"simplify {t2 - t1:.1f} s, contigs {t3 - t2:.1f} s",
          file=sys.stderr)
    pick = steps[np.random.default_rng(seed).integers(len(steps))]
    n = len(graph["limbs"])
    gone = np.unpackbits(np.frombuffer(pick["deleted"], np.uint8),
                         count=n).astype(bool)
    dev = truth.nodes.device
    values = np.sort(K.limbs_to_values(np.asarray(graph["limbs"])[gone]))
    nums["deleted_diff"] = K.sym_diff(torch.from_numpy(values).to(dev),
                                      ref_deleted)
    nums["simplify_stats_diff"] = sum(pick["stats"][f] != ref_stats[f]
                                      for f in STATS)
    nums["contig_diff"] = M.contig_diff(pick["contigs"], ref_contigs)
    differ = [not _same(s, pick) for s in steps]
    nums["minia_steps_differ"] = sum(differ)
    bad = any(nums.values())
    failed = sum(bad or d for d in differ)
    return {name: (v, 0) for name, v in nums.items()}, failed


def control(config: dict, traffic: dict, seed: int, device) -> tuple:
    """The control judged as a run is: the reference with its erroneous-
    connection pass off in the program's place, on the reference's own
    graph."""
    k, amin = config["kmer_size"], config["abundance_min"]
    truth = R.Truth.of(G.bank_blocks(config, seed, device)[2], k, amin)
    branch = (K.popcount4(truth.masks) != 1) \
        | (K.popcount4(truth.masks >> 4) != 1)
    limbs = K.values_to_limbs(truth.nodes.cpu().numpy(), k)
    graph = {"limbs": limbs, "counts": truth.counts.cpu().numpy(),
             "info": {"kmers_nb_distinct": truth.distinct.numel(),
                      "kmers_nb_weak": int((truth.distinct_counts
                                            < amin).sum()),
                      "kmers_nb_valid": truth.windows},
             "masks": truth.masks.cpu().numpy(),
             "branching": limbs[branch.cpu().numpy()]}
    broken = M.Minia(truth, no_ec=True)
    stats = dict(broken.simplify())
    step = {"deleted": np.packbits(~broken.live.cpu().numpy()).tobytes(),
            "stats": {f: stats[f] for f in STATS},
            "contigs": broken.contigs()}
    del broken
    return judge(config, seed, device, graph, [step], truth)


class Driver:
    def __init__(self, config: dict, traffic: dict, ctx):
        self.config, self.traffic, self.ctx = config, traffic, ctx
        self.path = os.path.join(ctx.workdir, "bank.fastq")
        self.bases = G.n_reads(config) * config["read_len"]
        self.graph = None
        self.graph_out = None
        self.outputs = []

    def setup(self) -> None:
        from gatb_core_tpu_torch.debruijn.graph import Graph

        _, _, blocks = G.bank_blocks(self.config, self.ctx.seed,
                                     self.ctx.device)
        G.write_bank(self.path, self.config, blocks)
        del blocks
        self.ctx.free()
        self.ctx.reset_peak()
        cfg = self.config
        g = Graph.create(self.path, kmer_size=cfg["kmer_size"],
                         abundance_min=cfg["abundance_min"],
                         device=self.ctx.device)
        self.graph = g
        self.graph_out = {"limbs": g.solid_limbs, "counts": g.solid_counts,
                          "info": dict(g.info),
                          "masks": g.precompute_adjacency(),
                          "branching": g.branching_nodes()}
        self._assemble()                  # the warm-up: one whole step

    def _assemble(self) -> tuple:
        g = self.graph
        t0 = time.time_ns()
        g.reset_node_state()
        stats = g.simplify()
        t1 = time.time_ns()
        contigs, _ = g.contigs(traversal="monument")
        self.ctx.sync()
        t2 = time.time_ns()
        simp = g._simplifications
        out = {"deleted": np.packbits(g.node_state & 1).tobytes(),
               "stats": {"tips_removed": stats.tips_removed,
                         "bulges_removed": stats.bulges_removed,
                         "ec_removed": stats.ec_removed,
                         "passes": stats.passes,
                         "tip_removal": simp.tip_removal,
                         "bubble_removal": simp.bubble_removal,
                         "ec_removal": simp.ec_removal},
               "contigs": contigs}
        return {"t0": t0, "t1": t2, "work": self.bases,
                "spans": {"simplify": (t1 - t0) / 1e9,
                          "contigs": (t2 - t1) / 1e9},
                "host_spans": [("minia.simplify", t0, t1),
                               ("minia.contigs", t1, t2)]}, out

    def step(self) -> dict:
        rec, out = self._assemble()
        self.outputs.append(out)
        return rec

    def release(self) -> None:
        self.graph = None

    def check(self) -> tuple:
        return judge(self.config, self.ctx.seed, self.ctx.device,
                     self.graph_out, self.outputs)

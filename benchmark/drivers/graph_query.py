"""Batched node queries to a graph held on the card.

Set-up writes the configured bank as FASTQ and builds its graph once,
with ``Graph.create(<fastq>)`` at the configuration's k-mer size and
abundance cut and every other argument at its default. It then draws
``pool_batches`` batches of ``batch_reads`` further reads from the same
genome and error model; a batch is their canonical k-mers in read order
(most are nodes, those under an error mostly not): one group of reads as
GATB-core's ``Dispatcher::iterate`` hands a read-driven tool's worker
(``groupSize``, 1,000 by default). The window is one caller in
a closed loop, cycling through the pool: each step is
``graph.node_index(batch)`` and then ``graph.adjacency_masks(batch)``,
timed from the first call to the second's host array. A step's work is
the batch's k-mers.

Answers of a sample of the calls, drawn from the seed, are kept; after
the window the reference counts the bank again, compares the graph's
node set and counts with its own, and answers the kept calls' batches
itself.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from benchmark import gen as G
from benchmark.reference import control as C
from benchmark.reference import dbg as R
from benchmark.reference import kmers as K


def make_pool(config: dict, traffic: dict, gen, genome) -> list:
    """The pool of query batches: (N, W) uint32 node rows each."""
    k, per = config["kmer_size"], traffic["batch_reads"]
    n = traffic["pool_batches"] * per
    pool = []
    for block in G.reads(gen, genome, n, config["read_len"],
                         config["error_rate"], config["strands"] == "both"):
        v = K.canonical_values(block, k).cpu().numpy()
        for s in range(0, len(v), per):
            pool.append(K.values_to_limbs(v[s:s + per].reshape(-1), k))
    return pool


def judge(config: dict, seed: int, device, graph_out: dict, pool: list,
          kept: list) -> tuple:
    """The graph's nodes and counts, and each kept call's ranks and masks,
    against the reference: ({name: (value, limit)}, calls that differ)."""
    k, amin = config["kmer_size"], config["abundance_min"]
    truth = R.Truth.of(G.bank_blocks(config, seed, device)[2], k, amin)
    print(R.describe(truth), file=sys.stderr)
    nums = R.compare_count(truth, graph_out["limbs"], graph_out["counts"],
                           graph_out["info"])
    answers = {}
    rank_diff = mask_diff = failed = 0
    for i, ranks, masks in kept:
        if i not in answers:
            q = torch.from_numpy(K.limbs_to_values(pool[i])).to(device)
            answers[i] = (K.rank(truth.nodes, q).cpu().numpy(),
                          K.masks(truth.nodes, q, k).cpu().numpy())
        ref_r, ref_m = answers[i]
        ranks, masks = np.asarray(ranks), np.asarray(masks)
        dr = len(ref_r) if ranks.shape != ref_r.shape \
            else int((ranks != ref_r).sum())
        dm = len(ref_m) if masks.shape != ref_m.shape \
            else int((masks != ref_m).sum())
        rank_diff += dr
        mask_diff += dm
        failed += bool(dr or dm)
    nums.update(rank_diff=rank_diff, mask_diff=mask_diff)
    return {name: (v, 0) for name, v in nums.items()}, failed


def control(config: dict, traffic: dict, seed: int, device) -> tuple:
    """The control judged as a run is: the reference's exact node table
    answering every pool batch with membership by 32-bit fingerprint
    (``reference.control``), in the program's place."""
    k, amin = config["kmer_size"], config["abundance_min"]
    gen, genome, blocks = G.bank_blocks(config, seed, device)
    truth = R.Truth.of(blocks, k, amin)
    pool = make_pool(config, traffic, gen, genome)
    fi = C.FingerprintIndex(truth.nodes)
    kept = []
    for i, b in enumerate(pool):
        q = torch.from_numpy(K.limbs_to_values(b)).to(device)
        kept.append((i, fi.rank(q).cpu().numpy(),
                     K.masks(truth.nodes, q, k, fi.member).cpu().numpy()))
    out = {"limbs": K.values_to_limbs(truth.nodes.cpu().numpy(), k),
           "counts": truth.counts.cpu().numpy(),
           "info": {"kmers_nb_distinct": truth.distinct.numel(),
                    "kmers_nb_weak": int((truth.distinct_counts
                                          < amin).sum()),
                    "kmers_nb_valid": truth.windows}}
    del truth, fi
    return judge(config, seed, device, out, pool, kept)


class Driver:
    def __init__(self, config: dict, traffic: dict, ctx):
        self.config, self.traffic, self.ctx = config, traffic, ctx
        self.path = os.path.join(ctx.workdir, "bank.fastq")
        self.graph = None
        self.calls = 0
        self.kept = []
        self.sampled = 0
        self.rng = np.random.default_rng(ctx.seed)

    def setup(self) -> None:
        from gatb_core_tpu_torch.debruijn.graph import Graph

        cfg = self.config
        gen, genome, blocks = G.bank_blocks(cfg, self.ctx.seed,
                                            self.ctx.device)
        G.write_bank(self.path, cfg, blocks)
        self.pool = make_pool(cfg, self.traffic, gen, genome)
        del gen, genome, blocks
        self.ctx.free()
        self.ctx.reset_peak()
        self.graph = Graph.create(self.path, kmer_size=cfg["kmer_size"],
                                  abundance_min=cfg["abundance_min"],
                                  device=self.ctx.device)
        self.graph_out = {"limbs": self.graph.solid_limbs,
                          "counts": self.graph.solid_counts,
                          "info": dict(self.graph.info)}
        for b in self.pool[:self.traffic["warm_batches"]]:
            self.graph.node_index(b)
            self.graph.adjacency_masks(b)

    def step(self) -> dict:
        i = self.calls % len(self.pool)
        batch = self.pool[i]
        t0 = time.time_ns()
        ranks = self.graph.node_index(batch)
        t1 = time.time_ns()
        masks = self.graph.adjacency_masks(batch)
        t2 = time.time_ns()
        self.calls += 1
        self.keep(i, ranks, masks)
        return {"t0": t0, "t1": t2, "work": len(batch),
                "latency_s": (t2 - t0) / 1e9,
                "rank_bytes": ranks.dtype.itemsize,
                "host_spans": [("query.node_index", t0, t1),
                               ("query.adjacency_masks", t1, t2)]}

    def keep(self, i: int, ranks, masks) -> None:
        """Keep one call in ``sample_every``, as a uniform reservoir of at
        most ``max_kept`` calls over the whole window."""
        if (self.calls + self.ctx.seed) % self.traffic["sample_every"]:
            return
        item = (i, ranks, masks)
        if len(self.kept) < self.traffic["max_kept"]:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(self.sampled + 1))
            if j < len(self.kept):
                self.kept[j] = item
        self.sampled += 1

    def release(self) -> None:
        self.graph = None

    def check(self) -> tuple:
        return judge(self.config, self.ctx.seed, self.ctx.device,
                     self.graph_out, self.pool, self.kept)

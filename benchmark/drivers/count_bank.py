"""Whole banks through the k-mer count alone, back to back.

Set-up writes the configured bank once, as FASTQ, to the run's work
directory (``dbg_bank``'s set-up, imported), and counts it once as the
warm-up. Each step then runs ``count_kmers(<fastq>)`` with the
configuration's k-mer size and abundance cut, every other argument at the
program's default: the native parse, the superbatches on the card, the
streamed fetch and the processor chain, with no graph after it.

One caller, a closed loop. A step's work is the bank's read bases. The
check counts the same reads again (``reference.kmers``) and compares
every bank of the window with it: the solid k-mers, their counts, the
histogram and the k-mer totals.
"""

from __future__ import annotations

import os
import sys
import time

from benchmark import gen as G
from benchmark.harness import BENCH_DIR, load_module
from benchmark.reference import control as C
from benchmark.reference import dbg as R
from benchmark.reference import kmers as K

D = load_module(os.path.join(BENCH_DIR, "drivers", "dbg_bank.py"))


def judge(config: dict, seed: int, device, outputs: list) -> tuple:
    """Each bank's count against the reference's count of the configured
    reads: ({name: (value, limit)}, banks that differ)."""
    k, amin = config["kmer_size"], config["abundance_min"]
    distinct, dcounts, windows = K.count(G.bank_blocks(config, seed,
                                                       device)[2], k)
    solid = dcounts >= amin
    truth = R.Truth(k, amin, distinct, dcounts, windows, distinct[solid],
                    dcounts[solid], None)
    print(f"count: {truth.nodes.numel()} solid of {distinct.numel()} "
          f"distinct k-mers, {windows} windows", file=sys.stderr)
    worst: dict = {}
    failed = 0
    for o in outputs:
        nums = R.compare_count(truth, o["limbs"], o["counts"], o["info"])
        failed += any(nums.values())
        for name, v in nums.items():
            worst[name] = max(worst.get(name, 0), v)
    return {name: (v, 0) for name, v in worst.items()}, failed


def control(config: dict, traffic: dict, seed: int, device) -> tuple:
    """The control judged as a run is: the reference with 32-bit k-mer
    keys (``reference.control``) in the program's place, for one bank."""
    k, amin = config["kmer_size"], config["abundance_min"]
    distinct, counts, windows = C.count_fp(
        G.bank_blocks(config, seed, device)[2], k)
    solid = counts >= amin
    out = {"limbs": K.values_to_limbs(distinct[solid].cpu().numpy(), k),
           "counts": counts[solid].cpu().numpy(),
           "info": {"kmers_nb_distinct": distinct.numel(),
                    "kmers_nb_weak": int((~solid).sum()),
                    "kmers_nb_valid": windows}}
    del distinct, counts
    return judge(config, seed, device, [out])


class Driver(D.Driver):
    def _bank(self) -> tuple:
        from gatb_core_tpu_torch.kmer.counting import count_kmers

        cfg = self.config
        t0 = time.time_ns()
        res = count_kmers(self.path, kmer_size=cfg["kmer_size"],
                          abundance_min=cfg["abundance_min"],
                          device=self.ctx.device)
        self.ctx.sync()
        t1 = time.time_ns()
        spans = {"count": (t1 - t0) / 1e9,
                 "process": res.info["fillsolid_time.4.process"]}
        out = {"limbs": res.solid_kmers, "counts": res.solid_counts,
               "info": dict(res.info)}
        return {"t0": t0, "t1": t1, "work": self.bases, "spans": spans,
                "host_spans": [("count.count", t0, t1)]}, out

    def check(self) -> tuple:
        return judge(self.config, self.ctx.seed, self.ctx.device,
                     self.outputs)

"""Whole banks through the k-mer count in DSK's pass loop, back to back.

The deployment is a count whose table is larger than the card: each pass
keeps the k-mers whose minimizer modulo the mix's ``nb_passes`` is the
pass's number, so it holds only its share of the table. Set-up writes the
configured bank once, as FASTQ (as ``dbg_bank``'s set-up does), and the
bank's first 1/32 as a second FASTQ, which it counts once, through the
same call, as the warm-up. Each step then runs ``count_kmers(<fastq>)``
with the configuration's k-mer size and abundance cut and the mix's
``nb_passes``, every other argument at the program's default (the fold
driver, and the 2 GiB bank cache that later passes dispatch from).

One caller, a closed loop. A step's work is the bank's read bases. The
check is ``count_bank``'s: the result does not depend on the number of
passes, so the plain reference's one-pass count is the truth. Three
numbers are added: ``passes_differ``, the banks whose count did not run
the mix's number of passes; ``rows_unsorted``, the banks whose solid
k-mers are not in ascending order (the passes' parts interleave); and
``pass_split_diff``, the most distinct k-mers by which a bank's passes
depart from the plain reference's pass split (``reference.passes``), each
pass's distinct rows as the program records them (``pass_distinct``),
summed over the passes. A program that records no split is not held to
one: the number is then left out.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from benchmark import gen as G
from benchmark.harness import BENCH_DIR, load_module
from benchmark.reference import dbg as R
from benchmark.reference import kmers as K
from benchmark.reference import passes as PS

C = load_module(os.path.join(BENCH_DIR, "drivers", "count_bank.py"))
WARM_SHARE = 32               # the warm-up counts the first 1/32 of the reads

control = C.control


def ascending(limbs) -> bool:
    """Rows strictly ascending in big-endian limb order."""
    a = np.asarray(limbs)
    if len(a) < 2:
        return True
    prev, nxt = a[:-1], a[1:]
    lt = np.zeros(len(nxt), bool)
    eq = np.ones(len(nxt), bool)
    for j in range(a.shape[1]):
        lt |= eq & (prev[:, j] < nxt[:, j])
        eq &= prev[:, j] == nxt[:, j]
    return bool(lt.all())


def count_judge(config: dict, seed: int, device, outputs: list) -> tuple:
    """``count_bank.judge``, with the reference's distinct k-mers and
    their counts given back for the pass split: ({name: (value, limit)},
    banks that differ, distinct values, their counts)."""
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
    return ({name: (v, 0) for name, v in worst.items()}, failed, distinct,
            dcounts)


def split_diff(got, want) -> int:
    """Distinct k-mers by which a recorded pass split departs from the
    reference's, summed over the passes (a pass count that differs
    counts every k-mer of the passes it lacks or adds)."""
    got, want = list(got), list(want)
    n = max(len(got), len(want))
    got += [0] * (n - len(got))
    want += [0] * (n - len(want))
    return sum(abs(a - b) for a, b in zip(got, want))


def judge(config: dict, traffic: dict, seed: int, device,
          outputs: list) -> tuple:
    """``count_bank.judge`` over every bank, with the banks that ran
    another number of passes, came out unsorted or split their k-mers
    otherwise than the reference: ({name: (value, limit)}, banks that
    differ)."""
    compared, failed, distinct, dcounts = count_judge(config, seed, device,
                                                      outputs)
    nb = traffic["nb_passes"]
    odd = [o for o in outputs
           if o["info"].get("nb_passes_effective") != nb]
    unsorted = [o for o in outputs if not ascending(o["limbs"])]
    compared["passes_differ"] = (len(odd), 0)
    compared["rows_unsorted"] = (len(unsorted), 0)
    bad = odd + unsorted
    if all(o.get("pass_distinct") is not None for o in outputs):
        want = PS.split(distinct, dcounts, config["kmer_size"], nb,
                        config["abundance_min"])[0]
        diffs = [split_diff(o["pass_distinct"], want) for o in outputs]
        got = sorted({tuple(o["pass_distinct"]) for o in outputs})
        print(f"pass split (distinct k-mers a pass): reference {want}, "
              f"program {got}", file=sys.stderr)
        compared["pass_split_diff"] = (max(diffs, default=0), 0)
        bad += [o for o, d in zip(outputs, diffs) if d]
    del distinct, dcounts
    seen = {id(o) for o in bad}
    more = [o for o in outputs if id(o) in seen]
    if more:
        # banks judged right by the count that fail here
        failed += len(more) - count_judge(config, seed, device, more)[1]
    return compared, failed


class Driver(C.Driver):
    def __init__(self, config: dict, traffic: dict, ctx):
        super().__init__(config, traffic, ctx)
        self.warm_path = os.path.join(ctx.workdir, "warm.fastq")

    def setup(self) -> None:
        _, _, blocks = G.bank_blocks(self.config, self.ctx.seed,
                                     self.ctx.device)
        G.write_bank(self.path, self.config, blocks)
        del blocks
        # FASTQ records are of one length: the first reads are a prefix
        with open(self.path, "rb") as f:
            head = b"".join(f.readline() for _ in range(4))
            f.seek(0)
            n = max(1, G.n_reads(self.config) // WARM_SHARE)
            with open(self.warm_path, "wb") as w:
                w.write(f.read(n * len(head)))
        self.ctx.free()
        self.ctx.reset_peak()
        self._bank(self.warm_path)        # the warm-up: a slice of the bank
        os.remove(self.warm_path)

    def _bank(self, path: str | None = None) -> tuple:
        from gatb_core_tpu_torch.kmer.counting import count_kmers

        cfg = self.config
        t0 = time.time_ns()
        res = count_kmers(path or self.path, kmer_size=cfg["kmer_size"],
                          abundance_min=cfg["abundance_min"],
                          nb_passes=self.traffic["nb_passes"],
                          device=self.ctx.device)
        self.ctx.sync()
        t1 = time.time_ns()
        spans = {"count": (t1 - t0) / 1e9,
                 "process": res.info["fillsolid_time.4.process"]}
        out = {"limbs": res.solid_kmers, "counts": res.solid_counts,
               "info": dict(res.info),
               "pass_distinct": getattr(res, "pass_distinct", None)}
        return {"t0": t0, "t1": t1, "work": self.bases, "spans": spans,
                "host_spans": [("count.count", t0, t1)]}, out

    def check(self) -> tuple:
        return judge(self.config, self.traffic, self.ctx.seed,
                     self.ctx.device, self.outputs)

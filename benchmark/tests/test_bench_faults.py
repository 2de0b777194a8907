"""A run with the timed path broken underneath comes out not correct.

The harness's look for a card is skipped (the cells run on the CPU at a
small size); the program is broken where it produces its answers, in
each way the cells can have: an answer altered, and half of the batch
(or of the bank) left out. (One card: no exchange between chips.)"""

import dataclasses
import os

import numpy as np
import pytest

from bench_small import run, spec


def test_altered_count(monkeypatch):
    from gatb_core_tpu_torch.debruijn.graph import Graph

    create = Graph.create.__func__

    def broken(cls, *a, **kw):
        g = create(cls, *a, **kw)
        g.solid_counts = g.solid_counts.copy()
        g.solid_counts[len(g.solid_counts) // 2] += 1
        return g

    monkeypatch.setattr(Graph, "create", classmethod(broken))
    rc, line, _ = run(spec("ecoli_k31.dbg"))
    assert rc == 0 and line["correct"] is False
    assert line["compared"]["count_diff"]["value"] >= 1
    assert line["failed"] >= 1


def test_altered_unitig(monkeypatch):
    from gatb_core_tpu_torch.debruijn.graph import Graph

    unitig_graph = Graph.unitig_graph

    def broken(self):
        ug = unitig_graph(self)
        seqs = list(ug.sequences)
        i = int(np.argmax([len(s) for s in seqs]))
        s = seqs[i]
        seqs[i] = s[:-1] + "ACGT"[("ACGT".index(s[-1]) + 1) % 4]
        return dataclasses.replace(ug, sequences=seqs)

    monkeypatch.setattr(Graph, "unitig_graph", broken)
    rc, line, _ = run(spec("ecoli_k31.dbg"))
    assert rc == 0 and line["correct"] is False
    assert line["compared"]["unitig_errors"]["value"] >= 1


def test_half_the_bank_left_out(monkeypatch):
    from gatb_core_tpu_torch.debruijn.graph import Graph

    create = Graph.create.__func__

    def broken(cls, bank, *a, **kw):
        with open(bank, "rb") as f:
            lines = f.read().split(b"\n")
        half = os.path.join(os.path.dirname(bank), "half.fastq")
        with open(half, "wb") as f:
            f.write(b"\n".join(lines[:len(lines) // 8 * 4]) + b"\n")
        return create(cls, half, *a, **kw)

    monkeypatch.setattr(Graph, "create", classmethod(broken))
    rc, line, _ = run(spec("ecoli_k31.dbg"))
    assert rc == 0 and line["correct"] is False
    assert line["compared"]["valid_kmers_diff"]["value"] > 0


def test_altered_rank(monkeypatch):
    from gatb_core_tpu_torch.debruijn.graph import Graph

    node_index = Graph.node_index

    def broken(self, nodes):
        r = node_index(self, nodes).copy()
        r[len(r) // 3] += 1
        return r

    monkeypatch.setattr(Graph, "node_index", broken)
    rc, line, _ = run(spec("chr14q_k31.query"))
    assert rc == 0 and line["correct"] is False
    assert line["compared"]["rank_diff"]["value"] >= 1


@pytest.mark.parametrize("call", ["node_index", "adjacency_masks"])
def test_half_the_batch_left_out(monkeypatch, call):
    from gatb_core_tpu_torch.debruijn.graph import Graph

    method = getattr(Graph, call)

    def broken(self, nodes):
        return method(self, np.asarray(nodes)[:len(nodes) // 2])

    monkeypatch.setattr(Graph, call, broken)
    rc, line, _ = run(spec("chr14q_k31.query"))
    assert rc == 0 and line["correct"] is False
    name = {"node_index": "rank_diff", "adjacency_masks": "mask_diff"}
    assert line["compared"][name[call]]["value"] > 0

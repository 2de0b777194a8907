"""Sharded counting over a mesh of ranks (no reference analogue).

The JAX example's 8-device mesh becomes 8 ranks spawned by RankPool, one
process group over gloo: on the CPU with ``--device cpu``, and on the one
card by default, every collective staged through the host (so no time of
it is a multi-card figure). Every rank runs the same program and returns
the global result; the ranks must agree, and the first one's is printed.
"""
import numpy as np
from gatb_core_tpu_torch.parallel.exchange import (global_table,
                                                   make_count_step)
from gatb_core_tpu_torch.parallel.mesh import RankPool

from _common import device

B, L, k = 64, 120, 31


def count(mesh, codes):
    """One rank's part: every rank passes the same global batch and
    counts its rows; the table is gathered to every rank, which returns
    the line to print."""
    step = make_count_step(mesh, k)
    shards = step(codes, np.ones((B, L), bool), np.full(B, L, np.int32))
    kmers, counts = global_table(shards, 8)
    return (f"distinct kmers across 8 devices: {len(kmers)} "
            f"total: {int(counts.sum())}")


def inputs():
    """count's arguments after the mesh: the global batch."""
    rng = np.random.default_rng(0)
    return (rng.integers(0, 4, size=(B, L)).astype(np.uint8),)


def main():
    with RankPool(8, device=device(), backend="gloo") as pool:
        outs = pool.run(count, *inputs())
    assert all(o == outs[0] for o in outs)
    print(outs[0])


if __name__ == "__main__":
    main()

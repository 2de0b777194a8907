"""gatb_core_tpu_torch.ops.neighbor_ops.neighbor_masks on the CPU (its
plain version) against the JAX package's adjacency masks, bit for bit, at
every limb width: W 1, 2, 3, 4 and 8 walk the table's rank index, W 5-7
take the binary search."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatb_core_tpu.debruijn.graph import _adjacency_kernel as j_adjacency
from gatb_core_tpu.kmer.model import canonical, revcomp
from gatb_core_tpu_torch.convert import u32_to_torch
from gatb_core_tpu_torch.ops import neighbor_ops as N
from gatb_core_tpu_torch.ops import rank_search as R
from gatb_core_tpu_torch.ops.kmer_ops import nb_limbs, py_to_limbs

KS = [11, 16, 17, 31, 32, 33, 63, 65, 95, 111, 127]


def _graph(k):
    """The sorted distinct canonical k-mers of a random 1,200 bp genome
    with two palindromes (even k) and the largest k-mer among them, and
    query nodes: every table row, absent k-mers and the all-ones row."""
    rng = np.random.default_rng(k)
    bases = [int(c) for c in rng.integers(0, 4, 1200)]
    vals = []
    for s in range(len(bases) - k + 1):
        v = 0
        for c in bases[s:s + k]:
            v = (v << 2) | c
        vals.append(v)
    top = 1 << (2 * k)
    vals.append(top - 1)
    if k % 2 == 0:           # s + revcomp(s) is its own reverse complement
        for seed in (1, 2):
            half = [int(c) for c in np.random.default_rng(seed)
                    .integers(0, 4, k // 2)]
            v = 0
            for c in half + [x ^ 2 for x in reversed(half)]:
                v = (v << 2) | c
            assert revcomp(v, k) == v
            vals.append(v)
    table = np.unique(py_to_limbs([canonical(v, k) for v in vals], k),
                      axis=0)
    absent = [int.from_bytes(rng.bytes(32), "little") % top
              for _ in range(40)]
    nodes = np.concatenate([
        table, py_to_limbs([canonical(v, k) for v in absent], k),
        np.full((1, nb_limbs(k)), 0xFFFFFFFF, np.uint32)])
    return table, nodes


@pytest.mark.parametrize("k", KS)
def test_neighbor_masks_match_jax(k):
    """The plain version with and without the table's index against the
    JAX masks: the whole table live under an all-ones padded tail, fewer
    live rows, one live row and none; an empty batch; no kernel launch."""
    table, nodes = _graph(k)
    w = nb_limbs(k)
    live = len(table)
    padded = np.concatenate([table, np.full((9, w), 0xFFFFFFFF, np.uint32)])
    t_table, t_nodes = u32_to_torch(padded), u32_to_torch(nodes)
    N.reset_launches()
    R.reset_launches()
    for n in (live, live - 5, 1, 0):
        want = np.asarray(j_adjacency(jnp.asarray(nodes), jnp.asarray(padded),
                                      k, jnp.int32(n)))
        index = R.RankIndex(t_table, n)
        for got in (N.neighbor_masks(t_nodes, t_table, n, k),
                    N.neighbor_masks(t_nodes, t_table, n, k, index=index),
                    N.neighbor_masks_plain(t_nodes, t_table, n, k, index)):
            assert got.dtype == torch.uint8 and got.shape == (len(nodes),)
            assert np.array_equal(got.numpy(), want), n
        if n == live:
            # the genome's k-mers have their neighbours in the table
            assert (want[:live] != 0).mean() > 0.9
    empty = N.neighbor_masks(t_nodes[:0], t_table, live, k)
    assert empty.dtype == torch.uint8 and empty.shape == (0,)
    assert N.launches["neighbor_masks"] == 0
    assert R.launches["rank_rows"] == 0
    with pytest.raises(ValueError):
        N.neighbor_masks(t_nodes, t_table, live, k + 16)
    with pytest.raises(ValueError):
        N.neighbor_masks(t_nodes, t_table, live, k, index=R.RankIndex(
            t_table, live - 1))

"""The port's rank search (ops/rank_search, and the names of ops/sortops
and collections/sortedset that call it) against the JAX package's sort-join
and binary search: rank and found bit-equal (tolerance 0). On the CPU the
wrapper runs ``rank_rows_plain``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatb_core_tpu.collections.sortedset import (
    SortedKmerSet as JSet, _searchsorted_limbs as j_searchsorted)
from gatb_core_tpu.ops import sortops as J
from gatb_core_tpu_torch.collections.sortedset import (
    SortedKmerSet as TSet, _searchsorted_limbs as t_searchsorted)
from gatb_core_tpu_torch.convert import u32_to_torch
from gatb_core_tpu_torch.ops import rank_search as R
from gatb_core_tpu_torch.ops import sortops as T


def _mk_table(rng, n, w, cap):
    vals = rng.integers(0, 2**32 - 2, size=(n * 2, w)).astype(np.uint32)
    vals[::5, 0] |= 0x80000000          # rows above 2^31 in the top limb
    vals = np.unique(vals, axis=0)[:n]
    table = np.full((cap, w), 0xFFFFFFFF, np.uint32)
    table[:len(vals)] = vals
    return table, len(vals)


def _queries(rng, table, n, w):
    """Present, absent, duplicated, the padding row, rows below the first
    and above the last live row; 640 rows for every w."""
    hits = table[rng.integers(0, max(n, 1), 300)]
    misses = rng.integers(0, 2**32 - 2, size=(300, w)).astype(np.uint32)
    dups = np.repeat(table[rng.integers(0, max(n, 1), 10)], 3, axis=0)
    edge = np.concatenate([np.full((4, w), 0xFFFFFFFF, np.uint32),
                           np.zeros((3, w), np.uint32),
                           np.full((3, w), 0xFFFFFFFE, np.uint32)])
    q = np.concatenate([hits, misses, dups, edge])
    rng.shuffle(q)
    return q


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_rank_matches_jax_join_and_binsearch(w):
    rng = np.random.default_rng(42 + w)
    table, n = _mk_table(rng, 1000, w, cap=1024)
    q = _queries(rng, table, n, w)
    tt, tq = u32_to_torch(table), u32_to_torch(q)
    r_j, f_j = J.rank_join(jnp.asarray(table), jnp.asarray(q), n)
    r_b, f_b = J.rank_limbs(jnp.asarray(table), jnp.asarray(q), n,
                            method="binsearch")
    assert np.array_equal(np.asarray(r_j), np.asarray(r_b))
    for fn in (T.rank_join, T.rank_join_traced, T.rank_limbs,
               R.rank_rows, R.rank_rows_plain):
        rank, found = fn(tt, tq, n)
        assert rank.dtype == torch.int32 and found.dtype == torch.bool
        assert np.array_equal(rank.numpy(), np.asarray(r_j)), fn.__name__
        assert np.array_equal(found.numpy(), np.asarray(f_j)), fn.__name__
    for method in ("auto", "join", "binsearch"):
        rank, _ = T.rank_limbs(tt, tq, n, method=method)
        assert np.array_equal(rank.numpy(), np.asarray(r_j))
    # zero-extended int64 rows and a 0-d tensor n_table give the same
    rank, _ = T.rank_join_traced(torch.from_numpy(table.astype(np.int64)),
                                 torch.from_numpy(q.astype(np.int64)),
                                 torch.tensor(n))
    assert np.array_equal(rank.numpy(), np.asarray(r_j))
    with pytest.raises(ValueError):
        T.rank_limbs(tt, tq, n, method="hash")


@pytest.mark.parametrize("n_table", [0, 1, 777])
def test_rank_with_fewer_live_rows_matches_jax(n_table):
    """Rows at n_table and beyond are padding whatever they hold."""
    rng = np.random.default_rng(7)
    table, n = _mk_table(rng, 1000, 2, cap=1024)
    q = _queries(rng, table, n, 2)
    r_j, f_j = J.rank_join(jnp.asarray(table), jnp.asarray(q), n_table)
    rank, found = T.rank_join(u32_to_torch(table), u32_to_torch(q), n_table)
    assert np.array_equal(rank.numpy(), np.asarray(r_j))
    assert np.array_equal(found.numpy(), np.asarray(f_j))
    if n_table == 0:
        assert not found.any() and (rank == -1).all()


def test_rank_padding_row_and_empty_queries():
    rng = np.random.default_rng(3)
    table, n = _mk_table(rng, 50, 2, cap=128)
    tt = u32_to_torch(table)
    q = np.concatenate([table[:5], np.full((3, 2), 0xFFFFFFFF, np.uint32)])
    rank, found = T.rank_join(tt, u32_to_torch(q), n)
    assert found[:5].all() and rank[:5].tolist() == list(range(5))
    assert not found[5:].any() and (rank[5:] == -1).all()
    # even with every row of the table live, the all-ones row is not found
    rank, found = T.rank_join(tt, u32_to_torch(q), 128)
    assert not found[5:].any()
    rank, found = R.rank_rows(tt, torch.empty((0, 2), dtype=torch.int32), n)
    assert rank.shape == (0,) and found.shape == (0,)
    assert rank.dtype == torch.int32 and found.dtype == torch.bool


def test_rank_rows_checks_its_arguments():
    t = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        R.rank_rows(t.long(), t, 4)
    with pytest.raises(TypeError):
        R.rank_rows(t.T, t, 4)                      # not contiguous
    with pytest.raises(ValueError):
        R.rank_rows(t, torch.zeros((4, 3), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        R.rank_rows(t, t, 5)
    # a CPU tensor launches nothing
    before = dict(R.launches)
    R.rank_rows(t, t, 4)
    assert R.launches == before
    R.reset_launches()
    assert R.launches == {"rank_rows": 0}


def test_sortedset_and_searchsorted_match_jax():
    rng = np.random.default_rng(2)
    # a padded tail: on a table without one the JAX lower bound runs one
    # past n_table for a query above every row, the port's stops at n_table
    table, n = _mk_table(rng, 300, 2, cap=512)
    q = _queries(rng, table, n, 2)
    js = JSet(jnp.asarray(table), n)
    ts = TSet(u32_to_torch(table), n)
    assert ts.width == 2 and ts.n == n
    assert np.array_equal(ts.rank(u32_to_torch(q)).numpy(),
                          np.asarray(js.rank(jnp.asarray(q))))
    assert np.array_equal(ts.contains(u32_to_torch(q)).numpy(),
                          np.asarray(js.contains(jnp.asarray(q))))
    assert ts.rank(u32_to_torch(table[:n])).tolist() == list(range(n))
    pos = t_searchsorted(u32_to_torch(table), u32_to_torch(q), n)
    assert np.array_equal(pos.numpy(), np.asarray(
        j_searchsorted(jnp.asarray(table), jnp.asarray(q), n)))
    empty = TSet(torch.empty((0, 2), dtype=torch.int32), 0)
    assert (empty.rank(u32_to_torch(q)) == -1).all()


def test_pad_rows_sweep_chunk_and_shrink_match_jax():
    rng = np.random.default_rng(5)
    table, n = _mk_table(rng, 37, 3, cap=37)
    jp, jn = J.pad_rows_pow2(table)
    tp, tn = T.pad_rows_pow2(table)
    assert jn == tn == 37 and np.array_equal(jp, tp) and len(tp) == 64
    same, m = T.pad_rows_pow2(table[:32])
    assert m == 32 and same.shape == (32, 3)
    for args in ((1,), (5000,), (1 << 20,), (29_999_950,), (10**6, 4),
                 (100, 1, 16, 64)):
        assert T.sweep_chunk(*args) == J.sweep_chunk(*args)
    counts = np.arange(1, 38, dtype=np.int32)
    jt = J.CountTable(jnp.asarray(table), jnp.asarray(counts),
                      jnp.asarray(30, jnp.int32))
    tt = T.CountTable(u32_to_torch(table), torch.from_numpy(counts.copy()),
                      torch.tensor(30, dtype=torch.int32))
    for cap in (30, 64):
        a, b = J.shrink(jt, cap), T.shrink(tt, cap)
        assert np.array_equal(np.asarray(a.kmers),
                              b.kmers.numpy().view(np.uint32))
        assert np.array_equal(np.asarray(a.counts), b.counts.numpy())
        assert int(a.n) == int(b.n) == 30
    with pytest.raises(ValueError):
        T.shrink(tt, 29)


# ---------------------------------------------------------------------------
# The B+ index (RankIndex) and its plain walk, the kernel's CPU twin
# ---------------------------------------------------------------------------

_join_traced = jax.jit(J.rank_join_traced)


def _boundaries(b):
    """n_table at 0 and 1 and at every leaf-block and level boundary of a
    node of b rows, up to the third level."""
    return sorted({0, 1, b - 1, b, b + 1, b * b - 1, b * b, b * b + 1,
                   b ** 3 - 1, b ** 3 + 1})


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8])
def test_index_walk_matches_jax_at_every_boundary(w):
    """RankIndex + rank_rows_indexed_plain against the JAX sort-join and
    binary search, n_table at each block and level boundary under an
    all-ones padded tail (the table's own rows, padding, absent rows)."""
    b = R.node_rows(w)
    sizes = _boundaries(b)
    rng = np.random.default_rng(70 + w)
    table, top = _mk_table(rng, sizes[-1], w, cap=sizes[-1] + 5)
    tt = u32_to_torch(table)
    q = np.concatenate([_queries(rng, table, top, w), table[:top]])
    tq = u32_to_torch(q)
    for n in sizes:
        padded = table.copy()
        padded[n:] = 0xFFFFFFFF
        r_j, f_j = _join_traced(jnp.asarray(padded), jnp.asarray(q),
                                jnp.int32(n))
        tp = u32_to_torch(padded)
        index = R.RankIndex(tp, n)
        assert index.node == b
        assert all(x <= b for x in index.lengths[:1])
        rank, found = R.rank_rows_indexed_plain(index, tq)
        assert np.array_equal(rank.numpy(), np.asarray(r_j)), n
        assert np.array_equal(found.numpy(), np.asarray(f_j)), n
        # the same through the wrapper, and rows past n_table whatever
        # they hold (here the next live rows): masked by position
        for t in (tp, tt):
            got = R.rank_rows(t, tq, n, index=R.RankIndex(t, n))
            assert np.array_equal(got[0].numpy(), np.asarray(r_j)), n
        if n in (b * b - 1, b * b + 1):
            r_b, _ = J.rank_limbs(jnp.asarray(padded), jnp.asarray(q), n,
                                  method="binsearch")
            assert np.array_equal(rank.numpy(), np.asarray(r_b)), n


@pytest.mark.parametrize("w", [2, 4])
def test_index_walk_on_a_skewed_table_matches_jax(w):
    """Many rows share their top limbs (canonical k-mers cluster): nodes
    whose keys differ in the last limb only, long runs of one top limb."""
    rng = np.random.default_rng(5 + w)
    n = 3000
    rows = np.zeros((n, w), np.uint32)
    rows[:, 0] = rng.choice([0, 1, 0x80000000], size=n, p=[0.7, 0.2, 0.1])
    rows[:, -1] = rng.integers(0, 2**32 - 1, size=n, dtype=np.uint64)
    rows = np.unique(rows, axis=0)
    n = len(rows)
    table = np.full((n + 3, w), 0xFFFFFFFF, np.uint32)
    table[:n] = rows
    near = table[rng.integers(0, n, 400)].copy()
    near[::2, -1] += 1                          # neighbours of live rows
    q = np.concatenate([table[:n], near, _queries(rng, table, n, w)])
    tt, tq = u32_to_torch(table), u32_to_torch(q)
    r_j, f_j = J.rank_join(jnp.asarray(table), jnp.asarray(q), n)
    r_b, _ = J.rank_limbs(jnp.asarray(table), jnp.asarray(q), n,
                          method="binsearch")
    index = R.RankIndex(tt, n)
    rank, found = R.rank_rows_indexed_plain(index, tq)
    assert np.array_equal(rank.numpy(), np.asarray(r_j))
    assert np.array_equal(rank.numpy(), np.asarray(r_b))
    assert np.array_equal(found.numpy(), np.asarray(f_j))


def test_index_layout_and_builds():
    """Levels top first, each a whole number of nodes padded with all-ones
    keys; level 1 the last row of each leaf block; the rows in all; one
    build counted per RankIndex; an index answers for its own table only,
    and ``held_index`` checks a held one."""
    rng = np.random.default_rng(11)
    table, n = _mk_table(rng, 1000, 2, cap=1100)
    tt = u32_to_torch(table)
    R.reset_launches()
    index = R.RankIndex(tt, n)
    assert R.builds == {"rank_index": 1}
    b = index.node
    assert b == 16 and index.lengths == [-(-n // b ** 2), -(-n // b)]
    level1 = index.rows[index.offsets[1]:index.offsets[2]]
    last = [min((i + 1) * b, n) - 1 for i in range(index.lengths[1])]
    root = index.rows[:index.offsets[1]]
    assert torch.equal(root[:index.lengths[0]],
                       level1[[min((i + 1) * b, len(last)) - 1
                               for i in range(index.lengths[0])]])
    assert torch.equal(level1[:len(last)], tt[last])
    assert (level1[len(last):] == -1).all()
    for lo, hi in zip(index.offsets, index.offsets[1:]):
        assert (hi - lo) % b == 0
    m = -(-n // b)                          # level-1 keys, then padding
    assert index.offsets[-1] == len(index.rows) == b + m + -m % b
    q = tt[:10].clone()
    with pytest.raises(ValueError):
        R.rank_rows(tt.clone(), q, n, index=index)     # another table
    with pytest.raises(ValueError):
        R.rank_rows(tt, q, n - 1, index=index)         # other live rows
    assert R.held_index(tt, n, index) is index
    with pytest.raises(ValueError):
        R.held_index(tt, n - 1, index)
    assert R.builds == {"rank_index": 1}
    assert R.node_rows(1) == 32 and R.node_rows(3) == 8
    assert R.node_rows(5) == 4 and R.node_rows(8) == 4
    assert R.node_rows(9) == 2 and R.node_rows(40) == 2
    empty = R.RankIndex(tt, 0)
    assert empty.lengths == [] and empty.rows.shape == (0, 2)
    assert not R.rank_rows(tt, q, 0, index=empty)[1].any()
    R.reset_launches()


def test_surface_with_a_held_index_matches_jax():
    """rank_join_traced(..., index=), SortedKmerSet.rank (its index built
    once and kept) and one cand_sweep over a held index give the JAX
    package's answers."""
    from gatb_core_tpu.debruijn.unitigs import _cand_ranks_flips as j_cand
    from gatb_core_tpu.kmer.model import canonical, string_to_kmer
    from gatb_core_tpu_torch.debruijn.unitigs import cand_sweep

    rng = np.random.default_rng(8)
    table, n = _mk_table(rng, 700, 2, cap=768)
    q = _queries(rng, table, n, 2)
    tt, tq = u32_to_torch(table), u32_to_torch(q)
    r_j, f_j = J.rank_join(jnp.asarray(table), jnp.asarray(q), n)
    index = R.RankIndex(tt, n)
    rank, found = T.rank_join_traced(tt, tq, n, index=index)
    assert np.array_equal(rank.numpy(), np.asarray(r_j))
    assert np.array_equal(found.numpy(), np.asarray(f_j))
    rank, _ = T.rank_limbs(tt, tq, n, method="binsearch", index=index)
    assert np.array_equal(rank.numpy(), np.asarray(r_j))
    R.reset_launches()
    ts = TSet(tt, n)
    for _ in range(2):
        assert np.array_equal(ts.rank(tq).numpy(), np.asarray(r_j))
    assert R.builds == {"rank_index": 1} and ts.index.answers(tt, n)
    # the candidate sweep of a k=31 table: the k-mers of a random genome
    k = 31
    genome = "".join(rng.choice(list("ACGT"), size=400))
    kmers = sorted({canonical(string_to_kmer(genome[i:i + k]), k)
                    for i in range(len(genome) - k + 1)})
    rows = np.array([[(v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF]
                     for v in kmers], np.uint32)
    m = len(rows)
    jr, jf = j_cand(jnp.asarray(rows), jnp.asarray(rows), m, k)
    tr = u32_to_torch(rows)
    R.reset_launches()
    held = R.RankIndex(tr, m)
    ranks, flips = cand_sweep(tr, m, k, chunk=64, index=held)
    assert R.builds == {"rank_index": 1}        # no chunk built its own
    assert np.array_equal(ranks.numpy(), np.asarray(jr))
    assert np.array_equal(flips.numpy(), np.asarray(jf))
    assert (ranks >= 0).sum() >= m                # neighbours are present
    R.reset_launches()

"""The port's stacked merges (ops/sortops.py: ``_run_starts``,
``_lex_lt_last``, ``bitonic_merge_pair``, ``merge_stacked_tree``,
``_dedup_compact``, ``merge_stacked_tree_capped``, ``merge_stacked``)
against the JAX package's on the shapes of tests/test_merge.py, a 4-limb
case and both overflow outcomes. Tables, counts, ``n``, capacities and the
overflow flag must be equal; inside a run of equal keys the order of the
counts may differ (the port merges with the limb-sort kernels' merge path,
JAX with a bitonic network), so ``bitonic_merge_pair`` is held to equal
keys and equal (key, count) multisets. The port runs its kernels' plain
versions on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatb_core_tpu.ops import sortops as J
from gatb_core_tpu_torch.ops import sortops as T


def _rand_tables(rng, nb, rows, w, cap, key_space=None):
    """nb sorted distinct-key tables of capacity cap (uint32 limbs, padding
    all-ones with count 0) and the global dict of key tuple -> count."""
    ks = np.full((nb, cap, w), 0xFFFFFFFF, np.uint32)
    cs = np.zeros((nb, cap), np.int32)
    truth = {}
    for i in range(nb):
        if key_space is not None:
            raw = rng.integers(0, key_space, size=rows, dtype=np.uint64)
            raw = np.stack([(raw >> np.uint64(32 * (w - 1 - j)))
                            .astype(np.uint32) for j in range(w)], axis=1)
        else:
            raw = rng.integers(0, 1 << 32, size=(rows, w), dtype=np.uint64) \
                .astype(np.uint32)
        uniq, cnt = np.unique(raw, axis=0, return_counts=True)
        ks[i, :len(uniq)] = uniq
        cs[i, :len(uniq)] = cnt
        for u, c in zip(map(tuple, uniq.tolist()), cnt.tolist()):
            truth[u] = truth.get(u, 0) + c
    return ks, cs, truth


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _u32(x):
    return x.numpy().view(np.uint32)


def _same_table(jt, tt):
    assert tt.kmers.shape == tuple(jt.kmers.shape)
    assert np.array_equal(_u32(tt.kmers), np.asarray(jt.kmers))
    assert np.array_equal(tt.counts.numpy(), np.asarray(jt.counts))
    assert int(tt.n) == int(jt.n)


def _as_dict(t):
    n = int(t.n)
    return dict(zip(map(tuple, _u32(t.kmers)[:n].tolist()),
                    t.counts[:n].tolist()))


SHAPES = [(1, 1), (2, 1), (5, 2), (8, 2), (13, 1), (6, 4)]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda p: f"nb{p[0]}w{p[1]}")
def tables(request):
    nb, w = request.param
    rng = np.random.default_rng(nb * 10 + w)
    key_space = 700 if w == 1 else (None if w == 4 else 1 << 40)
    return _rand_tables(rng, nb, 300, w, 512, key_space)


def test_merge_stacked_tree(tables):
    ks, cs, truth = tables
    tt = T.merge_stacked_tree(_t(ks), _t(cs))
    _same_table(J.merge_stacked_tree(jnp.asarray(ks), jnp.asarray(cs)), tt)
    assert _as_dict(tt) == truth


def test_merge_stacked_tree_capped(tables):
    ks, cs, truth = tables
    jt, jov = J.merge_stacked_tree_capped(jnp.asarray(ks), jnp.asarray(cs),
                                          cap=8192)
    tt, tov = T.merge_stacked_tree_capped(_t(ks), _t(cs), cap=8192)
    _same_table(jt, tt)
    assert bool(tov) is bool(jov) is False
    assert _as_dict(tt) == truth


@pytest.mark.parametrize("spare_bits", [False, True])
def test_merge_stacked(tables, spare_bits):
    ks, cs, truth = tables
    tt = T.merge_stacked(_t(ks), _t(cs), spare_bits=spare_bits)
    _same_table(J.merge_stacked(jnp.asarray(ks), jnp.asarray(cs),
                                spare_bits=spare_bits), tt)
    assert _as_dict(tt) == truth


@pytest.mark.parametrize("nb,w,rows,cap", [(4, 1, 300, 256), (3, 2, 200, 128),
                                           (5, 4, 300, 1024),
                                           (1, 2, 300, 128)])
def test_capped_overflow_both_ways(nb, w, rows, cap):
    """Below the distinct count the flag is set (and the table the JAX
    function keeps is kept); at the distinct count rounded up it is not."""
    rng = np.random.default_rng(cap + w)
    ks, cs, truth = _rand_tables(rng, nb, rows, w, 512, 1 << 30 if w == 1
                                 else None)
    for c, expect in ((cap, True), (T._next_pow2(len(truth)), False)):
        jt, jov = J.merge_stacked_tree_capped(jnp.asarray(ks),
                                              jnp.asarray(cs), cap=c)
        tt, tov = T.merge_stacked_tree_capped(_t(ks), _t(cs), cap=c)
        assert bool(jov) is bool(tov) is expect
        _same_table(jt, tt)


@pytest.mark.parametrize("nb,w,rows,capacity,cap", [
    (4, 2, 0, 16, 0), (4, 2, 0, 16, 1), (4, 2, 3, 16, 1), (8, 1, 5, 8, 1),
    (2, 1, 5, 8, 1), (4, 1, 5, 8, 3)])
def test_capped_small_cap(nb, w, rows, capacity, cap):
    """Caps of 0 to 3 rows, where one pair's compacted table is a strided
    view: ``n``, the overflow flag and the live rows equal JAX's."""
    rng = np.random.default_rng(nb * 100 + rows * 10 + cap)
    ks, cs, _ = _rand_tables(rng, nb, rows, w, capacity,
                             1 << 30 if w == 1 else None)
    jt, jov = J.merge_stacked_tree_capped(jnp.asarray(ks), jnp.asarray(cs),
                                          cap=cap)
    tt, tov = T.merge_stacked_tree_capped(_t(ks), _t(cs), cap=cap)
    n = int(jt.n)
    assert int(tt.n) == n
    assert bool(tov) is bool(jov)
    assert np.array_equal(_u32(tt.kmers)[:n], np.asarray(jt.kmers)[:n])
    assert np.array_equal(tt.counts[:n].numpy(), np.asarray(jt.counts)[:n])


@pytest.mark.parametrize("c_len,w", [(64, 1), (64, 2), (32, 3)])
def test_bitonic_merge_pair_and_dedup(c_len, w):
    """Keys equal to the JAX network's; counts equal as (key, count)
    multisets; the dedup of the merged pair equal to JAX's."""
    rng = np.random.default_rng(c_len + w)
    ks, cs, _ = _rand_tables(rng, 2, 2 * c_len // 3, w, c_len,
                             2 * c_len if w == 1 else 1 << 36)
    jk, jc = J.bitonic_merge_pair(*(jnp.asarray(x) for x in
                                    (ks[0], cs[0], ks[1], cs[1])))
    tk, tc = T.bitonic_merge_pair(_t(ks[0]), _t(cs[0]), _t(ks[1]),
                                  _t(cs[1]))
    assert np.array_equal(_u32(tk), np.asarray(jk))
    key = lambda k, c: sorted(zip(map(tuple, k.tolist()), c.tolist()))
    assert key(_u32(tk), tc.numpy()) == key(np.asarray(jk), np.asarray(jc))
    for cap_out in (2 * c_len, c_len // 2):
        out_j = J._dedup_compact(jk, jc, cap_out)
        out_t = T._dedup_compact(tk, tc, cap_out)
        assert np.array_equal(_u32(out_t[0]), np.asarray(out_j[0]))
        assert np.array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
        assert int(out_t[2]) == int(out_j[2])
        assert bool(out_t[3]) is bool(out_j[3])
    # a length that is no power of two (the JAX network needs one): the
    # port pads and cuts; the keys are numpy's merge of the two tables
    cut = c_len - 7
    tk, tc = T.bitonic_merge_pair(_t(ks[0][:cut]), _t(cs[0][:cut]),
                                  _t(ks[1][:cut]), _t(cs[1][:cut]))
    both = np.concatenate([ks[0][:cut], ks[1][:cut]])
    assert np.array_equal(_u32(tk), both[np.lexsort(both.T[::-1])])


def test_run_starts_and_lex_lt_last():
    rng = np.random.default_rng(4)
    k = np.sort(rng.integers(0, 3, (200, 2), dtype=np.uint32)
                | np.uint32(0x80000000), axis=0)
    k = k[np.lexsort(k.T[::-1])]
    inv = np.zeros(200, bool)
    inv[180:] = True
    assert np.array_equal(
        T._run_starts(_t(k), torch.from_numpy(inv)).numpy(),
        np.asarray(J._run_starts(jnp.asarray(k), jnp.asarray(inv))))
    a = rng.integers(0, 3, (300, 3), dtype=np.uint32) * np.uint32(0x7FFFFFFF)
    b = rng.integers(0, 3, (300, 3), dtype=np.uint32) * np.uint32(0x7FFFFFFF)
    want = np.asarray(J._lex_lt_last(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(T._lex_lt_last(_t(a), _t(b)).numpy(), want)
    assert np.array_equal(
        T._lex_lt_last(_t(a).long() & 0xFFFFFFFF,
                       _t(b).long() & 0xFFFFFFFF).numpy(), want)


def test_from_count_batch():
    """Per-batch count tables of the port's count_batch through the three
    merges equal the JAX package's and the dict count."""
    rng = np.random.default_rng(3)
    nb, rows = 6, 256
    batches = rng.integers(0, 1 << 35, size=(nb, rows), dtype=np.uint64)
    valid = rng.random((nb, rows)) < 0.9
    ks, cs, truth = [], [], {}
    for i in range(nb):
        km = np.stack([(batches[i] >> np.uint64(32)).astype(np.uint32),
                       batches[i].astype(np.uint32)], axis=-1)
        t = T.count_batch(_t(km), torch.from_numpy(valid[i]),
                          spare_bits=True)
        ks.append(_u32(t.kmers))
        cs.append(t.counts.numpy())
        for u, ok in zip(batches[i].tolist(), valid[i].tolist()):
            if ok:
                key = (u >> 32, u & 0xFFFFFFFF)
                truth[key] = truth.get(key, 0) + 1
    ks, cs = np.stack(ks), np.stack(cs)
    jt, jov = J.merge_stacked_tree_capped(jnp.asarray(ks), jnp.asarray(cs),
                                          cap=4096)
    tt, tov = T.merge_stacked_tree_capped(_t(ks), _t(cs), cap=4096)
    assert not bool(tov) and not bool(jov)
    _same_table(jt, tt)
    assert _as_dict(tt) == truth
    _same_table(J.merge_stacked_tree(jnp.asarray(ks), jnp.asarray(cs),
                                     spare_bits=True),
                T.merge_stacked_tree(_t(ks), _t(cs), spare_bits=True))

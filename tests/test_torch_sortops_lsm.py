"""gatb_core_tpu_torch.ops.sortops, the row-major and multibank counting
functions the LSM merge chain uses, against the JAX package on the same
numpy inputs (``use_pallas=False`` on the JAX side: ``jax.lax.sort``). On
the CPU the port sorts with the plain twins of its CUDA kernels.

The port pads every sort to a power of two, so capacities may differ from
JAX's exact-size sort: live rows, counts and ``n`` are compared, and
padding rows must be all-ones / zero. Integers: equality, no tolerance.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gatb_core_tpu.ops import sortops as js
from gatb_core_tpu_torch.convert import (count_table_to_numpy,
                                         count_table_to_torch,
                                         planes_to_numpy, planes_to_torch,
                                         table_multi_to_numpy,
                                         table_multi_to_torch, u32_to_numpy,
                                         u32_to_torch)
from gatb_core_tpu_torch.ops import sortops as ts

FULL = 0xFFFFFFFF


def _rows(n, w, seed, spare):
    """(n, w) uint32 k-mer rows with duplicates and high bits; without
    spare bits the top limb uses all 32 bits."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 3, (n, w), dtype=np.uint32)
    rows[1::4, 0] = (0xFFFFFFFE if not spare else 0x3FFFFFFF)
    valid = rng.random(n) > 0.2
    return rows, valid


def _live(table):
    kmers, counts, n = table
    assert (np.asarray(kmers)[n:] == FULL).all()
    assert (np.asarray(counts)[n:] == 0).all()
    return np.asarray(kmers)[:n], np.asarray(counts)[:n], n


def _jax_table(t):
    return np.asarray(t.kmers), np.asarray(t.counts), int(t.n)


@pytest.mark.parametrize("spare", [True, False], ids=["spare", "nospare"])
@pytest.mark.parametrize("n,w", [(300, 2), (1024, 4)])
def test_count_batch_matches_jax(n, w, spare):
    rows, valid = _rows(n, w, seed=n + w, spare=spare)
    jt = js.count_batch(jnp.asarray(rows), jnp.asarray(valid),
                        spare_bits=spare, use_pallas=False)
    tt = ts.count_batch(u32_to_torch(rows), torch.from_numpy(valid),
                        spare_bits=spare)
    for a, b in zip(_live(count_table_to_numpy(tt)), _live(_jax_table(jt))):
        assert np.array_equal(a, b)
    # zero-extended int64 limbs (what extraction returns) count the same
    t64 = ts.count_batch(torch.from_numpy(rows.astype(np.int64)),
                         torch.from_numpy(valid), spare_bits=spare)
    assert np.array_equal(u32_to_numpy(t64.kmers), u32_to_numpy(tt.kmers))


@pytest.mark.parametrize("weighted", [False, True])
def test_count_sorted_matches_jax(weighted):
    rows, valid = _rows(512, 2, seed=7, spare=True)
    order = np.lexsort((rows[:, 1], rows[:, 0], ~valid))
    sk, inv = rows[order], ~valid[order]
    wts = np.random.default_rng(8).integers(1, 9, 512).astype(np.int32) \
        if weighted else None
    jt = js.count_sorted(jnp.asarray(sk), jnp.asarray(inv),
                         None if wts is None else jnp.asarray(wts))
    tt = ts.count_sorted(u32_to_torch(sk), torch.from_numpy(inv),
                         None if wts is None else torch.from_numpy(wts))
    got, exp = count_table_to_numpy(tt), _jax_table(jt)
    assert tt.capacity == jt.capacity and tt.width == jt.width
    for a, b in zip(got, exp):           # same capacity: whole tables
        assert np.array_equal(a, b)


@pytest.mark.parametrize("spare", [True, False], ids=["spare", "nospare"])
def test_pallas_sort_rows_and_sort_by_kmer_match_jax(spare):
    n, w = 300, 2
    rows, valid = _rows(n, w, seed=21, spare=spare)
    inv = ~valid
    if spare:
        rows = np.where(inv[:, None], np.uint32(FULL), rows)
    pay = np.random.default_rng(22).integers(1, 50, n).astype(np.int32)
    got = ts.pallas_sort_rows(u32_to_torch(rows), torch.from_numpy(inv),
                              spare, torch.from_numpy(pay))
    assert got[0].shape == (512, w)             # padded to a power of two
    # JAX reference: lax.sort with the payload as the last key
    keys = ([] if spare else [inv.astype(np.uint32)]) \
        + [rows[:, j] for j in range(w)] + [pay.astype(np.uint32)]
    order = np.lexsort(tuple(reversed(keys)))
    assert np.array_equal(u32_to_numpy(got[0])[:n], rows[order])
    assert (u32_to_numpy(got[0])[n:] == FULL).all()
    # with spare bits the invalid rows are all-ones like the padding, and
    # the zero-payload padding sorts among them: only valid rows compare
    m = int(valid.sum()) if spare else n
    assert np.array_equal(got[2].numpy()[:m], pay[order][:m])
    if spare:
        assert got[1] is None
    else:
        assert np.array_equal(got[1].numpy()[:n], inv[order])
        jk, ji, jp = js.sort_by_kmer(jnp.asarray(rows), jnp.asarray(inv),
                                     jnp.asarray(pay))
        tk, ti, tp = ts.sort_by_kmer(u32_to_torch(rows),
                                     torch.from_numpy(inv),
                                     torch.from_numpy(pay))
        assert np.array_equal(u32_to_numpy(tk), np.asarray(jk))
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        # payloads ride as keys here and stably in JAX: equal as multisets
        # within each equal-kmer run, so compare run sums
        rid = np.cumsum(np.r_[True, (np.asarray(jk)[1:]
                                     != np.asarray(jk)[:-1]).any(axis=1)])
        assert np.array_equal(np.bincount(rid, tp.numpy()),
                              np.bincount(rid, np.asarray(jp)))


def _table(n_rows, cap, w, seed):
    """A sorted distinct table at capacity ``cap`` as JAX-layout numpy."""
    rng = np.random.default_rng(seed)
    rows = np.unique(rng.integers(0, 40, (n_rows, w)).astype(np.uint32),
                     axis=0)
    rows[-1, 0] = 0xF0000000
    n = len(rows)
    kmers = np.full((cap, w), FULL, np.uint32)
    kmers[:n] = rows
    counts = np.zeros(cap, np.int32)
    counts[:n] = rng.integers(1, 300, n)
    return kmers, counts, n


def test_merge_tables_matches_jax():
    a, b = _table(150, 256, 2, seed=1), _table(100, 128, 2, seed=2)
    jt = js.merge_tables(js.CountTable(*map(jnp.asarray, a)),
                         js.CountTable(*map(jnp.asarray, b)))
    tt = ts.merge_tables(count_table_to_torch(*a), count_table_to_torch(*b))
    assert tt.capacity == jt.capacity == 384
    for x, y in zip(count_table_to_numpy(tt), _jax_table(jt)):
        assert np.array_equal(x, y)
    # and back through convert: the JAX package accepts the port's table
    back = js.CountTable(*map(jnp.asarray, count_table_to_numpy(tt)))
    assert int(back.n) == int(jt.n)


def _multi_table(n_rows, cap, w, nb, seed):
    kmers, _, n = _table(n_rows, cap, w, seed)
    rng = np.random.default_rng(seed + 100)
    cols = []
    for _ in range(nb):
        c = np.zeros(cap, np.int32)
        c[:n] = rng.integers(0, 5, n)
        cols.append(c)
    cols[0][:n] = np.maximum(cols[0][:n], 1)     # a live row counts >= 1
    return tuple(kmers[:, j].copy() for j in range(w)), tuple(cols), n


@pytest.mark.parametrize("w,nb", [(2, 2), (4, 3)])
def test_merge_tables_planes_multi_matches_jax(w, nb):
    a = _multi_table(150, 256, w, nb, seed=3)
    b = _multi_table(90, 128, w, nb, seed=4)
    jp, jc, jn, jo = js.merge_tables_planes_multi(
        tuple(map(jnp.asarray, a[0])), tuple(map(jnp.asarray, a[1])),
        jnp.int32(a[2]), tuple(map(jnp.asarray, b[0])),
        tuple(map(jnp.asarray, b[1])), jnp.int32(b[2]), cap_out=512,
        use_pallas=False)
    ta, tb = table_multi_to_torch(*a), table_multi_to_torch(*b)
    tp, tcnt, tn, to = ts.merge_tables_planes_multi(*ta, *tb, cap_out=512)
    gp, gc, gn = table_multi_to_numpy(tp, tcnt, tn)
    assert gn == int(jn) and bool(to) == bool(jo)
    for x, y in zip(gp + gc, tuple(jp) + tuple(jc)):
        assert np.array_equal(x, np.asarray(y))


@pytest.mark.parametrize("spare", [True, False], ids=["spare", "nospare"])
@pytest.mark.parametrize("cap_out", [None, 8])
def test_count_planes_multibank_matches_jax(spare, cap_out):
    n, w, nb = 1024, 2, 3
    rows, valid = _rows(n, w, seed=31, spare=spare)
    banks = np.random.default_rng(32).integers(0, nb, n).astype(np.uint32)
    planes = tuple(rows[:, j].copy() for j in range(w))
    jp, jc, jn, jo = js.count_planes_multibank(
        tuple(map(jnp.asarray, planes)), jnp.asarray(valid),
        jnp.asarray(banks), nb, spare_bits=spare, cap_out=cap_out,
        use_pallas=False)
    tp, tcnt, tn, to = ts.count_planes_multibank(
        planes_to_torch(planes), torch.from_numpy(valid),
        torch.from_numpy(banks.astype(np.int32)), nb, spare_bits=spare,
        cap_out=cap_out)
    gp, gc, gn = table_multi_to_numpy(tp, tcnt, tn)
    assert gn == int(jn) and bool(to) == bool(jo)
    assert bool(to) == (cap_out is not None)     # 8 rows overflow
    for x, y in zip(gp + gc, tuple(jp) + tuple(jc)):
        assert np.array_equal(x, np.asarray(y))


def test_count_sorted_planes_multi_sums_to_single():
    """The per-bank columns add up to the single-weight reduce."""
    rows, valid = _rows(512, 2, seed=41, spare=True)
    order = np.lexsort((rows[:, 1], rows[:, 0], ~valid))
    planes = planes_to_torch(tuple(rows[order][:, j] for j in range(2)))
    inv = torch.from_numpy(~valid[order])
    wts = torch.from_numpy(np.random.default_rng(42).integers(
        0, 4, (3, 512)).astype(np.int32))
    p1, c1, n1, _ = ts.count_sorted_planes(planes, inv, weights=wts.sum(0))
    pm, cm, nm, _ = ts.count_sorted_planes_multi(planes, inv, wts)
    assert int(n1) == int(nm) and torch.equal(p1, pm)
    assert torch.equal(cm.sum(0), c1)
    assert all(np.array_equal(a, b) for a, b in
               zip(planes_to_numpy(p1), planes_to_numpy(pm)))

"""gatb_core_tpu_torch.collections.boophf and boophf_ref against the JAX
package's modules on the same seeded keys: the level hash, every array of
the build, the rank of present and absent keys, the reference stream's
bytes; integers and bytes, tolerance 0. The port runs on the CPU (the
fallback search through ``rank_rows``' plain version)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gatb_core_tpu.collections import boophf as jb
from gatb_core_tpu.collections import boophf_ref as jref
from gatb_core_tpu_torch.collections import boophf as tb
from gatb_core_tpu_torch.collections import boophf_ref as tref
from gatb_core_tpu_torch.convert import (boophf_to_numpy, boophf_to_torch,
                                         u32_to_torch)

FIELDS = ("bits", "prefix", "perm", "fallback_keys", "fallback_ranks")


def _keys(n, w, seed):
    """n sorted distinct (n, w) uint32 rows over the full range."""
    rng = np.random.default_rng(seed)
    rows = np.unique(rng.integers(0, 2**32, size=(n + n // 8 + 4, w),
                                  dtype=np.uint64).astype(np.uint32), axis=0)
    return rows[np.sort(rng.choice(len(rows), n, replace=False))]


@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_level_hash_matches_jax(w):
    rng = np.random.default_rng(w)
    limbs = rng.integers(0, 2**32, size=(3000, w), dtype=np.uint64) \
        .astype(np.uint32)
    limbs[0] = 0
    limbs[1] = 0xFFFFFFFF
    for seed, size in ((jb.LEVEL_SEEDS[0], 9024), (jb.LEVEL_SEEDS[3], 64),
                       (jb.LEVEL_SEEDS[4], 4_294_967_232)):
        want = np.asarray(jb._level_hash_jit(jnp.asarray(limbs), seed, size))
        got = tb._level_hash(u32_to_torch(limbs), seed, size)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_popcount32():
    x = np.random.default_rng(0).integers(0, 2**32, 5000, dtype=np.uint64)
    x[:3] = (0, 0xFFFFFFFF, 0x80000000)
    got = tb._popcount32(u32_to_torch(x.astype(np.uint32))).numpy()
    assert got.tolist() == [bin(int(v)).count("1") for v in x]


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("n", [0, 1, 1000, 5003])
def test_build_and_rank_match_jax(n, w):
    keys = _keys(n, w, seed=n * 10 + w)
    pad = np.full((7, w), 0xFFFFFFFF, np.uint32)
    table = np.concatenate([keys, pad])
    j = jb.BooPHF.build(jnp.asarray(table), n)
    t = tb.BooPHF.build(u32_to_torch(table), n)
    got = boophf_to_numpy(t)
    assert got["sizes"] == tuple(j.sizes) and got["offsets"] == tuple(
        j.offsets) and got["n"] == j.n == n
    for f in FIELDS:
        want = np.asarray(getattr(j, f))
        assert got[f].dtype == want.dtype, f
        assert got[f].shape == want.shape and np.array_equal(got[f], want), f
    if n:
        assert sorted(got["perm"].tolist()) == list(range(n))
    # present keys rank to their row; absent ones alias as in JAX
    absent = keys.copy() if n else _keys(50, w, seed=1)
    if n:
        absent[:, -1] ^= 0x5A5A
    for q in (keys, absent):
        want = np.asarray(j.rank(jnp.asarray(q)))
        rk = t.rank(u32_to_torch(q))
        assert rk.dtype == torch.int32
        assert np.array_equal(rk.numpy(), want)
    assert np.array_equal(t.rank(u32_to_torch(keys)).numpy(), np.arange(n))
    if n:
        # the recheck against the table sends every absent key to -1
        rk = t.rank(u32_to_torch(absent)).numpy()
        safe = np.maximum(rk, 0)
        ok = (rk >= 0) & (keys[safe] == absent).all(axis=1)
        assert not ok.any()


def test_fallback_goes_through_rank_rows(monkeypatch):
    """A table whose levels place few keys: the fallback search answers,
    and it is ``rank_rows``."""
    from gatb_core_tpu_torch.ops import rank_search

    keys = _keys(3000, 2, seed=4)
    j = jb.BooPHF.build(jnp.asarray(keys), 3000, levels=1, gamma=1.0)
    t = tb.BooPHF.build(u32_to_torch(keys), 3000, levels=1, gamma=1.0)
    assert len(t.fallback_keys) > 500
    for f in FIELDS:
        assert np.array_equal(boophf_to_numpy(t)[f],
                              np.asarray(getattr(j, f))), f
    calls = []
    real = rank_search.rank_rows
    monkeypatch.setattr(rank_search, "rank_rows",
                        lambda *a: calls.append(1) or real(*a))
    assert np.array_equal(t.rank(u32_to_torch(keys)).numpy(),
                          np.arange(3000))
    assert calls == [1]


def test_boophf_to_torch_queries_match_jax():
    keys = _keys(4000, 4, seed=9)
    j = jb.BooPHF.build(jnp.asarray(keys), 4000)
    t = boophf_to_torch(j)
    q = np.concatenate([keys[::3], _keys(500, 4, seed=10)])
    assert np.array_equal(t.rank(u32_to_torch(q)).numpy(),
                          np.asarray(j.rank(jnp.asarray(q))))
    for f in FIELDS:
        assert np.array_equal(boophf_to_numpy(t)[f],
                              np.asarray(getattr(j, f))), f
    empty = jb.BooPHF.build(jnp.zeros((0, 2), jnp.uint32), 0)
    assert (boophf_to_torch(empty).rank(torch.zeros((5, 2), dtype=torch.int32))
            == -1).all()


@pytest.mark.parametrize("w", [1, 2, 3])
def test_ref_stream_bytes_match_jax(w):
    """The port's RefBooPHF: build bytes equal to the JAX module's, and the
    from_bytes / lookup round trip (the cases of tests/test_boophf_ref.py
    that need no reference binary)."""
    rng = np.random.default_rng(5 + w)
    keys = np.unique(rng.integers(0, 2**63, size=(4000, w),
                                  dtype=np.uint64), axis=0)
    m = tref.RefBooPHF.build(keys)
    assert m.to_bytes() == jref.RefBooPHF.build(keys).to_bytes()
    codes = m.lookup(keys)
    assert codes.min() >= 0 and codes.max() < len(keys)
    assert len(np.unique(codes)) == len(keys)
    m2 = tref.RefBooPHF.from_bytes(m.to_bytes(), w)
    assert (m2.lookup(keys) == codes).all()
    absent = rng.integers(0, 2**63, size=(300, w), dtype=np.uint64)
    assert np.array_equal(m2.lookup(absent),
                          jref.RefBooPHF.from_bytes(m.to_bytes(),
                                                    w).lookup(absent))
    assert tref.RefBooPHF.build(keys[:0]).to_bytes() == \
        jref.RefBooPHF.build(keys[:0]).to_bytes()


def test_ref_words_and_lookup():
    """limbs_to_words64 and ref_key_words, and the codes a stream built
    from limb rows gives them: JAX's lookup through the port's stream
    bytes, a permutation of the keys, and the same on absent rows."""
    limbs = np.array([[0x12345678, 0x9ABCDEF0]], np.uint32)
    w = tref.limbs_to_words64(limbs, 21)
    assert w.shape == (1, 1) and w[0, 0] == 0x123456789ABCDEF0
    limbs = np.array([[0xAA, 0xBB, 0xCC]], np.uint32)
    w = tref.limbs_to_words64(limbs, 47)
    assert w[0, 0] == (0xBB << 32) | 0xCC and w[0, 1] == 0xAA
    for k in (15, 31, 32, 47, 63, 64):
        assert tref.ref_key_words(k) == jref.ref_key_words(k)
    keys = _keys(2000, 2, seed=3)
    keys[:, 0] &= 0x3FFFFFFF                       # k = 31 values
    keys = np.unique(keys, axis=0)
    words = tref.limbs_to_words64(keys, 31)
    assert np.array_equal(words, jref.limbs_to_words64(keys, 31))
    ref = tref.RefBooPHF.build(words)
    jref_m = jref.RefBooPHF.from_bytes(ref.to_bytes(), 1)
    q = tref.limbs_to_words64(np.concatenate([keys, keys ^ np.uint32(1)]),
                              31)
    want = jref_m.lookup(q)
    assert np.array_equal(ref.lookup(q), want)
    assert np.array_equal(np.sort(want[:len(keys)]), np.arange(len(keys)))

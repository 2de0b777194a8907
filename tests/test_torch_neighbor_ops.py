"""gatb_core_tpu_torch.ops.neighbor_ops against the JAX module: the same
canonical k-mers, made from a seed with numpy, through both; limbs
bit-equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatb_core_tpu.kmer.model import canonical, revcomp
from gatb_core_tpu.ops import neighbor_ops as J
from gatb_core_tpu.ops.kmer_ops import lex_eq as j_lex_eq, py_to_limbs
from gatb_core_tpu_torch.convert import u32_to_torch
from gatb_core_tpu_torch.ops import neighbor_ops as T
from gatb_core_tpu_torch.ops.kmer_ops import lex_eq, nb_limbs

KS = [11, 31, 32, 33, 63, 127]


def _nodes(k, n=96):
    """n canonical k-mers: random ones, homopolymers, palindromes (their
    own reverse complement) and the largest value."""
    rng = np.random.default_rng(k)
    top = 1 << (2 * k)
    vals = [int.from_bytes(rng.bytes(32), "little") % top
            for _ in range(n - 6)]
    half = [int(c) for c in rng.integers(0, 4, k // 2)]
    if k % 2 == 0:       # an even k has palindromes: s + revcomp(s)
        v = 0
        for c in half + [x ^ 2 for x in reversed(half)]:
            v = (v << 2) | c
        assert revcomp(v, k) == v
        vals.append(v)
    else:
        vals.append(1)
    vals += [0, top - 1, int("01" * k, 2), int("10" * k, 2), top // 3]
    return py_to_limbs([canonical(v, k) for v in vals], k)


def _t(a):
    return u32_to_torch(a)


def _np(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("k", KS)
def test_neighbor_candidates_match_jax(k):
    nodes = _nodes(k)
    got = T.neighbor_candidates(_t(nodes), k)
    assert got.shape == (len(nodes), 8, nb_limbs(k))
    assert got.dtype == torch.int64 and int(got.min()) >= 0
    exp = np.asarray(J.neighbor_candidates(jnp.asarray(nodes), k))
    assert np.array_equal(_np(got), exp)
    # zero-extended int64 input gives the same candidates
    again = T.neighbor_candidates(torch.from_numpy(nodes.astype(np.int64)),
                                  k)
    assert torch.equal(got, again)


@pytest.mark.parametrize("k", KS)
def test_shifts_revcomp_and_extend_match_jax(k):
    nodes = _nodes(k)
    n = len(nodes)
    codes = np.random.default_rng(k + 1).integers(0, 4, n).astype(np.uint32)
    jn, jc = jnp.asarray(nodes), jnp.asarray(codes)
    tn, tc = _t(nodes), torch.from_numpy(codes.astype(np.int64))
    assert np.array_equal(_np(T.shl2_or(tn, tc, k)),
                          np.asarray(J.shl2_or(jn, jc, k)))
    assert np.array_equal(_np(T.shr2_or_top(tn, tc, k)),
                          np.asarray(J.shr2_or_top(jn, jc, k)))
    rev = T.revcomp_limbs(torch.from_numpy(nodes.astype(np.int64)), k)
    jrev = J.revcomp_limbs(jn, k)
    assert np.array_equal(_np(rev), np.asarray(jrev))
    assert np.array_equal(_np(T.canonical_limbs(tn.long() & 0xFFFFFFFF,
                                                rev)),
                          np.asarray(J.canonical_limbs(jn, jrev)))
    f, r = T.extend_right(tn, tc, k)
    jf, jr = J.extend_right(jn, jc, k)
    assert np.array_equal(_np(f), np.asarray(jf))
    assert np.array_equal(_np(r), np.asarray(jr))
    f2, r2 = T.extend_right(tn, tc, k, nodes_rev=rev)
    assert torch.equal(f, f2) and torch.equal(r, r2)


def test_lex_eq_matches_jax():
    a = _nodes(63)
    b = a.copy()
    b[::3, -1] ^= 1
    b[1::3, 0] ^= 1
    assert np.array_equal(
        lex_eq(_t(a), _t(b)).numpy(),
        np.asarray(j_lex_eq(jnp.asarray(a), jnp.asarray(b))))

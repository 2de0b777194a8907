"""gatb_core_tpu_torch.ops.u64 (64-bit unsigned arithmetic on int64
tensors) against the JAX package's (hi, lo) uint32 pairs and against Python
integers: bit-equal (tolerance 0) over the full unsigned range."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatb_core_tpu.ops import u64 as J
from gatb_core_tpu_torch.ops import u64 as T

M64 = (1 << 64) - 1
EDGES = [0, 1, M64, M64 - 1, 1 << 32, (1 << 32) - 1, 1 << 63,
         (1 << 63) - 1, (1 << 63) + 1]


def _keys(seed, n=1 << 16):
    keys = np.random.default_rng(seed).integers(0, 1 << 64, n,
                                                dtype=np.uint64)
    keys[:len(EDGES)] = EDGES          # keys >= 2^63 among them
    return keys


def jpack(v):
    return J.U64(jnp.asarray((v >> np.uint64(32)).astype(np.uint32)),
                 jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def junpack(u):
    return ((np.asarray(u.hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(u.lo).astype(np.uint64))


def tpack(v):
    return torch.from_numpy(v.view(np.int64).copy())


def tunpack(t):
    return t.numpy().view(np.uint64)


def test_arithmetic_matches_jax_and_python():
    a, b = _keys(0, 4096), _keys(1, 4096)[::-1].copy()
    ja, jb, ta, tb = jpack(a), jpack(b), tpack(a), tpack(b)
    pairs = [
        (J.u64_add(ja, jb), T.u64_add(ta, tb), lambda x, y: (x + y) & M64),
        (J.u64_sub(ja, jb), T.u64_sub(ta, tb), lambda x, y: (x - y) & M64),
        (J.u64_mul(ja, jb), T.u64_mul(ta, tb), lambda x, y: (x * y) & M64),
        (J.u64_xor(ja, jb), T.u64_xor(ta, tb), lambda x, y: x ^ y),
        (J.u64_not(ja), T.u64_not(ta), lambda x, y: ~x & M64),
    ]
    for n in (0, 3, 13, 29, 32, 37, 51, 63):
        pairs.append((J.u64_shl(ja, n), T.u64_shl(ta, n),
                      lambda x, y, n=n: (x << n) & M64))
        pairs.append((J.u64_shr(ja, n), T.u64_shr(ta, n),
                      lambda x, y, n=n: x >> n))
    for jres, tres, py in pairs:
        got = tunpack(tres)
        assert np.array_equal(junpack(jres), got)
        assert [py(int(x), int(y)) for x, y in zip(a[:64], b[:64])] == \
            [int(v) for v in got[:64]]
    assert np.array_equal(np.asarray(J.u64_lt(ja, jb)),
                          T.u64_lt(ta, tb).numpy())
    assert np.array_equal(np.asarray(J.u64_eq(ja, ja)),
                          T.u64_eq(ta, ta).numpy())
    assert T.u64_lt(ta, tb).numpy().tolist() == (a < b).tolist()


def test_join_split_and_makers():
    v = _keys(2, 256)
    t = tpack(v)
    hi, lo = T.u64_split(t)
    assert np.array_equal(hi.numpy(), (v >> np.uint64(32)).astype(np.int64))
    assert np.array_equal(tunpack(T.u64_join(hi, lo)), v)
    # halves in int32 storage join to the same value
    assert np.array_equal(tunpack(T.u64_join(hi.to(torch.int32),
                                             lo.to(torch.int32))), v)
    assert int(tunpack(T.U64.from_int(M64 - 4, like=t))[0]) == M64 - 4
    assert T.U64.from_u32(torch.tensor([-1], dtype=torch.int32)).item() \
        == 0xFFFFFFFF
    assert T.s64(M64) == -1 and T.s64(5) == 5


@pytest.mark.parametrize("seed", [0, 0xAAAAAAAA55555555, 123456789])
def test_hash64_bit_equal(seed):
    keys = _keys(3)
    jk = jpack(keys)
    exp = junpack(J.hash64(jk, J.U64.from_int(seed, like=jk.lo)))
    assert np.array_equal(tunpack(T.hash64(tpack(keys), seed)), exp)
    # a tensor seed is the same as the int
    assert np.array_equal(tunpack(T.hash64(
        tpack(keys), T.U64.from_int(seed, like=tpack(keys)))), exp)


def test_oahash64_bit_equal():
    keys = _keys(4)
    assert np.array_equal(tunpack(T.oahash64(tpack(keys))),
                          junpack(J.oahash64(jpack(keys))))


@pytest.mark.parametrize("const", [0xDEADBEEFCAFEBABE, M64, 1, 1 << 63,
                                   (1 << 64) // 1000003])
def test_mulhi_bit_equal(const):
    keys = _keys(5, 4096)
    bh, bl = const >> 32, const & 0xFFFFFFFF
    got = tunpack(T.u64_mulhi(tpack(keys), bh, bl))
    assert np.array_equal(got, junpack(J.u64_mulhi(jpack(keys), bh, bl)))
    assert [(int(x) * const) >> 64 for x in keys[:128]] == \
        [int(v) for v in got[:128]]


@pytest.mark.parametrize("mod", [1, 2, 7, 1000003, 50_000_064,
                                 3 * 8_040_763, 1 << 30, (1 << 31) - 1,
                                 (1 << 31) + 1, (1 << 32) - 5,
                                 (1 << 32) - 1])
def test_mod_u32_bit_equal(mod):
    keys = _keys(6, 4096)
    got = T.u64_mod_u32(tpack(keys), mod).numpy()
    assert np.array_equal(got, np.asarray(J.u64_mod_u32(jpack(keys), mod)))
    assert [int(x) % mod for x in keys] == got.tolist()


def test_mod_u32_rejects_bad_modulus():
    with pytest.raises(ValueError):
        T.u64_mod_u32(tpack(_keys(7, 8)), 0)
    with pytest.raises(ValueError):
        T.u64_mod_u32(tpack(_keys(7, 8)), 1 << 32)

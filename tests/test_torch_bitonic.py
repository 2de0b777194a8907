"""gatb_core_tpu_torch ``bitonic_sort_u64`` (the port of the Pallas
``_bitonic_kernel``) on the CPU: the wrapper (sorted tiles, then merge
levels, over the plain versions, the composition the kernels take on a
card) and its plain PyTorch version against ``np.sort`` and against the
JAX ``bitonic_sort_u64`` in interpret mode on the same numpy inputs.
Unsigned 64-bit keys: equality, no tolerance. The CUDA kernels themselves
are held to the plain version on a card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gatb_core_tpu.ops.pallas_sort import bitonic_sort_u64 as jax_bitonic
from gatb_core_tpu_torch.convert import u32_to_numpy, u32_to_torch
from gatb_core_tpu_torch.ops import limb_sort as S


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(lo).astype(np.uint64)


def _pairs(n, seed, hi_bits=32):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << hi_bits, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return hi, lo


def _sort(fn, hi, lo):
    oh, ol = fn(u32_to_torch(hi), u32_to_torch(lo))
    return _u64(u32_to_numpy(oh), u32_to_numpy(ol))


@pytest.mark.parametrize("fn", [S.bitonic_sort_u64,
                                S.bitonic_sort_u64_plain],
                         ids=["wrapper", "plain"])
@pytest.mark.parametrize("n", [128, 256, 2048, 8192])
def test_bitonic_matches_npsort(fn, n):
    hi, lo = _pairs(n, seed=n)           # high bits set: unsigned order
    assert np.array_equal(_sort(fn, hi, lo), np.sort(_u64(hi, lo)))


def test_bitonic_duplicates_and_sentinels():
    n = 1024
    rng = np.random.default_rng(1)
    hi = rng.integers(0, 4, n, dtype=np.uint32)  # many duplicates
    lo = rng.integers(0, 8, n, dtype=np.uint32)
    hi[::7] = 0xFFFFFFFF  # sentinel rows
    lo[::7] = 0xFFFFFFFF
    got = _sort(S.bitonic_sort_u64, hi, lo)
    assert np.array_equal(got, np.sort(_u64(hi, lo)))
    assert (got[-len(hi[::7]):] == np.uint64(2**64 - 1)).all()


def test_bitonic_does_not_touch_its_inputs():
    hi, lo = _pairs(256, seed=3)
    th, tl = u32_to_torch(hi), u32_to_torch(lo)
    S.bitonic_sort_u64(th, tl)
    assert np.array_equal(u32_to_numpy(th), hi)
    assert np.array_equal(u32_to_numpy(tl), lo)


@pytest.mark.parametrize("n,msg", [(300, "power of two"),
                                   (64, "multiple of 128")])
def test_bitonic_rejects_bad_sizes(n, msg):
    z = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError, match=msg):
        S.bitonic_sort_u64(z, z)


def test_bitonic_rejects_mismatched_planes():
    with pytest.raises(ValueError):
        S.bitonic_sort_u64(torch.zeros(256, dtype=torch.int32),
                           torch.zeros(512, dtype=torch.int32))
    with pytest.raises(TypeError):
        S.bitonic_sort_u64(torch.zeros(256, dtype=torch.int64),
                           torch.zeros(256, dtype=torch.int64))


@pytest.mark.parametrize("n", [128, 256, 2048, 8192])
def test_bitonic_matches_jax_interpret(n):
    """The wrapper at its own tile (one tile here) and at tiles small
    enough that two and more merge levels run, against the JAX kernel in
    interpret mode, the plain version and ``np.sort``."""
    hi, lo = _pairs(n, seed=11 + n, hi_bits=2)   # duplicates in hi
    hi[::5] = 0xFFFFFFFF
    lo[::5] = 0xFFFFFFFF
    jh, jl = jax_bitonic(jnp.asarray(hi), jnp.asarray(lo), interpret=True)
    assert np.array_equal(_u64(jh, jl), np.sort(_u64(hi, lo)))
    ph, pl = S.bitonic_sort_u64_plain(u32_to_torch(hi), u32_to_torch(lo))
    for tile_log2 in (None, n.bit_length() - 3, 4, 1):
        th, tl = S.bitonic_sort_u64(u32_to_torch(hi), u32_to_torch(lo),
                                    tile_log2=tile_log2)
        assert np.array_equal(u32_to_numpy(th), np.asarray(jh)), tile_log2
        assert np.array_equal(u32_to_numpy(tl), np.asarray(jl)), tile_log2
        assert torch.equal(th, ph) and torch.equal(tl, pl)


@pytest.mark.parametrize("tile_log2", [None, 5, 2])
@pytest.mark.parametrize("kind", ["random", "sorted", "reversed", "equal"])
def test_bitonic_composition_kinds_and_inputs_untouched(tile_log2, kind):
    n = 1024
    hi, lo = _pairs(n, seed=7, hi_bits=3)
    if kind == "equal":
        hi[:], lo[:] = 0x80000000, 5
    elif kind != "random":
        order = np.argsort(_u64(hi, lo))
        order = order[::-1] if kind == "reversed" else order
        hi, lo = hi[order], lo[order]
    th, tl = u32_to_torch(hi), u32_to_torch(lo)
    oh, ol = S.bitonic_sort_u64(th, tl, tile_log2=tile_log2)
    assert np.array_equal(_u64(u32_to_numpy(oh), u32_to_numpy(ol)),
                          np.sort(_u64(hi, lo)))
    assert np.array_equal(u32_to_numpy(th), hi)      # inputs untouched
    assert np.array_equal(u32_to_numpy(tl), lo)
    assert oh.data_ptr() != th.data_ptr() and ol.data_ptr() != tl.data_ptr()


def test_bitonic_launch_counter_counts_only_kernel_launches():
    before = S.launches["bitonic_u64"]
    hi, lo = _pairs(256, seed=5)
    S.bitonic_sort_u64(u32_to_torch(hi), u32_to_torch(lo))
    S.bitonic_sort_u64(u32_to_torch(hi), u32_to_torch(lo), tile_log2=5)
    assert S.launches["bitonic_u64"] == before     # CPU tensor: plain twin

"""The count's extraction and distinct reduce against the JAX package.

``ops/kmer_ops.extract_planes`` (the ``extract_planes`` kernel on a card,
``extract_planes_plain`` here) against the JAX ``extract_kmers_packed``,
the pass filter and ``sortops._encode_invalid`` on the same packed reads;
``ops/sortops.count_sorted_planes[_multi]`` (the ``run_reduce`` kernel on a
card, the plain versions here) against the JAX functions on the same sorted
planes; and a superbatch of unpacked reads (``packed=False``: packed on the
device before the extraction) through the LSM step against JAX's. Each
case is one the kernels must get right: k at and off the limb boundaries,
dense and masked validity, every pass of three, reads shorter than k,
padded lengths off a multiple of 16; 1 to 9 planes, one and three weight
rows, capacities below the run count, no valid row, runs across the
kernel's 4096-row blocks. Outputs are integers: equality, no tolerance.
The kernels themselves are held to these plain versions by the
``cuda``-marked tests of tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gatb_core_tpu.kmer import counting as jc
from gatb_core_tpu.ops import kmer_ops as jk
from gatb_core_tpu.ops import sortops as js
from gatb_core_tpu.ops.bitpack import pack_batch_np
from gatb_core_tpu_torch.convert import (planes_to_numpy, planes_to_torch,
                                         u32_to_torch)
from gatb_core_tpu_torch.kmer import counting as tc
from gatb_core_tpu_torch.ops import kmer_ops as tk
from gatb_core_tpu_torch.ops import sortops as ts


def _reads(n_reads, L, k, seed, with_n):
    """Reads of a small genome (so windows repeat, also as reverse
    complements), lengths from under k to L, scattered N bases."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    starts = rng.integers(0, 600 - L, n_reads)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    codes[::4] = codes[::4, ::-1] ^ 2        # reverse complements
    lengths = rng.integers(L - 40, L + 1, n_reads).astype(np.int32)
    lengths[0] = L
    lengths[1::5] = rng.integers(0, k, len(lengths[1::5]))   # shorter than k
    valid = np.arange(L)[None, :] < lengths[:, None]
    if with_n:
        valid &= rng.random((n_reads, L)) > 0.02
    return codes, valid, lengths


@pytest.mark.parametrize("mode", ["dense", "masked"])
@pytest.mark.parametrize("k,L", [(15, 150), (16, 151), (31, 150), (32, 151),
                                 (63, 151), (95, 150)])
def test_extract_planes_matches_jax(k, L, mode):
    """One and three passes (each pass in turn), m = 10."""
    codes, valid, lengths = _reads(24, L, k, seed=k + L, with_n=mode ==
                                   "masked")
    words, vmask = pack_batch_np(codes, valid)
    if mode == "dense":
        vmask = None
    jb = jk.extract_kmers_packed(
        jnp.asarray(words), None if vmask is None else jnp.asarray(vmask),
        jnp.asarray(lengths), k, L, 10, with_minimizers=True)
    kmers = np.asarray(jb.kmers).reshape(-1, jk.nb_limbs(k))
    jvalid = np.asarray(jb.valid).reshape(-1)
    minim = np.asarray(jb.minimizer).reshape(-1)
    rows = len(jvalid)
    cap = ts._next_pow2(max(rows, 256))
    for nb_passes, pass_i in ((1, 0), (3, 0), (3, 1), (3, 2)):
        keep = jvalid & ((minim % nb_passes) == pass_i)
        enc, _ = js._encode_invalid(tuple(jnp.asarray(p) for p in kmers.T),
                                    jnp.asarray(keep), True)
        planes, tkeep, n_keep, n_valid = tk.extract_planes(
            u32_to_torch(words), None if vmask is None else u32_to_torch(vmask),
            torch.from_numpy(lengths), k, L, cap, m=10, nb_passes=nb_passes,
            pass_i=pass_i)
        got = planes_to_numpy(planes)
        assert planes.shape == (jk.nb_limbs(k), cap)
        for a, b in zip(got, enc):
            assert np.array_equal(a[:rows], np.asarray(b)), (nb_passes, pass_i)
            assert (a[rows:] == 0xFFFFFFFF).all()
        assert np.array_equal(tkeep.numpy()[:rows], keep)
        assert not tkeep[rows:].any()
        assert n_keep.dtype == torch.int32 and int(n_keep) == keep.sum()
        assert n_valid.dtype == torch.int64 and int(n_valid) == jvalid.sum()
        assert 0 < keep.sum() < jvalid.sum() or nb_passes == 1
    assert tk.launches["extract_planes"] == 0          # the plain route


def _sorted_planes(P, n, n_valid, seed, hi):
    """(P, n) sorted uint32 rows with many duplicates and runs longer than
    one 4096-row block of the kernel, the last n - n_valid rows all-ones."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, hi, (n_valid, P)).astype(np.uint32)
    rows[::3, 0] |= np.uint32(0x80000000)
    if n_valid > 9000:
        rows[100:5200] = rows[100]          # one run across a block boundary
    rows = rows[np.lexsort(rows.T[::-1])]
    planes = np.full((P, n), 0xFFFFFFFF, np.uint32)
    planes[:, :n_valid] = rows.T
    return planes, np.arange(n) >= n_valid


# (P, n, n_valid, weight rows: 0 = none, 1 = (N,), 3 = multi, cap_out)
REDUCE_CASES = [
    (1, 12411, 12000, 0, None), (2, 12411, 11000, 1, None),
    (3, 8192, 8000, 0, 64), (4, 8192, 8192, 1, 1000),
    (5, 5000, 4999, 3, None), (6, 4096, 3000, 1, 100),
    (7, 9000, 8500, 3, 200), (8, 4097, 4097, 0, None),
    (9, 12411, 12000, 1, 300), (2, 4096, 0, 0, 512), (3, 4096, 0, 1, None),
    (2, 4096, 0, 3, 16), (1, 12411, 12000, 1, 7)]


@pytest.mark.parametrize("P,n,n_valid,nw,cap_out", REDUCE_CASES)
def test_count_sorted_planes_matches_jax(P, n, n_valid, nw, cap_out):
    planes, inv = _sorted_planes(P, n, n_valid, seed=P * 13 + nw + n,
                                 hi=40 if P == 1 else 3)
    rng = np.random.default_rng(n + P)
    # JAX compacts by a sort on the weight cumsum, which must not wrap
    weights = rng.integers(1, 50, (max(nw, 1), n)).astype(np.int32)
    jp = tuple(jnp.asarray(p) for p in planes)
    tp = planes_to_torch(planes)
    if nw == 3:
        jout = js.count_sorted_planes_multi(
            jp, jnp.asarray(inv), tuple(jnp.asarray(w) for w in weights),
            cap_out=cap_out)
        tout = ts.count_sorted_planes_multi(
            tp, torch.from_numpy(inv), torch.from_numpy(weights),
            cap_out=cap_out)
        jc_ = np.stack([np.asarray(c) for c in jout[1]])
    else:
        w = None if nw == 0 else weights[0]
        jout = js.count_sorted_planes(
            jp, jnp.asarray(inv), weights=None if w is None
            else jnp.asarray(w), cap_out=cap_out)
        tout = ts.count_sorted_planes(
            tp, torch.from_numpy(inv), weights=None if w is None
            else torch.from_numpy(w), cap_out=cap_out)
        jc_ = np.asarray(jout[1])
    cap = n if cap_out is None else cap_out
    assert tout[0].shape == (P, cap)
    for a, b in zip(planes_to_numpy(tout[0]), jout[0]):
        assert np.array_equal(a, np.asarray(b))
    assert np.array_equal(tout[1].numpy(), jc_)
    assert tout[2].dtype == torch.int32 and int(tout[2]) == int(jout[2])
    assert bool(tout[3]) == bool(jout[3]) == (int(jout[2]) > cap)
    assert ts.launches["run_reduce"] == 0              # the plain route


@pytest.mark.parametrize("k,nb_passes", [(31, 1), (63, 3)])
def test_unpacked_superbatch_matches_jax(k, nb_passes):
    """packed=False: the port packs the codes on the device and extracts
    as from packed words; the LSM step equals JAX's on the same codes and
    the extraction equals the packed route's."""
    G, B, L = 2, 16, 100
    codes, valid, lengths = _reads(G * B, L, k, seed=k, with_n=True)
    shape = (G, B, L)
    pass_i = nb_passes - 1
    jo = jc._superbatch_count(
        jnp.asarray(codes.reshape(shape)), jnp.asarray(valid.reshape(shape)),
        jnp.asarray(lengths.reshape(G, B)), jnp.int32(pass_i), k=k, m=10,
        nb_passes=nb_passes, spare=True, use_pallas=False, packed=False)
    to = tc._superbatch_count(
        torch.from_numpy(codes.reshape(shape)),
        torch.from_numpy(valid.reshape(shape)),
        torch.from_numpy(lengths.reshape(G, B)), pass_i, k=k, m=10,
        nb_passes=nb_passes, spare=True, packed=False)
    n = int(jo[2])
    assert int(to[2]) == n and int(to[4]) == int(jo[4])
    assert int(to[5]) == int(jo[5])
    for a, b in zip(planes_to_numpy(to[0]), jo[0]):
        assert np.array_equal(a[:n], np.asarray(b)[:n])
    assert np.array_equal(to[1].numpy()[:n], np.asarray(jo[1])[:n])
    words, vmask = pack_batch_np(codes, valid)
    kw = dict(k=k, m=10, nb_passes=nb_passes)
    a = tc._extract_superbatch(
        torch.from_numpy(codes.reshape(shape)),
        torch.from_numpy(valid.reshape(shape)),
        torch.from_numpy(lengths.reshape(G, B)), pass_i, packed=False,
        L=None, **kw)
    b = tc._extract_superbatch(
        u32_to_torch(words.reshape(G, B, -1)),
        u32_to_torch(vmask.reshape(G, B, -1)),
        torch.from_numpy(lengths.reshape(G, B)), pass_i, packed=True, L=L,
        **kw)
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)

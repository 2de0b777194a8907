"""gatb_core_tpu_torch.collections.bloom (and the torch halves of
collections/abundance) against the JAX modules: the same k-mers, made from
a seed with numpy, through both; packed words, positions and probes
bit-equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatb_core_tpu.collections import abundance as jab
from gatb_core_tpu.collections import bloom as J
from gatb_core_tpu.kmer.model import canonical
from gatb_core_tpu.ops.kmer_ops import py_to_limbs
from gatb_core_tpu.ops.u64 import U64 as JU64
from gatb_core_tpu_torch import convert
from gatb_core_tpu_torch.collections import abundance as tab
from gatb_core_tpu_torch.collections import bloom as T
from gatb_core_tpu_torch.convert import u32_to_torch

N = 400


def _kmers(k, seed=0, n=N):
    rng = np.random.default_rng(seed * 1000 + k)
    top = 1 << (2 * k)
    vals = sorted({canonical(int.from_bytes(rng.bytes(32), "little") % top,
                             k) for _ in range(n + 50)})[:n]
    return py_to_limbs(vals, k)


def _u64(t):
    return t.numpy().view(np.uint64)


def _junpack(u: JU64):
    return ((np.asarray(u.hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(u.lo).astype(np.uint64))


def test_seeds_and_sizing_match_jax():
    for seed in (0, 7, 1 << 40):
        assert T.bloom_seeds(seed) == J.bloom_seeds(seed)
    for n, bits in ((1000, 12.0), (0, 12.0), (999_936, 6.03437),
                    (29_999_950, 11.2265), (3, 1.0), (10**9, 30.0)):
        assert T.optimal_params(n, bits) == J.optimal_params(n, bits)
    for k in (11, 31, 32, 63, 128):
        for casc in (False, True):
            assert T.debloom_nbits_per_kmer(k, casc) == \
                J.debloom_nbits_per_kmer(k, casc)
    # rounded through float32, not a float64 value
    assert T.debloom_nbits_per_kmer(31, True) == float(np.float32(6.03437))
    with pytest.raises(ValueError):
        T.debloom_nbits_per_kmer(129, True)
    assert T.CANO2 == J.CANO2 and T.BLOCK_NBITS == J.BLOCK_NBITS
    assert [T._bloom_nwords(s, kind) for s in (1, 1000) for kind in
            ("basic", "cache", "neighbor")] == \
        [J._bloom_nwords(s, kind) for s in (1, 1000) for kind in
         ("basic", "cache", "neighbor")]


@pytest.mark.parametrize("k", [15, 24, 31, 63])
def test_chunk_hash_matches_jax(k):
    """W = 1 and 3 (k = 15, 24) pad a zero limb in front; W = 2 and 4 do
    not."""
    limbs = _kmers(k)
    for seed in (0, 0x33663366CC99CC99):
        got = T._chunk_hash(u32_to_torch(limbs), seed)
        assert np.array_equal(_u64(got),
                              _junpack(J._chunk_hash(jnp.asarray(limbs),
                                                     seed)))


@pytest.mark.parametrize("k", [31, 32])
def test_simplehash16_variant_follows_k_not_w(k):
    """k = 31 and k = 32 both have two limbs and hash differently."""
    limbs = _kmers(32)          # the same rows under both variants
    span1 = 0 < k <= 31
    for shift in (1, 5, 9):
        got = T._simplehash16(u32_to_torch(limbs), shift, span1)
        assert np.array_equal(_u64(got), _junpack(
            J._simplehash16(jnp.asarray(limbs), shift, span1)))
    a = T._simplehash16(u32_to_torch(limbs), 3, True)
    b = T._simplehash16(u32_to_torch(limbs), 3, False)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("k", [17, 31, 33, 49])
def test_neighbor_hashpart_matches_jax(k):
    """k = 17, 33, 49: the inner (k-2)-mer has one limb fewer."""
    limbs = _kmers(k)
    hp, pref = T._neighbor_hashpart(u32_to_torch(limbs), k)
    jhp, jpref = J._neighbor_hashpart(jnp.asarray(limbs), k)
    assert hp.shape[1] == (2 * (k - 2) + 31) // 32
    assert np.array_equal(hp.numpy().astype(np.uint32), np.asarray(jhp))
    assert np.array_equal(pref.numpy().astype(np.uint32), np.asarray(jpref))


@pytest.mark.parametrize("kind", ["basic", "cache", "neighbor"])
@pytest.mark.parametrize("k", [15, 31, 32, 33, 63])
def test_bloom_words_positions_and_probes_match_jax(k, kind):
    limbs = _kmers(k)
    other = _kmers(k, seed=1)
    jb = J.build_bloom(jnp.asarray(limbs), nbits_per_kmer=11.0, kind=kind,
                       kmer_size=k)
    tb = T.build_bloom(u32_to_torch(limbs), nbits_per_kmer=11.0, kind=kind,
                       kmer_size=k)
    assert (jb.size_bits, jb.n_hash, jb.user_seed, jb.kind, jb.kmer_size) \
        == (tb.size_bits, tb.n_hash, tb.user_seed, tb.kind, tb.kmer_size)
    assert tb.words.dtype == torch.int32
    words = tb.to_numpy()
    assert words.dtype == np.uint32 and (words >> 31).any()
    assert np.array_equal(words, np.asarray(jb.words))
    pos = T._bloom_positions(u32_to_torch(limbs), tb.size_bits, tb.n_hash,
                             0, kind, k)
    assert np.array_equal(pos.numpy().astype(np.uint32), np.asarray(
        J._bloom_positions(jnp.asarray(limbs), jb.size_bits, jb.n_hash, 0,
                           kind, k)))
    assert tb.contains(u32_to_torch(limbs)).all()
    assert np.array_equal(tb.contains(u32_to_torch(other)).numpy(),
                          np.asarray(jb.contains(jnp.asarray(other))))


def test_bloom_valid_mask_and_user_seed_match_jax():
    k = 31
    limbs = _kmers(k)
    valid = np.random.default_rng(9).random(N) < 0.6
    for kind in ("basic", "neighbor"):
        jb = J.build_bloom(jnp.asarray(limbs), jnp.asarray(valid),
                           nbits_per_kmer=9.5, user_seed=5, kind=kind,
                           kmer_size=k)
        tb = T.build_bloom(u32_to_torch(limbs), torch.from_numpy(valid),
                           nbits_per_kmer=9.5, user_seed=5, kind=kind,
                           kmer_size=k)
        assert jb.size_bits == tb.size_bits == int(
            np.float32(valid.sum()) * np.float32(9.5))
        assert np.array_equal(tb.to_numpy(), np.asarray(jb.words))
    # an invalid row leaves no bit: all rows invalid, all words zero
    none = T.build_bloom(u32_to_torch(limbs), torch.zeros(N, dtype=bool),
                         nb_items=N, kind="cache", kmer_size=k)
    assert not none.to_numpy().any()
    empty = T.build_bloom(torch.empty((0, 2), dtype=torch.int32),
                          kind="cache", kmer_size=k)
    assert empty.size_bits == 1000 and not empty.to_numpy().any()
    assert empty.contains(torch.empty((0, 2), dtype=torch.int32)).shape \
        == (0,)


def test_build_bloom_rejects_bad_kinds():
    limbs = u32_to_torch(_kmers(31))
    with pytest.raises(ValueError):
        T.build_bloom(limbs, kind="cuckoo")
    with pytest.raises(ValueError):
        T.build_bloom(limbs, kind="neighbor", kmer_size=2)
    assert T.build_bloom(limbs, kind="default", kmer_size=31).kind == "cache"


def test_bloom_no_false_negatives_and_few_false_positives():
    rng = np.random.default_rng(0)
    vals = [int(x) for x in rng.integers(0, 1 << 62, 500, dtype=np.uint64)]
    limbs = u32_to_torch(py_to_limbs(vals, 31))
    bloom = T.build_bloom(limbs, nbits_per_kmer=12.0)
    assert bloom.size_bits == 6000 and bloom.n_hash == 8
    assert bool(bloom.contains(limbs).all())
    other = [int(x) for x in rng.integers(0, 1 << 62, 2000, dtype=np.uint64)]
    assert int(bloom.contains(u32_to_torch(py_to_limbs(other, 31))).sum()) \
        < 50


def test_bloom_converts_between_the_packages():
    """A filter built in one package answers in the other."""
    k = 33
    limbs, other = _kmers(k), _kmers(k, seed=2)
    jb = J.build_bloom(jnp.asarray(limbs), kind="neighbor", kmer_size=k)
    tb = convert.bloom_to_torch(jb)
    assert np.array_equal(tb.contains(u32_to_torch(other)).numpy(),
                          np.asarray(jb.contains(jnp.asarray(other))))
    words, *rest = convert.bloom_to_numpy(
        T.build_bloom(u32_to_torch(limbs), kind="neighbor", kmer_size=k))
    back = J.BloomFilter(jnp.asarray(words), *rest)
    assert back[1:] == jb[1:]
    assert np.array_equal(np.asarray(back.contains(jnp.asarray(other))),
                          np.asarray(jb.contains(jnp.asarray(other))))


def test_abundance_torch_halves_match_jax():
    a = np.concatenate([np.arange(0, 300), [999, 12345, 49999, 50000, 50001,
                                            123456, 2**31 - 1]])
    codes = tab.discretize_j(torch.from_numpy(a))
    assert codes.dtype == torch.uint8
    assert np.array_equal(codes.numpy(),
                          np.asarray(jab.discretize_j(jnp.asarray(a))))
    assert np.array_equal(codes.numpy(), tab.discretize(a))
    back = tab.dediscretize_j(codes)
    assert back.dtype == torch.int32
    assert np.array_equal(back.numpy(), np.asarray(
        jab.dediscretize_j(jnp.asarray(codes.numpy()))))

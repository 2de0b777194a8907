"""gatb_core_tpu_torch.kmer.debloom against the JAX module on the solid
table of one small bank: Bloom words, cFP set, cascade blooms and T4
bit-equal (tolerance 0), the membership oracle equal on the whole
1-neighbourhood, and each package answering from the other's result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatb_core_tpu.collections import bloom as jbloom
from gatb_core_tpu.kmer import debloom as J
from gatb_core_tpu.ops.neighbor_ops import neighbor_candidates as j_cands
from gatb_core_tpu_torch import BankStrings, convert, count_kmers
from gatb_core_tpu_torch.convert import u32_to_torch
from gatb_core_tpu_torch.kmer import debloom as T


def _solid(k, seed=0, n=600):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=n))
    reads = [genome[i:i + 80] for i in range(0, n - 80, 13)] * 2
    res = count_kmers(BankStrings(*reads), kmer_size=k, abundance_min=1,
                      batch_reads=32, batch_len=128,
                      superbatch_rows=1 << 13, device="cpu")
    return res.solid_kmers


@pytest.fixture(scope="module", params=[21, 33])
def built(request):
    """(k, solid table, JAX result, port result), cascading, neighbor."""
    k = request.param
    solid = _solid(k)
    return (k, solid, J.build_debloom(solid, k, cascading=True),
            T.build_debloom(solid, k, cascading=True, device="cpu"))


def _same_bloom(jb, tb):
    assert (jb.size_bits, jb.n_hash, jb.user_seed, jb.kind, jb.kmer_size) \
        == (tb.size_bits, tb.n_hash, tb.user_seed, tb.kind, tb.kmer_size)
    assert np.array_equal(np.asarray(jb.words), tb.to_numpy())


def test_debloom_result_matches_jax(built):
    k, solid, jres, tres = built
    assert jres.nb_cfp == tres.nb_cfp > 0 and jres.kind == tres.kind
    assert tres.cfp.dtype == np.uint32
    assert np.array_equal(jres.cfp, tres.cfp)
    assert jres.info == tres.info
    _same_bloom(jres.bloom, tres.bloom)
    assert tres.kind == "cascading"
    for jb, tb in zip(jres.cascade.blooms, tres.cascade.blooms):
        _same_bloom(jb, tb)
    assert np.array_equal(jres.cascade.t4, tres.cascade.t4)


def test_cfp_exactness_and_oracle_matches_jax(built):
    """(bloom and not cfp) equals exact membership on the whole
    1-neighbourhood of the solid set, in both packages alike."""
    k, solid, jres, tres = built
    cands = np.asarray(j_cands(jnp.asarray(solid), k)).reshape(
        -1, solid.shape[1])
    exact = T.SortedKmerSet(u32_to_torch(solid), len(solid)).contains(
        u32_to_torch(cands)).numpy()
    got = T.BloomCfpContainer(tres).contains(cands)
    assert got.dtype == bool and np.array_equal(got, exact)
    assert np.array_equal(J.BloomCfpContainer(jres).contains(cands), got)
    assert T.BloomCfpContainer(tres).contains(solid).all()
    # one row, as (W,)
    assert T.BloomCfpContainer(tres).contains(solid[0]).tolist() == [True]
    # the cFP are Bloom hits and not solid
    assert tres.bloom.contains(u32_to_torch(tres.cfp)).all()
    assert not T.SortedKmerSet(u32_to_torch(solid), len(solid)).contains(
        u32_to_torch(tres.cfp)).any()


def test_each_package_answers_from_the_others_result(built):
    k, solid, jres, tres = built
    cands = np.asarray(j_cands(jnp.asarray(solid[:200]), k)).reshape(
        -1, solid.shape[1])
    want = T.BloomCfpContainer(tres).contains(cands)
    # JAX result -> port container
    assert np.array_equal(
        T.BloomCfpContainer(convert.debloom_to_torch(jres)).contains(cands),
        want)
    # port result -> JAX container
    f = convert.debloom_to_numpy(tres)

    def jb(fields):
        return jbloom.BloomFilter(jnp.asarray(fields[0]), *fields[1:])

    back = J.DebloomResult(
        jb(f["bloom"]), f["cfp"], f["nb_cfp"], f["info"], f["kind"],
        J.CascadeCFP([jb(b) for b in f["cascade_blooms"]], f["t4"]))
    assert np.array_equal(J.BloomCfpContainer(back).contains(cands), want)


@pytest.mark.parametrize("kind", ["basic", "cache", "neighbor"])
def test_original_debloom_every_bloom_kind_matches_jax(kind):
    k = 21
    solid = _solid(k)
    jres = J.build_debloom(solid, k, cascading=False, bloom_kind=kind)
    tres = T.build_debloom(solid, k, cascading=False, bloom_kind=kind,
                           device="cpu")
    assert tres.kind == "original" and tres.cascade is None
    assert np.array_equal(jres.cfp, tres.cfp) and jres.info == tres.info
    _same_bloom(jres.bloom, tres.bloom)
    cont = T.BloomCfpContainer(tres)
    assert cont.contains(solid).all() and not cont.contains(tres.cfp).any()


@pytest.mark.parametrize("chunk", [64, 100, 4096])
def test_cfp_set_does_not_depend_on_the_chunking(chunk):
    """Chunks that are no power of two, a short last chunk, and one that
    overflows the first capacity (user bits per k-mer so low that most
    probes hit)."""
    k = 21
    solid = _solid(k)
    whole = T.build_debloom(solid, k, cascading=True, device="cpu")
    part = T.build_debloom(solid, k, cascading=True, chunk=chunk,
                           device="cpu")
    assert np.array_equal(whole.cfp, part.cfp) and whole.info == part.info
    assert np.array_equal(whole.cascade.t4, part.cascade.t4)
    low = T.build_debloom(solid, k, bloom_nbits=1.5, chunk=600,
                          device="cpu")
    jlow = J.build_debloom(solid, k, bloom_nbits=1.5)
    assert low.nb_cfp > 600 * 8 // 16       # past the first capacity
    assert np.array_equal(low.cfp, jlow.cfp)


def test_no_cfp_falls_back_to_original():
    """A bank with no false positive: cascading falls back to original."""
    k = 21
    solid = _solid(k, seed=3, n=150)
    jres = J.build_debloom(solid, k, bloom_nbits=40.0, cascading=True)
    tres = T.build_debloom(solid, k, bloom_nbits=40.0, cascading=True,
                           device="cpu")
    assert jres.nb_cfp == tres.nb_cfp == 0
    assert tres.kind == jres.kind == "original" and tres.cascade is None
    assert tres.cfp.shape == (0, solid.shape[1]) and jres.info == tres.info
    assert T.BloomCfpContainer(tres).contains(solid).all()


def test_empty_table_and_tensor_input():
    empty = T.build_debloom(np.zeros((0, 2), np.uint32), 21, device="cpu")
    assert empty.nb_cfp == 0 and empty.bloom.size_bits == int(
        np.float32(1) * np.float32(empty.info["nbits_per_kmer"]))
    solid = _solid(21)
    a = T.build_debloom(u32_to_torch(solid), 21, device="cpu")
    b = T.build_debloom(solid, 21, device="cpu")
    assert np.array_equal(a.cfp, b.cfp)


def test_probe_flags_match_jax():
    k = 21
    solid = _solid(k)
    tres = T.build_debloom(solid, k, device="cpu")
    b = tres.bloom
    kw = dict(k=k, size_bits=b.size_bits, n_hash=b.n_hash, seed=0,
              kind=b.kind)
    hit, cands = T._debloom_probe(u32_to_torch(solid), u32_to_torch(solid),
                                  len(solid), b.words, **kw)
    jhit, jc = J._debloom_probe(jnp.asarray(solid), jnp.asarray(solid),
                                jnp.int32(len(solid)),
                                jnp.asarray(b.to_numpy()), **kw)
    assert np.array_equal(hit.numpy(), np.asarray(jhit))
    assert np.array_equal(cands.numpy().astype(np.uint32), np.asarray(jc))


def test_debloom_defaults_to_the_card():
    """No ``device`` given means the card: without one the build raises
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        T.build_debloom(_solid(21), 21)

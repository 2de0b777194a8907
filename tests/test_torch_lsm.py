"""gatb_core_tpu_torch counting, the LSM merge chain and the table fetch,
against the JAX package and the dict ground truth.

- ``_superbatch_count`` (one LSM superbatch) against the JAX one on the
  same packed reads;
- ``SortingCount`` with ``carry_accumulator=False``: tables, histogram and
  the shared ``info`` keys equal to JAX and to ``count_kmers_py``, over 1
  and 3 passes, the bank cache on and off, a budget that forces the
  re-plan, a budget that sends the fold path to the LSM chain, k=21 and
  k=63;
- the fold and the LSM drivers against each other at W 1, 2 and 4, over
  one and two passes, with the bank cache and without;
- the host fetch (``_fetch_table``) and the host chain: exact int32
  counts past 255, the empty table, a caller's processor shown every
  distinct row on either driver.

The port pads sorts to a power of two, so capacities differ from JAX's
along the way; live rows, counts and ``n`` are compared. Integers:
equality, no tolerance.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gatb_core_tpu.bank.fasta import BankStrings as JBankStrings
from gatb_core_tpu.kmer import counting as jc
from gatb_core_tpu.ops.bitpack import pack_batch_np
from gatb_core_tpu_torch import BankStrings, CountConfig, SortingCount
from gatb_core_tpu_torch.convert import (planes_to_numpy, table_to_torch,
                                         u32_to_torch)
from gatb_core_tpu_torch.kmer import counting as tc
from gatb_core_tpu_torch.kmer.count_processor import CountProcessor
from gatb_core_tpu_torch.kmer.model import count_kmers_py
from gatb_core_tpu_torch.ops.kmer_ops import kmers_to_py

INFO_KEYS = ("kmers_nb_distinct", "kmers_nb_solid", "kmers_nb_weak",
             "kmers_nb_valid", "kmers_nb_invalid", "sequences_number",
             "sequences_size", "seq_size_min", "seq_size_max",
             "seq_size_mean", "seq_size_deviation", "kmer_size",
             "abundance_min", "abundance_max", "nb_passes_effective")


def _reads(seed=5, size=3000, step=3):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=size))
    reads = [genome[i:i + 100] for i in range(0, size - 100, step)]
    reads[5] = reads[5][:40] + "N" + reads[5][41:]
    reads[9] = reads[9][:70]
    return reads


READS = _reads()
SMALL = dict(superbatch_rows=1 << 12, batch_reads=16, batch_len=128)


def _packed(seed, k, L=64, G=2, B=32):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, 3000 - L, G * B)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    lengths = rng.integers(40, L + 1, G * B).astype(np.int32)
    valid = (np.arange(L)[None, :] < lengths[:, None]) \
        & (rng.random((G * B, L)) > 0.02)
    words, vmask = pack_batch_np(codes, valid)
    return (words.reshape(G, B, -1), vmask.reshape(G, B, -1),
            lengths.reshape(G, B))


@pytest.mark.parametrize("k,nb_passes,cap_out", [
    (31, 1, 4096), (31, 3, None), (31, 1, 256), (32, 1, None),
    (63, 2, 4096)])
def test_superbatch_count_matches_jax(k, nb_passes, cap_out):
    L = 128 if k == 63 else 64
    words, vmask, lengths = _packed(k + nb_passes, k, L=L)
    spare = (2 * k) % 32 != 0
    pass_i = nb_passes - 1
    jo = jc._superbatch_count(
        jnp.asarray(words), jnp.asarray(vmask), jnp.asarray(lengths),
        jnp.int32(pass_i), k=k, m=10, nb_passes=nb_passes, spare=spare,
        use_pallas=False, cap_out=cap_out, packed=True, L=L)
    to = tc._superbatch_count(
        u32_to_torch(words), u32_to_torch(vmask),
        torch.from_numpy(lengths), pass_i, k=k, m=10, nb_passes=nb_passes,
        spare=spare, cap_out=cap_out, packed=True, L=L)
    n = int(jo[2])
    assert int(to[2]) == n
    assert bool(to[3]) == bool(jo[3]) == (cap_out == 256)
    assert int(to[4]) == int(jo[4]) and int(to[5]) == int(jo[5])
    m = min(n, cap_out or n)                 # rows kept on overflow
    for a, b in zip(planes_to_numpy(to[0]), jo[0]):
        assert np.array_equal(a[:m], np.asarray(b)[:m])
        assert (a[m:] == 0xFFFFFFFF).all()
    assert np.array_equal(to[1].numpy()[:m], np.asarray(jo[1])[:m])


@pytest.mark.parametrize("k,nb_passes", [(31, 1), (21, 2), (32, 1)])
def test_batch_count_step_matches_jax(k, nb_passes):
    """One read batch through extraction, pass filter and count_batch:
    live rows, counts and the stats scalars equal (the port's capacity is
    the padded row count)."""
    rng = np.random.default_rng(k)
    B, L = 16, 64
    genome = rng.integers(0, 4, 400).astype(np.uint8)
    starts = rng.integers(0, 400 - L, B)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    lengths = rng.integers(k - 2, L + 1, B).astype(np.int32)
    valid = (np.arange(L)[None, :] < lengths[:, None]) \
        & (rng.random((B, L)) > 0.02)
    spare = (2 * k) % 32 != 0
    pass_i = nb_passes - 1
    jo = jc._batch_count_step(
        jnp.asarray(codes), jnp.asarray(valid), jnp.asarray(lengths),
        jnp.int32(pass_i), k=k, m=8, nb_passes=nb_passes, spare=spare)
    to = tc._batch_count_step(
        torch.from_numpy(codes), torch.from_numpy(valid),
        torch.from_numpy(lengths), pass_i, k=k, m=8, nb_passes=nb_passes,
        spare=spare)
    assert int(to[2]) == int(jo[2]) and int(to[3]) == int(jo[3])
    jcounts = np.asarray(jo[1])
    n = int((jcounts > 0).sum())
    assert n > 0
    tk = to[0].numpy().view(np.uint32)
    assert np.array_equal(tk[:n], np.asarray(jo[0])[:n])
    assert (tk[n:] == 0xFFFFFFFF).all()
    assert np.array_equal(to[1].numpy()[:n], jcounts[:n])
    assert (to[1].numpy()[n:] == 0).all()


def _count(pkg, reads, processor=None, **kw):
    if pkg == "torch":
        return SortingCount(CountConfig(device="cpu", **kw),
                            processor=processor).execute(BankStrings(*reads))
    return jc.SortingCount(jc.CountConfig(**kw)).execute(
        JBankStrings(*reads))


def _same_result(a, b):
    assert np.array_equal(a.solid_kmers, b.solid_kmers)
    assert np.array_equal(a.solid_counts, b.solid_counts)
    assert np.array_equal(a.histogram.bins, b.histogram.bins)
    assert a.histogram.cutoff == b.histogram.cutoff
    for key in INFO_KEYS:
        assert a.info[key] == b.info[key], key


@pytest.mark.parametrize("k,extra", [
    (31, dict()),
    (31, dict(nb_passes=3)),
    (31, dict(nb_passes=3, bank_cache_bytes=0)),
    (21, dict(nb_passes=3, abundance_min=3)),
    (63, dict(abundance_min="auto")),
    (31, dict(packed_transfer=False)),
], ids=["1pass", "3pass-cache", "3pass-nocache", "k21-3pass", "k63-auto",
        "unpacked"])
def test_lsm_count_matches_jax_and_ground_truth(k, extra):
    kw = dict(kmer_size=k, abundance_min=1, carry_accumulator=False,
              **SMALL)
    kw.update(extra)
    t = _count("torch", READS, **kw)
    j = _count("jax", READS, **kw)
    _same_result(t, j)
    if kw["abundance_min"] != "auto":
        assert t.as_dict() == count_kmers_py(
            READS, k, abundance_min=kw["abundance_min"])


def test_lsm_replan_fires_and_stays_exact():
    """A one-byte table budget: the LSM chain blows its 1024-row floor,
    re-plans with doubled passes and still counts exactly."""
    kw = dict(kmer_size=21, abundance_min=1, carry_accumulator=False,
              table_budget_bytes=1, **SMALL)
    t = _count("torch", READS, **kw)
    j = _count("jax", READS, **kw)
    assert t.info["nb_passes_effective"] > 1
    _same_result(t, j)
    assert t.as_dict() == count_kmers_py(READS, 21)


def test_fold_path_falls_to_lsm_below_one_batch():
    """carry_accumulator=True with a budget below one read batch takes the
    LSM chain (the fold cannot hold a superbatch) instead of raising."""
    kw = dict(kmer_size=31, abundance_min=1, table_budget_bytes=1, **SMALL)
    t = _count("torch", READS, **kw)
    j = _count("jax", READS, **kw)
    _same_result(t, j)
    assert t.as_dict() == count_kmers_py(READS, 31)


def test_lsm_bank_cache_is_used_and_dropped_over_budget(monkeypatch):
    """Later passes dispatch off pass 0's staged tensors: the bank is
    parsed once with the cache and once per pass without it or when the
    budget is too small for the whole bank."""
    calls = []
    orig = tc._BatchBuilder.add

    def counting_add(self, data):
        calls.append(1)
        return orig(self, data)

    monkeypatch.setattr(tc._BatchBuilder, "add", counting_add)
    kw = dict(kmer_size=21, abundance_min=1, nb_passes=3, **SMALL)
    truth = count_kmers_py(READS, 21)
    for carry in (False, True):
        parsed = {}
        for name, cache in (("on", 2 << 30), ("off", 0), ("small", 5000)):
            calls.clear()
            r = _count("torch", READS, carry_accumulator=carry,
                       bank_cache_bytes=cache, **kw)
            assert r.as_dict() == truth
            parsed[name] = len(calls)
        assert parsed["on"] == len(READS)
        assert parsed["off"] == parsed["small"] == 3 * len(READS)


def test_merge_smallest_pair_keeps_n_on_device_until_the_bound(monkeypatch):
    """No host read of n below _SYNC_UB_ROWS; past it the bound collapses
    to the exact n."""
    def tab(lo, hi):
        vals = np.arange(lo, hi, dtype=np.uint32)
        planes = (np.zeros_like(vals), vals)
        p, c, n = table_to_torch(planes, np.ones(len(vals), np.int32),
                                 len(vals))
        return p, c, n, 256

    lst = [tab(0, 256), tab(128, 384), tab(1000, 1256)]
    tc._merge_smallest_pair(lst)
    assert [t[3] for t in lst] == [256, 512]
    assert isinstance(lst[1][2], torch.Tensor) and int(lst[1][2]) == 384
    monkeypatch.setattr(tc, "_SYNC_UB_ROWS", 512)
    tc._merge_smallest_pair(lst)
    assert lst[0][3] == 256 + 384            # refreshed: 384, not 512
    ((planes, counts, n, _),) = lst
    kmers, counts = tc._fetch_table(planes, counts, int(n), 2)
    assert len(kmers) == 640 and counts.sum() == 768
    assert (counts[128:256] == 2).all()


def test_global_merge_matches_jax():
    rng = np.random.default_rng(9)
    kmers = rng.integers(0, 30, (700, 2)).astype(np.uint32)
    kmers[::50, 0] = 0x80000001
    counts = rng.integers(1, 9, 700).astype(np.int32)
    jk, jcnt = jc._global_merge(kmers, counts, 2)
    tk, tcnt = tc._global_merge(kmers, counts, 2, device="cpu")
    assert np.array_equal(tk, jk) and np.array_equal(tcnt, jcnt)


def _big_count_table(n, cap, n_big, seed):
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.choice(1 << 20, n, replace=False)).astype(np.uint32)
    planes = [np.full(cap, 0xFFFFFFFF, np.uint32) for _ in range(2)]
    planes[0][:n] = 0x80000000
    planes[1][:n] = vals
    counts = np.zeros(cap, np.int32)
    counts[:n] = rng.integers(1, 250, n)
    if n_big:
        big = rng.choice(n, n_big, replace=False)
        counts[big] = rng.integers(255, 100000, n_big)
        counts[big[0]] = 255                     # the boundary value
    return tuple(planes), counts, n


class _Seen(CountProcessor):
    """Every (k-mer, count) row a caller's processor is shown."""

    def __init__(self):
        self.rows, self.n, self.parts = {}, 0, 0

    def process_table(self, part_id, kmers, counts, sums):
        self.parts += 1
        self.n += len(kmers)
        self.rows.update(zip(kmers_to_py(kmers), sums.tolist()))


@pytest.mark.parametrize("case,extra", [
    ("past-uint8", None), ("empty", None),
    ("fold", dict()), ("fold-2pass", dict(nb_passes=2)),
    ("lsm", dict(carry_accumulator=False)),
    ("lsm-2pass", dict(carry_accumulator=False, nb_passes=2))],
    ids=["past-uint8", "empty", "fold", "fold-2pass", "lsm", "lsm-2pass"])
def test_the_fetch_and_the_host_chain(case, extra):
    """The host fetch brings counts back exact as int32 (past 255 and at
    the boundary) and an empty table as empty arrays; on the host chain a
    caller's processor is shown every distinct row with its count, once,
    in one part a pass, and the result is the device chain's."""
    if case == "past-uint8":
        n, cap = 1500, 2048
        planes, counts, _ = _big_count_table(n, cap, 40, seed=3)
        kmers, got = tc._fetch_table(*table_to_torch(planes, counts, n)[:2],
                                     n, 2)
        assert kmers.dtype == np.uint32 and got.dtype == np.int32
        assert np.array_equal(kmers, np.stack(planes, axis=1)[:n])
        assert np.array_equal(got, counts[:n])
        assert 255 in got and (got >= 255).sum() == 40
        return
    if case == "empty":
        planes, counts, _ = _big_count_table(0, 256, 0, seed=4)
        kmers, got = tc._fetch_table(*table_to_torch(planes, counts, 0)[:2],
                                     0, 2)
        assert kmers.shape == (0, 2) and kmers.dtype == np.uint32
        assert got.shape == (0,) and got.dtype == np.int32
        seen = _Seen()
        res = _count("torch", ["ACGT" * 5], processor=seen, kmer_size=31)
        assert seen.parts == seen.n == res.nb_solid == 0
        return
    kw = dict(kmer_size=31, abundance_min=2, **SMALL, **extra)
    seen = _Seen()
    host = _count("torch", READS, processor=seen, **kw)
    dev = _count("torch", READS, **kw)
    assert seen.parts == kw.get("nb_passes", 1)
    assert seen.n == len(seen.rows) == host.info["kmers_nb_distinct"]
    assert seen.rows == count_kmers_py(READS, 31)
    _same_result(host, dev)


@pytest.mark.parametrize("k", [15, 31, 63], ids=["w1", "w2", "w4"])
@pytest.mark.parametrize("extra", [
    dict(), dict(nb_passes=2), dict(nb_passes=2, bank_cache_bytes=0)],
    ids=["1pass", "2pass-cache", "2pass-nocache"])
def test_the_fold_and_lsm_drivers_agree(k, extra):
    """The same solid k-mers, counts, histogram and info from either
    driver behind the one pass loop."""
    kw = dict(kmer_size=k, abundance_min=2, **SMALL, **extra)
    fold = _count("torch", READS, carry_accumulator=True, **kw)
    lsm = _count("torch", READS, carry_accumulator=False, **kw)
    assert fold.nb_solid > 0
    _same_result(fold, lsm)

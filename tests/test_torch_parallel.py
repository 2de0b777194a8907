"""The port's multi-rank counting (gatb_core_tpu_torch/parallel: mesh,
exchange, superbatch, dryrun) against the JAX package's sharded functions
on its 8-device virtual CPU mesh, on the inputs of tests/test_parallel.py
and tests/test_parallel_postsolid.py (same seeds), with synthetic genome
banks where those tests read the reference's reads1.fa.

The port runs on 2, 4 and 8 spawned CPU ranks over gloo (``RankPool``, one
pool per size for the module). Every rank calls the same function and must
return the same result; tables, counts, histograms, ``info``, overflow
sizes and the number of replayed superbatches must equal JAX's exactly (no
tolerance), and the tables the single-device count's.

The ranks import this module to find the rank bodies below, so it imports
nothing of JAX at the top: the JAX side runs inside the tests.
"""

import numpy as np
import pytest

from gatb_core_tpu_torch.parallel.mesh import RankPool


# ---------------------------------------------------------------------------
# rank bodies (run on every rank; numpy in, numpy out)
# ---------------------------------------------------------------------------


def _count_step(mesh, codes, valid, lengths, k, m, cf, rep_seqs=None):
    from gatb_core_tpu_torch import BankStrings
    from gatb_core_tpu_torch.kmer.repartition import build_repartitor
    from gatb_core_tpu_torch.parallel.exchange import (global_table,
                                                       make_count_step)

    rep = None
    if rep_seqs is not None:
        rep = build_repartitor(BankStrings(*rep_seqs), kmer_size=k,
                               nb_partitions=mesh.size, minimizer_size=m,
                               batch_reads=8, batch_len=128, device="cpu")
    shards = make_count_step(mesh, k, m, capacity_factor=cf,
                             repartitor=rep)(codes, valid, lengths, 0)
    gk, gc = global_table(shards, mesh.size)
    return gk, gc, shards.n_overflowed.numpy()


def _count(mesh, seqs, driver, kw, two_d=False):
    from gatb_core_tpu_torch import BankStrings
    from gatb_core_tpu_torch.parallel import exchange, superbatch
    from gatb_core_tpu_torch.parallel.mesh import make_mesh2d

    if two_d:
        mesh = make_mesh2d(2, mesh.size // 2, device="cpu")
    before = superbatch.retries["superbatch"]
    res = getattr(exchange, driver)(BankStrings(*seqs), mesh, **kw)
    return (res.solid_kmers, res.solid_counts, res.histogram.bins, res.info,
            superbatch.retries["superbatch"] - before)


def _same_on_every_rank(outs):
    for out in outs[1:]:
        assert len(out) == len(outs[0])
        for a, b in zip(outs[0], out):
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b)
            else:
                assert a == b
    return outs[0]


# ---------------------------------------------------------------------------
# inputs (tests/test_parallel.py, tests/test_parallel_postsolid.py)
# ---------------------------------------------------------------------------


def _batch(seqs, B, L):
    from gatb_core_tpu_torch.ops.bitpack import ascii_to_codes_np

    codes = np.zeros((B, L), np.uint8)
    valid = np.zeros((B, L), bool)
    lengths = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        c, v = ascii_to_codes_np(np.frombuffer(s.encode(), np.uint8))
        codes[i, :len(s)] = c
        valid[i, :len(s)] = v
        lengths[i] = len(s)
    return codes, valid, lengths


def _step_reads():
    rng = np.random.default_rng(42)
    k, L = 21, 96
    seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(k, L))))
            for _ in range(64 - 8)]
    seqs += seqs[:6]
    seqs.append("N" * 40)
    seqs.append("ACGT")
    return seqs


def _hot_reads(seed, n_hot, n_rand, size=80):
    """Many copies of one read (one hot partition) and a few random."""
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), size=size))
    return [base] * n_hot + ["".join(rng.choice(list("ACGT"), size=size))
                             for _ in range(n_rand)]


def _genome_reads(seed=11, glen=3000, n_reads=400, rlen=120):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=glen))
    return [genome[s:s + rlen]
            for s in rng.integers(0, glen - rlen, size=n_reads)]


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(n):
        if n not in made:
            made[n] = RankPool(n, device="cpu", timeout=120)
        return made[n]

    yield get
    for pool in made.values():
        pool.close()


def _jax_superbatch_replays(monkeypatch):
    """Count the JAX driver's aborted dispatches (any overflow flag)."""
    from gatb_core_tpu.parallel import superbatch as J

    seen = {"replays": 0}
    make = J.make_superbatch_step

    def counting(*a, **kw):
        fn = make(*a, **kw)

        def step(*args):
            out = fn(*args)
            w = len(args) - 7
            seen["replays"] += int(np.asarray(out[w + 2]).sum() > 0)
            return out

        return step

    monkeypatch.setattr(J, "make_superbatch_step", counting)
    return seen


def _jax_count(seqs, driver, n, kw, two_d=False):
    from gatb_core_tpu.bank.fasta import BankStrings
    from gatb_core_tpu.parallel import exchange
    from gatb_core_tpu.parallel.mesh import make_mesh, make_mesh2d

    mesh = make_mesh2d(2, n // 2) if two_d else make_mesh(n)
    return getattr(exchange, driver)(BankStrings(*seqs), mesh, **kw)


def _same_as_jax(got, jr, replays=None):
    kmers, counts, bins, info, port_replays = got
    assert np.array_equal(kmers, jr.solid_kmers)
    assert np.array_equal(counts, jr.solid_counts)
    assert counts.dtype == jr.solid_counts.dtype
    assert np.array_equal(bins, jr.histogram.bins)
    assert info == jr.info
    if replays is not None:
        assert port_replays == replays


def _single_device(seqs, **kw):
    from gatb_core_tpu_torch import BankStrings, count_kmers

    return count_kmers(BankStrings(*seqs), device="cpu", **kw)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_partition_of_minimizer_and_shard_helpers():
    """The routing hash, the range census and the table split, in one
    process: equal to JAX's."""
    import jax.numpy as jnp
    import torch

    from gatb_core_tpu.bank.fasta import BankStrings as JBank
    from gatb_core_tpu.parallel import exchange as JE
    from gatb_core_tpu.parallel import postsolid as JP
    from gatb_core_tpu.parallel import superbatch as JS
    from gatb_core_tpu_torch import BankStrings
    from gatb_core_tpu_torch.parallel import exchange as TE
    from gatb_core_tpu_torch.parallel import postsolid as TP
    from gatb_core_tpu_torch.parallel import superbatch as TS

    rng = np.random.default_rng(3)
    minim = rng.integers(0, 1 << 20, size=4096).astype(np.uint32)
    minim[:4] = [0, 1, (1 << 20) - 1, 0xFFFFF]
    for n in (2, 3, 8):
        want = np.asarray(JE.partition_of_minimizer(jnp.asarray(minim), n))
        got = TE.partition_of_minimizer(torch.from_numpy(
            minim.astype(np.int64)), n)
        assert np.array_equal(got.numpy(), want)
    seqs = _genome_reads()
    for k, n in ((21, 4), (31, 8), (63, 3)):
        want = JS.sample_range_bounds(JBank(*seqs), k, n)
        got = TS.sample_range_bounds(BankStrings(*seqs), k, n,
                                     device="cpu")
        assert got.dtype == want.dtype and np.array_equal(got, want)
    table = np.sort(rng.integers(0, 1 << 32, size=(37, 2),
                                 dtype=np.uint64).astype(np.uint32), axis=0)
    for n in (1, 2, 8, 64):
        for a, b in zip(JP.shard_table(table, n), TP.shard_table(table, n)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# JAX's shard_map in/out PartitionSpecs of the postsolid stages: the port
# passes each rank its shard instead
NO_COUNTERPART = {"_table_specs"}


@pytest.mark.parametrize("module", ["mesh", "exchange", "superbatch",
                                    "postsolid"])
def test_every_jax_parallel_function_has_a_counterpart(module):
    """Each function and class of the JAX package's parallel/<module>.py
    has one of the same name in the port's."""
    import ast
    import importlib
    import os

    import gatb_core_tpu

    path = os.path.join(os.path.dirname(gatb_core_tpu.__file__),
                        "parallel", f"{module}.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = {node.name for node in tree.body
             if isinstance(node, (ast.FunctionDef, ast.ClassDef))}
    port = importlib.import_module(f"gatb_core_tpu_torch.parallel.{module}")
    missing = sorted(n for n in names - NO_COUNTERPART
                     if not hasattr(port, n))
    assert names and not missing


@pytest.mark.parametrize("spread", [300, 200])
def test_blocked_overflow_flag_equals_jax(spread):
    """The local count's overflow flag: JAX's blocked compaction also
    sets it where one block of 4096 sorted rows holds more run ends than
    its slice (here 256 of them) though the table fits; the port's
    ``_blocked_overflow`` gives the same flag."""
    import jax.numpy as jnp
    import torch

    from gatb_core_tpu.ops.sortops import count_planes as jcount
    from gatb_core_tpu_torch.ops.sortops import count_planes as tcount
    from gatb_core_tpu_torch.parallel.superbatch import _blocked_overflow

    n_rows, cap = 1 << 16, 1024
    keys = np.full(n_rows, 0xFFFFFFFF, np.uint32)
    keys[:spread] = np.arange(spread) * 7 + 5       # one end each
    keys[spread:spread + 4096] = 1 << 30            # one long run
    valid = keys != 0xFFFFFFFF
    perm = np.random.default_rng(spread).permutation(n_rows)
    keys, valid = keys[perm], valid[perm]
    _, _, jn, jov = jcount((jnp.asarray(keys),), jnp.asarray(valid),
                           spare_bits=True, cap_out=cap, blocked=True)
    _, tc, tn, tov = tcount(torch.from_numpy(keys.view(np.int32))[None],
                            torch.from_numpy(valid), spare_bits=True,
                            cap_out=cap)
    assert int(tn) == int(jn) == spread + 1 and not bool(tov)
    flag = bool(_blocked_overflow(tc, tn, n_rows, cap))
    assert flag is bool(jov) is (spread > 256)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_count_equals_jax(pools, ndev):
    """make_count_step + global_table: the table of tests/test_parallel.py's
    batch, equal to JAX's and to the dict ground truth."""
    import jax.numpy as jnp

    from gatb_core_tpu.kmer.model import count_kmers_py
    from gatb_core_tpu.parallel.exchange import global_table, \
        make_count_step
    from gatb_core_tpu.parallel.mesh import make_mesh

    seqs = _step_reads()
    codes, valid, lengths = _batch(seqs, 64, 96)
    got = _same_on_every_rank(pools(ndev).run(
        _count_step, codes, valid, lengths, 21, 10, 2.0))
    shards = make_count_step(make_mesh(ndev), 21, 10)(
        jnp.asarray(codes), jnp.asarray(valid), jnp.asarray(lengths),
        jnp.int32(0))
    gk, gc = global_table(shards, ndev)
    assert np.array_equal(got[0], gk) and np.array_equal(got[1], gc)
    assert np.array_equal(got[2], np.asarray(shards.n_overflowed))
    from gatb_core_tpu.ops.kmer_ops import kmers_to_py

    assert dict(zip(kmers_to_py(gk), gc.tolist())) == count_kmers_py(seqs,
                                                                     21)


def test_overflow_is_exact(pools):
    """A capacity factor of 0.25 overflows the windows: the same rows per
    rank overflow as in JAX and the table stays exact."""
    import jax.numpy as jnp

    from gatb_core_tpu.parallel.exchange import global_table, \
        make_count_step
    from gatb_core_tpu.parallel.mesh import make_mesh

    seqs = _hot_reads(3, 30, 2, size=60)
    codes, valid, lengths = _batch(seqs, 32, 64)
    got = _same_on_every_rank(pools(4).run(
        _count_step, codes, valid, lengths, 15, 10, 0.25))
    shards = make_count_step(make_mesh(4), 15, 10, capacity_factor=0.25)(
        jnp.asarray(codes), jnp.asarray(valid), jnp.asarray(lengths),
        jnp.int32(0))
    assert int(got[2].sum()) > 0
    assert np.array_equal(got[2], np.asarray(shards.n_overflowed))
    gk, gc = global_table(shards, 4)
    assert np.array_equal(got[0], gk) and np.array_equal(got[1], gc)


def test_sharded_count_with_repartitor(pools):
    """The exchange routed by the greedy repartition table (each package's
    own census of the same reads)."""
    import jax.numpy as jnp

    from gatb_core_tpu.bank.fasta import BankStrings as JBank
    from gatb_core_tpu.kmer.repartition import build_repartitor
    from gatb_core_tpu.parallel.exchange import global_table, \
        make_count_step
    from gatb_core_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(21, 96))))
            for _ in range(32)]
    codes, valid, lengths = _batch(seqs, 32, 96)
    got = _same_on_every_rank(pools(4).run(
        _count_step, codes, valid, lengths, 21, 8, 2.0, seqs))
    rep = build_repartitor(JBank(*seqs), kmer_size=21, nb_partitions=4,
                           minimizer_size=8, batch_reads=8, batch_len=128)
    shards = make_count_step(make_mesh(4), 21, 8, repartitor=rep)(
        jnp.asarray(codes), jnp.asarray(valid), jnp.asarray(lengths),
        jnp.int32(0))
    gk, gc = global_table(shards, 4)
    assert np.array_equal(got[0], gk) and np.array_equal(got[1], gc)
    assert np.array_equal(got[2], np.asarray(shards.n_overflowed))


def test_hostmerge_driver(pools):
    """count_kmers_distributed_hostmerge: the pass loop over global
    batches with the repartitor, 2 passes at 4 ranks."""
    seqs = _genome_reads(seed=5, glen=1500, n_reads=120, rlen=90)
    kw = dict(kmer_size=21, abundance_min=2, nb_passes=2,
              batch_reads_per_device=8)
    got = _same_on_every_rank(pools(4).run(
        _count, seqs, "count_kmers_distributed_hostmerge", kw))
    _same_as_jax(got, _jax_count(
        seqs, "count_kmers_distributed_hostmerge", 4, kw))
    ref = _single_device(seqs, kmer_size=21, abundance_min=2)
    assert np.array_equal(got[0], ref.solid_kmers)
    assert np.array_equal(got[1], ref.solid_counts)


def test_distributed_overflow_exact(pools, monkeypatch):
    """count_kmers_distributed (the superbatch driver) with a 0.25
    capacity factor on a hot partition: exact, with JAX's replays."""
    seen = _jax_superbatch_replays(monkeypatch)
    seqs = _hot_reads(9, 40, 8)
    kw = dict(kmer_size=15, abundance_min=1, batch_reads_per_device=4,
              capacity_factor=0.25, repartitor=None)
    got = _same_on_every_rank(pools(4).run(
        _count, seqs, "count_kmers_distributed", kw))
    _same_as_jax(got, _jax_count(seqs, "count_kmers_distributed", 4, kw),
                 seen["replays"])


def test_superbatch_overflow_retry_exact(pools, monkeypatch):
    """Tiny capacity hints force overflows of the local table, the send
    window and the accumulator: the replays happen where JAX's do and the
    table stays exact."""
    seen = _jax_superbatch_replays(monkeypatch)
    seqs = _hot_reads(17, 30, 18)
    kw = dict(kmer_size=15, abundance_min=1, batch_reads_per_device=4,
              capacity_factor=0.05, distinct_ratio_hint=0.001)
    got = _same_on_every_rank(pools(4).run(
        _count, seqs, "count_kmers_distributed", kw))
    assert got[4] > 0
    _same_as_jax(got, _jax_count(seqs, "count_kmers_distributed", 4, kw),
                 seen["replays"])


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_superbatch_multi_dispatch_accumulates(pools, ndev):
    """Small superbatches: many steps per pass, the accumulator carried
    across them; equal to JAX's driver and to the single-device count."""
    seqs = _genome_reads(seed=7)
    kw = dict(kmer_size=31, abundance_min=3, batch_reads_per_device=16,
              superbatch_rows=1 << 14)
    got = _same_on_every_rank(pools(ndev).run(
        _count, seqs, "count_kmers_distributed", kw))
    _same_as_jax(got, _jax_count(seqs, "count_kmers_distributed", ndev,
                                 kw))
    ref = _single_device(seqs, kmer_size=31, abundance_min=3)
    assert np.array_equal(got[0], ref.solid_kmers)
    assert np.array_equal(got[1], ref.solid_counts)
    assert got[3]["kmers_nb_valid"] == ref.info["kmers_nb_valid"]
    assert got[3]["kmers_nb_distinct"] == ref.info["kmers_nb_distinct"]


def test_fewer_reads_than_ranks(pools):
    """5 reads over 8 ranks of 1 read a batch: most ranks count nothing
    and still take part in every exchange; equal to JAX's driver."""
    seqs = _genome_reads(seed=19, glen=400, n_reads=5, rlen=100)
    kw = dict(kmer_size=21, abundance_min=1, batch_reads_per_device=1)
    got = _same_on_every_rank(pools(8).run(
        _count, seqs, "count_kmers_distributed", kw))
    _same_as_jax(got, _jax_count(seqs, "count_kmers_distributed", 8, kw))


def test_two_passes_at_four_ranks(pools):
    """The DSK pass loop (nb_passes=2) at 4 ranks, k=63 (4 limbs)."""
    seqs = _genome_reads(seed=13, glen=2000, n_reads=200, rlen=110)
    kw = dict(kmer_size=63, abundance_min=2, nb_passes=2,
              batch_reads_per_device=8)
    got = _same_on_every_rank(pools(4).run(
        _count, seqs, "count_kmers_distributed", kw))
    _same_as_jax(got, _jax_count(seqs, "count_kmers_distributed", 4, kw))
    ref = _single_device(seqs, kmer_size=63, abundance_min=2)
    assert np.array_equal(got[0], ref.solid_kmers)
    assert np.array_equal(got[1], ref.solid_counts)


def test_2d_mesh_counting_equals_jax(pools):
    """A 2 x 2 (host, chip) mesh: the exchange over the chip axis, the
    pass-end merge over the host axis, 2 passes (the inputs of
    tests/test_parallel_postsolid.py's 2 x 4 case)."""
    from gatb_core_tpu.kmer.model import count_kmers_py
    from gatb_core_tpu.ops.kmer_ops import kmers_to_py

    rng = np.random.default_rng(23)
    genome = "".join(rng.choice(list("ACGT"), size=1500))
    reads = [genome[s:s + 90] for s in rng.integers(0, 1400, size=160)]
    reads.append("ACGTN" * 18)
    kw = dict(kmer_size=21, abundance_min=1, nb_passes=2,
              batch_reads_per_device=8, capacity_factor=0.75)
    got = _same_on_every_rank(pools(4).run(
        _count, reads, "count_kmers_distributed", kw, True))
    _same_as_jax(got, _jax_count(reads, "count_kmers_distributed", 4, kw,
                                 two_d=True))
    assert dict(zip(kmers_to_py(got[0]), got[1].tolist())) == \
        count_kmers_py(reads, 21, abundance_min=1)


def test_dryrun_multichip_two_ranks():
    """The port's dry run on 2 spawned CPU ranks: every stage equal to one
    device, and the 2-pass count replays superbatches after overflows."""
    from gatb_core_tpu_torch.parallel.dryrun import dryrun_multichip

    line, replays = dryrun_multichip(2, device="cpu")
    assert line.startswith("dryrun_multichip(2): OK")
    assert replays > 0

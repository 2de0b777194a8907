"""gatb_core_tpu_torch host modules of the counting-only dbgh5 against the
JAX package on the same numpy inputs: the abundance discretization, the
execution plan, the repartitor (census, greedy packing, frequency order,
persistence in both directions) and the HDF5 storage (word layout, byte
streams, the solid table at k > 32 read back). Integers and exact floats:
equality, no tolerance.
"""

import numpy as np
import pytest

from gatb_core_tpu.collections import abundance as jab
from gatb_core_tpu.kmer import configuration as jcfg
from gatb_core_tpu.kmer import repartition as jrep
from gatb_core_tpu.storage import hdf5 as jh5
from gatb_core_tpu_torch.collections import abundance as tab
from gatb_core_tpu_torch.kmer import configuration as tcfg
from gatb_core_tpu_torch.kmer import repartition as trep
from gatb_core_tpu_torch.storage import hdf5 as th5


def _reads(seed=4, size=1500):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=size))
    reads = [genome[i:i + 90] for i in range(0, size - 90, 6)]
    reads[3] = reads[3][:30] + "N" + reads[3][31:]
    return reads


def test_abundance_codes_match_jax():
    a = np.concatenate([np.arange(0, 300), [999, 1000, 1001, 49999, 50000,
                                            50001, 2**31 - 1]])
    assert np.array_equal(tab.discretization_breaks(),
                          jab.discretization_breaks())
    codes = tab.discretize(a)
    assert codes.dtype == np.uint8
    assert np.array_equal(codes, np.asarray(jab.discretize(a)))
    assert np.array_equal(tab.dediscretize(codes),
                          np.asarray(jab.dediscretize(codes)))
    assert tab.MAX_ABUNDANCE_DISCRETE == jab.MAX_ABUNDANCE_DISCRETE == 50000


@pytest.mark.parametrize("args,kw", [
    ((1000, 100_000, 100, 31), {}),
    ((6_000_000, 900_000_000, 150, 31), dict(max_memory_mb=2000)),
    ((50_000_000, 7_500_000_000, 150, 63),
     dict(max_memory_mb=1000, max_disk_space_mb=3000, nb_cores=8)),
    ((10, 500, 50, 21), dict(minimizer_size=8)),
])
def test_compute_plan_matches_jax(args, kw):
    t, j = tcfg.compute_plan(*args, **kw), jcfg.compute_plan(*args, **kw)
    assert t.get_properties() == j.get_properties()
    assert (t.nb_partitions_in_parallel, t.nb_cores_per_partition,
            t.nb_cached_items_per_core_per_part) == (
        j.nb_partitions_in_parallel, j.nb_cores_per_partition,
        j.nb_cached_items_per_core_per_part)
    assert tcfg.kmer_type_size(args[3]) == jcfg.kmer_type_size(args[3])


@pytest.mark.parametrize("k,m", [(21, 6), (31, 8)])
def test_repartitor_census_and_packing_match_jax(k, m):
    from gatb_core_tpu.bank.fasta import BankStrings as JBank
    from gatb_core_tpu_torch import BankStrings

    reads = _reads(seed=k)
    tc = trep.census_minimizers(BankStrings(*reads), k, m, batch_reads=32,
                                batch_len=128, device="cpu")
    jc = jrep.census_minimizers(JBank(*reads), k, m, batch_reads=32,
                                batch_len=128)
    assert tc.sum() > 0 and np.array_equal(tc, np.asarray(jc))
    for nb_parts in (1, 7):
        assert np.array_equal(trep.compute_distrib(tc, nb_parts),
                              jrep.compute_distrib(np.asarray(jc),
                                                   nb_parts))
    tr = trep.build_repartitor(BankStrings(*reads), k, 5, m, batch_reads=32,
                               batch_len=128, device="cpu")
    jr = jrep.build_repartitor(JBank(*reads), k, 5, m, batch_reads=32,
                               batch_len=128)
    assert np.array_equal(tr.table, jr.table)
    assert (tr.nb_partitions, tr.minimizer_size) == (5, m)
    mins = np.arange(0, 4 ** m, 37)
    assert np.array_equal(tr(mins), jr(mins))
    assert np.array_equal(tr.device_table("cpu").numpy(),
                          tr.table.astype(np.int32))


def test_frequency_order_matches_jax():
    from gatb_core_tpu.bank.fasta import BankStrings as JBank
    from gatb_core_tpu_torch import BankStrings

    reads = _reads(seed=8)
    tcn = trep.census_mmers(BankStrings(*reads), 6)
    jcn = jrep.census_mmers(JBank(*reads), 6)
    assert tcn.sum() > 0 and np.array_equal(tcn, np.asarray(jcn))
    assert np.array_equal(trep.freq_order_from_counts(tcn),
                          jrep.freq_order_from_counts(np.asarray(jcn)))
    assert np.array_equal(trep.build_freq_order(BankStrings(*reads), 6),
                          jrep.build_freq_order(JBank(*reads), 6))


def test_repartitor_and_plan_persist_across_packages(tmp_path):
    """Each package loads the /minimizers and plan groups the other wrote."""
    rng = np.random.default_rng(2)
    table = rng.integers(0, 9, 4 ** 5).astype(np.uint16)
    freq = rng.permutation(4 ** 5).astype(np.uint32)
    plan = tcfg.compute_plan(1000, 100_000, 100, 31)
    with th5.Storage(str(tmp_path / "port.h5"), "w") as st:
        trep.Repartitor(table, 9, 5).save(st, freq_order=freq, nb_pass=2)
        plan.save(st)
    with jh5.Storage(str(tmp_path / "jax.h5"), "w") as st:
        jrep.Repartitor(table, 9, 5).save(st, freq_order=freq, nb_pass=2)
        jcfg.compute_plan(1000, 100_000, 100, 31).save(st)
    for mod_h5, mod_rep, mod_cfg, name in (
            (th5, trep, tcfg, "jax.h5"), (jh5, jrep, jcfg, "port.h5")):
        with mod_h5.Storage(str(tmp_path / name), "r") as st:
            r = mod_rep.Repartitor.load(st)
            assert np.array_equal(r.table, table)
            assert (r.nb_partitions, r.minimizer_size) == (9, 5)
            c = mod_cfg.Configuration.load(st)
            assert (c.kmer_size, c.nb_passes, c.nb_partitions) == (
                31, plan.nb_passes, plan.nb_partitions)
            g = st.group("minimizers")
            assert np.array_equal(g.get_dataset("minimFrequency"),
                                  np.frombuffer(
                                      freq.astype("<u4").tobytes()
                                      + (0x12345678).to_bytes(4, "little"),
                                      np.uint8))


def test_storage_streams_words_and_state(tmp_path):
    rng = np.random.default_rng(6)
    for w in (2, 4, 6):
        limbs = rng.integers(0, 2**32, (50, w), dtype=np.uint64).astype(
            np.uint32)
        words = th5.limbs_to_words64(limbs)
        assert np.array_equal(words, jh5.limbs_to_words64(limbs))
        assert np.array_equal(th5.words64_to_limbs(words, w), limbs)
    assert th5.count_dtype(2) == jh5.count_dtype(2)
    payload = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    with th5.Storage(str(tmp_path / "s.h5"), "w") as st:
        g = st.group("a").group("b")
        with g.ostream("blob") as out:
            out.write(payload[:400])
            out.write(payload[400:])
        g.set_property("answer", 42)
        g.set_property("name", "x")
        st.set_state_bit(th5.STATE_SORTING_COUNT_DONE)
    for mod in (th5, jh5):
        with mod.Storage(str(tmp_path / "s.h5"), "r") as st:
            g = st.group("a").group("b")
            assert "blob" in g and "nothing" not in g
            ins = g.istream("blob")
            assert ins.read(10) == payload[:10] and ins.tell() == 10
            ins.seek(990)
            assert ins.read() == payload[990:]
            assert mod.prop_int(g, "answer") == 42
            assert mod.prop_str(g, "name") == "x"
            assert mod.prop_int(g, "missing", 7) == 7
            assert st.check_state(mod.STATE_SORTING_COUNT_DONE)
            assert not st.check_state(mod.STATE_CONFIGURATION_DONE)


@pytest.mark.parametrize("k", [21, 63, 95])
def test_solid_table_round_trips_across_packages(k, tmp_path):
    """save_solid / load_solid (16-byte-integer records above k=32 are
    read as raw bytes): each package reads the other's file."""
    w = (2 * k + 31) // 32
    rng = np.random.default_rng(k)
    limbs = rng.integers(0, 2**32, (200, w), dtype=np.uint64).astype(
        np.uint32)
    limbs[:, 0] &= (1 << ((2 * k - 1) % 32 + 1)) - 1
    limbs = np.unique(limbs, axis=0)
    counts = rng.integers(1, 70000, len(limbs)).astype(np.int32)
    with th5.Storage(str(tmp_path / "port.h5"), "w") as st:
        th5.save_solid(st, limbs, counts, k)
    with jh5.Storage(str(tmp_path / "jax.h5"), "w") as st:
        jh5.save_solid(st, limbs, counts, k)
    for mod, name in ((th5, "jax.h5"), (jh5, "port.h5"), (th5, "port.h5")):
        with mod.Storage(str(tmp_path / name), "r") as st:
            got_l, got_c = mod.load_solid(st)
            assert np.array_equal(got_l, limbs)
            assert np.array_equal(got_c, counts)

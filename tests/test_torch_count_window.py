"""The count's superbatch window on the CPU: each superbatch's scalars
read back through ``_scalars_to_host`` at dispatch and waited on at its
resolve, the staged uploads, and a parse queue two superbatches deep.

- both drivers, over one and three passes, with the default distinct
  ratio and with one so small that the compact tables overflow: the
  solid k-mers, counts, histogram and ``info`` totals equal to the dict
  reference's, replays only where they are forced, and every superbatch
  dispatched resolved once (``resolve_ready`` equals ``superbatches``: on
  the CPU the values are on the host when asked);
- the count's parse queue holds at least two superbatches of batches;
- a list of batches stages as their stack, uint32 as int32 bits.

The ``cuda``-marked twins (the window on the card raises nothing under
torch's sync debug mode, and a count with replays equals the CPU's) are
in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from gatb_core_tpu_torch import BankStrings, CountConfig, SortingCount
from gatb_core_tpu_torch.kmer import counting as tc
from gatb_core_tpu_torch.kmer.model import count_kmers_py
from gatb_core_tpu_torch.misc import time_info as T

K = 31
AMIN = 2
# 5 read batches of 1,568 windows a superbatch: ~1,600 distinct k-mers
# each, ~530 in each of three passes, over the 256-row floor of a tiny
# ratio's compact table; a 6 kb genome, so the fold's first accumulator
# holds the bank without growing
KW = dict(kmer_size=K, abundance_min=AMIN, batch_reads=16, batch_len=128,
          superbatch_rows=1 << 13, device="cpu")


def _reads(seed=7, size=6000, step=20):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=size))
    reads = [genome[i:i + 100] for i in range(0, size - 100, step)]
    reads[3] = reads[3][:40] + "N" + reads[3][41:]
    reads[8] = reads[8][:50]
    return reads


READS = _reads()


@pytest.fixture(autouse=True)
def fresh():
    T.clear_spans()
    yield
    T.clear_spans()


def _counted(**kw):
    """(result, counters of its ``count`` span)."""
    with T.recording():
        res = SortingCount(CountConfig(**KW, **kw)).run(BankStrings(*READS))
    (count,) = [sp for sp in T.spans() if sp.name == "count"]
    return res, count.counts


@pytest.mark.parametrize("replay", [False, True], ids=["normal", "replay"])
@pytest.mark.parametrize("passes", [1, 3], ids=["1pass", "3pass"])
@pytest.mark.parametrize("fold", [True, False], ids=["fold", "lsm"])
def test_the_window_counts_as_the_reference(fold, passes, replay):
    kw = dict(carry_accumulator=fold, nb_passes=passes)
    if replay:
        kw["distinct_ratio_hint"] = 1e-4
    res, counts = _counted(**kw)
    every = count_kmers_py(READS, K)
    solid = {v: c for v, c in every.items() if c >= AMIN}
    assert res.as_dict() == solid and len(solid) > 0
    want = np.zeros(res.histogram.max_value + 1, np.uint64)
    for c in every.values():
        want[min(c, res.histogram.max_value)] += 1
    assert np.array_equal(res.histogram.bins, want)
    inside = sum(max(len(r) - K + 1, 0) for r in READS)
    valid = sum(every.values())
    assert res.info["kmers_nb_distinct"] == len(every)
    assert res.info["kmers_nb_solid"] == len(solid)
    assert res.info["kmers_nb_weak"] == len(every) - len(solid)
    assert res.info["kmers_nb_valid"] == valid
    assert res.info["kmers_nb_invalid"] == inside - valid > 0
    assert res.info["nb_passes_effective"] == passes
    if replay:
        assert counts["replays"] >= 1
    else:
        assert counts.get("replays", 0) == 0
    assert counts["superbatches"] > counts.get("replays", 0)
    assert counts["resolve_ready"] == counts["superbatches"]


def test_the_parse_queue_holds_two_superbatches(monkeypatch):
    depths = []
    real = tc._prefetch

    def prefetch(gen, depth=4):
        depths.append(depth)
        return real(gen, depth)

    monkeypatch.setattr(tc, "_prefetch", prefetch)
    kw = dict(KW, superbatch_rows=1 << 16)
    res = SortingCount(CountConfig(**kw)).execute(BankStrings(*READS))
    L = max(kw["batch_len"], 2 * K)
    G = kw["superbatch_rows"] // (kw["batch_reads"] * (L - K + 1))
    assert G == 41
    assert depths and all(d >= 2 * G for d in depths)
    assert res.as_dict() == count_kmers_py(READS, K, abundance_min=AMIN)


def test_a_list_of_batches_stages_as_their_stack():
    rng = np.random.default_rng(3)
    words = [rng.integers(0, 2**32, (4, 5), dtype=np.uint32)
             for _ in range(3)]
    got = tc._stage(words, "cpu")
    assert got.dtype == torch.int32 and got.shape == (3, 4, 5)
    assert np.array_equal(got.numpy().view(np.uint32), np.stack(words))
    one = tc._stage(words[0], "cpu")
    assert np.array_equal(one.numpy().view(np.uint32), words[0])
    flags = [rng.random((2, 3)) > 0.5 for _ in range(2)]
    assert torch.equal(tc._stage(flags, "cpu"),
                       torch.from_numpy(np.stack(flags)))

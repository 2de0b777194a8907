"""The port at k > 31 (two to four limbs a k-mer) against the benchmark's
exact wide reference, the wide reference against the int64 one where both
hold k, and faults planted at k 63 that the wide judge must catch.

``benchmark/reference/wide.py`` holds a k-mer of k <= 63 as two int64
words, ``dbg_wide.py`` judges a count, a graph and its unitigs with it;
both are plain torch, independent of the port. The port runs on the CPU
(its kernels' plain twins) on a small seeded bank with both strands and
0.5% substitutions.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import dbg as R64
from benchmark.reference import dbg_wide as R
from benchmark.reference import kmers as K
from benchmark.reference import wide as W
from gatb_core_tpu_torch import BankStrings, Graph, count_kmers
from gatb_core_tpu_torch.ops import kmer_ops

# small superbatches, so that a bank of a few hundred reads takes several
KW = dict(abundance_min=2, device="cpu", batch_reads=64, batch_len=128,
          superbatch_rows=1 << 14)


def _bank(seed, genome_len=2000, n=500, length=100, err=0.005):
    """(n, length) uint8 codes (A0 C1 T2 G3) of reads of a uniform genome,
    half of them reverse-complemented, with substitutions."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    st = rng.integers(0, genome_len - length + 1, n)
    codes = genome[st[:, None] + np.arange(length)]
    flip = rng.random(n) < 0.5
    codes = np.where(flip[:, None], codes[:, ::-1] ^ 2, codes)
    hit = rng.random(codes.shape) < err
    codes = np.where(hit, (codes + rng.integers(1, 4, codes.shape)) & 3,
                     codes)
    return codes.astype(np.uint8)


def _strings(codes):
    return BankStrings(*["".join("ACTG"[c] for c in r) for r in codes])


def _unitig_arrays(ug):
    return {"chars": "".join(ug.sequences).encode("ascii"),
            "lengths": ug.unitig_lengths(), "kmer_counts": ug.kmer_counts,
            "mean_abundance": ug.mean_abundance,
            "link_offsets": ug.link_offsets,
            "link_targets": ug.link_targets}


def _judge_graph(truth, g, ug, limbs=None):
    limbs = g.solid_limbs if limbs is None else limbs
    nums = R.compare_count(truth, limbs, g.solid_counts, g.info)
    nums.update(R.compare_graph(truth, limbs, g.precompute_adjacency(),
                                g.branching_nodes()))
    nums.update(R.check_unitigs(truth, **_unitig_arrays(ug)))
    return nums


@pytest.fixture(scope="module")
def k63():
    codes = _bank(63)
    g = Graph.create(_strings(codes), kmer_size=63, **KW)
    return codes, g, g.unitig_graph(), R.Truth.of([torch.from_numpy(codes)],
                                                  63, 2)


@pytest.mark.parametrize("k", [33, 47, 63])
def test_graph_and_unitigs_equal_the_wide_reference(k, k63):
    if k == 63:
        codes, g, ug, truth = k63
    else:
        codes = _bank(k)
        g = Graph.create(_strings(codes), kmer_size=k, **KW)
        ug = g.unitig_graph()
        truth = R.Truth.of([torch.from_numpy(codes)], k, 2)
    assert g.solid_limbs.shape[1] == (2 * k + 31) // 32
    assert truth.nodes.shape[0] > 1000
    nums = _judge_graph(truth, g, ug)
    assert set(nums) == {"solid_kmers_diff", "count_diff", "histogram_diff",
                         "valid_kmers_diff", "mask_diff", "branching_diff",
                         "unitig_errors", "unitig_abundance_diff",
                         "link_diff"}
    assert not any(nums.values()), nums


@pytest.mark.parametrize("k", [33, 47, 63])
def test_count_equals_the_wide_reference(k):
    codes = _bank(k + 1)
    res = count_kmers(_strings(codes), kmer_size=k, **KW)
    truth = R.Truth.of([torch.from_numpy(codes)], k, 2)
    nums = R.compare_count(truth, res.solid_kmers, res.solid_counts,
                           res.info)
    assert not any(nums.values()), nums
    assert res.info["kmers_nb_valid"] == truth.windows == 500 * (101 - k)


@pytest.mark.parametrize("k", [5, 15, 31])
def test_wide_equals_the_int64_reference(k):
    codes = torch.from_numpy(_bank(k, genome_len=600, n=300, length=60))
    u, c, w = K.count([codes], k)
    uw, cw, ww = W.count([codes], k)
    assert ww == w and torch.equal(cw, c)
    assert torch.equal(uw[:, 0], torch.zeros_like(u))
    assert torch.equal(uw[:, 1], u)
    nodes, nw = u[c >= 2], uw[cw >= 2]
    assert torch.equal(W.masks(nw, nw, k), K.masks(nodes, nodes, k))
    assert torch.equal(W.revcomp(uw, k)[:, 1], K.revcomp(u, k))
    assert torch.equal(W.neighbor_candidates(nw, k)[..., 1],
                       K.neighbor_candidates(nodes, k))
    q = torch.cat([u, u + 1, u - 1]).clamp(min=0)
    assert torch.equal(W.rank(nw, W.key(torch.zeros_like(q), q)),
                       K.rank(nodes, q))
    limbs = K.values_to_limbs(nodes.numpy(), k)
    assert np.array_equal(W.limbs_to_keys(limbs), nw.numpy())
    assert np.array_equal(W.keys_to_limbs(nw.numpy(), k), limbs)
    # the two judges agree on the int64 reference's own outputs
    t64 = R64.Truth.of([codes], k, 2)
    tw = R.Truth.of([codes], k, 2)
    info = {"kmers_nb_distinct": u.numel(), "kmers_nb_valid": w,
            "kmers_nb_weak": int((c < 2).sum())}
    cut = limbs[1:]
    assert R.compare_count(tw, cut, c[c >= 2][1:], info) \
        == R64.compare_count(t64, cut, c[c >= 2][1:], info)
    masks = t64.masks.numpy()
    assert R.compare_graph(tw, limbs, masks, limbs[:5]) \
        == R64.compare_graph(t64, limbs, masks, limbs[:5])


def test_wide_keys_against_python_integers():
    """At k 63 the keys are the k-mers' 126-bit integers exactly, in
    order: canonical forms, reverse complements and the limb rows."""
    k = 63
    codes = _bank(5, genome_len=400, n=40, length=80)
    comp = {0: 2, 1: 3, 2: 0, 3: 1}
    want = set()
    for r in codes.tolist():
        for i in range(len(r) - k + 1):
            f = rc = 0
            for j in range(k):
                f = (f << 2) | r[i + j]
                rc = (rc << 2) | comp[r[i + k - 1 - j]]
            want.add(min(f, rc))
    u, _, _ = W.count([torch.from_numpy(codes)], k)
    got = [(a << 63) | b for a, b in u.tolist()]
    assert got == sorted(want)
    assert [int(x) for x in kmer_ops.kmers_to_py(
        W.keys_to_limbs(u.numpy(), k))] == got


def _wrong_high_revcomp(monkeypatch):
    """The port's reverse complement with the high limb left
    uncomplemented."""
    rc = kmer_ops.revcomp_limbs_

    def broken(limbs, k):
        x = rc(limbs, k).clone()
        x[..., 0] ^= 0xAAAAAAAA & kmer_ops.top_mask(k)
        return x

    monkeypatch.setattr(kmer_ops, "revcomp_limbs_", broken)


@pytest.mark.parametrize("fault", ["dropped_high_limb", "swapped_limbs",
                                   "wrong_high_revcomp"])
def test_planted_fault_at_k63_is_caught(fault, k63, monkeypatch):
    codes, g, ug, truth = k63
    if fault == "wrong_high_revcomp":
        _wrong_high_revcomp(monkeypatch)
        res = count_kmers(_strings(codes), kmer_size=63, **KW)
        nums = R.compare_count(truth, res.solid_kmers, res.solid_counts,
                               res.info)
        assert nums["solid_kmers_diff"] > 0
        return
    limbs = g.solid_limbs.copy()
    if fault == "dropped_high_limb":
        limbs[:, 0] = 0
    else:
        limbs = limbs[:, ::-1]
    nums = _judge_graph(truth, g, ug, limbs)
    assert nums["solid_kmers_diff"] > 0 and nums["mask_diff"] > 0

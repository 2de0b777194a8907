"""The plain reference against Python integers and strings, and the
unitig judge against unitig sets broken on purpose."""

import numpy as np
import pytest
import torch

from benchmark.reference import dbg as R
from benchmark.reference import kmers as K

COMP = str.maketrans("ACGT", "TGCA")
CODE = {c: i for i, c in enumerate("ACTG")}


def value(s):
    v = 0
    for c in s:
        v = (v << 2) | CODE[c]
    return v


def canon(s):
    return min(value(s), value(s.translate(COMP)[::-1]))


def reads(seed=3, n=300, length=40, g=400):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, g)
    st = rng.integers(0, g - length + 1, n)
    codes = genome[st[:, None] + np.arange(length)].astype(np.uint8)
    hit = rng.random(codes.shape) < 0.01
    return np.where(hit, (codes + 1) & 3, codes).astype(np.uint8)


def strings(codes):
    return ["".join("ACTG"[c] for c in r) for r in codes]


@pytest.mark.parametrize("k", [5, 15, 31])
def test_count_against_python(k):
    codes = reads()
    uniq, counts, windows = K.count([torch.from_numpy(codes)], k)
    want = {}
    for s in strings(codes):
        for i in range(len(s) - k + 1):
            c = canon(s[i:i + k])
            want[c] = want.get(c, 0) + 1
    assert windows == sum(want.values())
    assert dict(zip(uniq.tolist(), counts.tolist())) == want


def test_masks_and_rank_against_python():
    k = 11
    codes = reads(length=30)
    uniq, counts, _ = K.count([torch.from_numpy(codes)], k)
    nodes = uniq[counts >= 2]
    table = set(nodes.tolist())
    got = K.masks(nodes, nodes, k).tolist()
    mask = (1 << 2 * k) - 1

    def c(v):
        s = "".join("ACTG"[(v >> 2 * (k - 1 - i)) & 3] for i in range(k))
        return canon(s)

    for v, m in zip(nodes.tolist(), got):
        bits = [c(((v << 2) | nt) & mask) in table for nt in range(4)] + \
            [c((v >> 2) | (nt << 2 * k - 2)) in table for nt in range(4)]
        assert m == sum(b << i for i, b in enumerate(bits))
    q = torch.cat([nodes[::3], nodes[::5] + 1])
    r = K.rank(nodes, q).tolist()
    lst = nodes.tolist()
    assert r == [lst.index(x) if x in table else -1 for x in q.tolist()]


def test_limbs_round_trip():
    v = np.array([0, 1, (1 << 62) - 1, 123456789012345], np.int64)
    assert np.array_equal(K.limbs_to_values(K.values_to_limbs(v, 31)), v)
    assert np.array_equal(K.limbs_to_values(K.values_to_limbs(v[:2], 9)),
                          v[:2])


def graph_of(codes, k=15, amin=2):
    return R.Truth.of([torch.from_numpy(codes)], k, amin)


def unitigs_of(t):
    """Unitigs by walking the graph in Python, for a judge to check."""
    k = t.k
    nodes = t.nodes.tolist()
    table = set(nodes)
    mask = (1 << 2 * k) - 1

    def rc(v):
        return K.revcomp(torch.tensor([v]), k).item()

    def out(v):
        return [w for w in (((v << 2) | nt) & mask for nt in range(4))
                if min(w, rc(w)) in table]

    def inn(v):
        return [w for w in ((v >> 2) | (nt << 2 * k - 2) for nt in range(4))
                if min(w, rc(w)) in table]

    seen, tigs = set(), []
    for v in nodes:
        if v in seen:
            continue
        path = [v]
        seen.add(v)
        for direction in (0, 1):
            cur = path[-1] if direction == 0 else rc(path[0])
            while True:
                o = out(cur)
                if len(o) != 1 or len(inn(o[0])) != 1:
                    break
                nxt = o[0]
                if min(nxt, rc(nxt)) in seen:
                    break
                seen.add(min(nxt, rc(nxt)))
                if direction == 0:
                    path.append(nxt)
                else:
                    path.insert(0, rc(nxt))
                cur = nxt
        s = "".join("ACTG"[(path[0] >> 2 * (k - 1 - i)) & 3]
                    for i in range(k))
        s += "".join("ACTG"[p & 3] for p in path[1:])
        tigs.append(s)
    return tigs


def judge(t, tigs):
    """``check_unitigs`` on unitig strings, with their k-mer counts, mean
    abundances and links worked out here from the strings."""
    k = t.k
    lengths = np.array([len(s) for s in tigs])
    nk = lengths - k + 1
    counts = dict(zip(t.nodes.tolist(), t.counts.tolist()))
    mean = []
    for s in tigs:
        vals = [canon(s[i:i + k]) for i in range(len(s) - k + 1)]
        mean.append(np.float32(sum(counts.get(v, 0) for v in vals)
                               / len(vals)))
    src, dst = [], []
    for a in range(2 * len(tigs)):
        sa = tigs[a >> 1] if a % 2 == 0 else tigs[a >> 1].translate(
            COMP)[::-1]
        for b in range(2 * len(tigs)):
            sb = tigs[b >> 1] if b % 2 == 0 else tigs[b >> 1].translate(
                COMP)[::-1]
            if sa[-(k - 1):] == sb[:k - 1] and canon(sa[-(k - 1):]
                                                    + sb[k - 1]) in counts:
                src.append(a)
                dst.append(b)
    offs = np.zeros(2 * len(tigs) + 1, np.int64)
    np.add.at(offs, np.array(src, np.int64) + 1, 1)
    return R.check_unitigs(t, "".join(tigs).encode(), lengths, nk,
                           np.array(mean, np.float32), np.cumsum(offs),
                           np.array(dst, np.int64))


@pytest.fixture(scope="module")
def small_graph():
    t = graph_of(reads(seed=11, n=400, length=40, g=300))
    return t, unitigs_of(t)


def test_judge_passes_true_unitigs(small_graph):
    t, tigs = small_graph
    assert len(tigs) > 3
    assert judge(t, tigs) == {"unitig_errors": 0,
                              "unitig_abundance_diff": 0, "link_diff": 0}


@pytest.mark.parametrize("fault", ["drop", "split", "base", "merge_rc"])
def test_judge_fails_broken_unitigs(small_graph, fault):
    t, tigs = small_graph
    tigs = list(tigs)
    k = t.k
    longest = max(range(len(tigs)), key=lambda i: len(tigs[i]))
    s = tigs[longest]
    if fault == "drop":
        tigs.pop(longest)
    elif fault == "split":
        assert len(s) >= k + 2
        tigs[longest:longest + 1] = [s[:k], s[1:]]
    elif fault == "base":
        c = "ACGT"[("ACGT".index(s[-1]) + 1) % 4]
        tigs[longest] = s[:-1] + c
    else:
        tigs[longest] = s.translate(COMP)[::-1] + "A"
    nums = judge(t, tigs)
    assert nums["unitig_errors"] > 0

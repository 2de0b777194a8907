"""gatb_core_tpu_torch on a CUDA card: each kernel against its plain
PyTorch version (bit for bit), and a count and a graph build on the card
against the same on the CPU and the dict ground truth.

Every test here needs a card and skips without one. The file imports
neither jax nor gatb_core_tpu, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from gatb_core_tpu_torch import BankStrings, count_kmers
from gatb_core_tpu_torch.kmer.model import count_kmers_py
from gatb_core_tpu_torch.ops import limb_sort as S
from gatb_core_tpu_torch.ops import rank_search as R
from gatb_core_tpu_torch.ops import solid_select as SS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _planes(w, n, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 5, (w, n), dtype=torch.int32, generator=g)
    x[0, 1::5] = -7                       # high bit set
    x[:, ::9] = -1                        # sentinel rows
    return x.to(device)


@pytest.mark.parametrize("w,n", [(2, 1 << 12), (3, 1 << 17), (9, 1 << 16),
                                 (7, 1 << 15)])
def test_kernels_match_plain(cuda, w, n):
    """7 planes take tile_sort's path for any number of planes (sorted
    slots), the others keep their rows in registers."""
    x = _planes(w, n, seed=n + w, device=cuda)
    tile = min(S.sort_tile_rows(w), n)
    assert torch.equal(S.tile_sort(x.clone(), tile),
                       S.tile_sort_plain(x, tile))
    assert (w, n, tile) in S.launch_shapes["tile_sort"]
    # every tile from 2 rows to the largest the kernel takes
    t = 2
    while t <= min(S.sort_tile_max(w), n):
        assert torch.equal(S.tile_sort(x.clone(), t),
                           S.tile_sort_plain(x, t)), t
        t *= 2
    with pytest.raises(ValueError):
        S.tile_sort(x.clone(), 2 * S.sort_tile_max(w))
    # one merge level over ascending runs, at the default tile and a small one
    run = min(tile, n // 2)
    a = S.tile_sort_plain(x, run)
    for mt in sorted({min(S.merge_tile_rows(w), 2 * run), 64}):
        split = S.merge_partition(a, run, mt)
        assert torch.equal(split, S.merge_partition_plain(a, run, mt))
        assert torch.equal(S.merge_tiles(a, run, split, mt),
                           S.merge_tiles_plain(a, run, split, mt))
        assert (w, n, run, mt) in S.launch_shapes["merge_partition"]
        assert (w, n, run, mt) in S.launch_shapes["merge_tiles"]
    # the sort: one tile_sort, then two launches per doubling of the run
    before = dict(S.launches)
    assert torch.equal(S.sort_u32_limbs(x.clone()),
                       S.sort_u32_limbs_plain(x))
    levels = (n // tile).bit_length() - 1
    assert S.launches["tile_sort"] == before["tile_sort"] + 1
    assert S.launches["merge_partition"] == before["merge_partition"] + levels
    assert S.launches["merge_tiles"] == before["merge_tiles"] + levels


@pytest.mark.parametrize("w,n,run", [(2, 2, 1), (3, 4, 1), (3, 1 << 14, 256)])
def test_merge_tiles_unaligned_matches_plain(cuda, w, n, run):
    """The kernel's 4-byte path: too few rows for 16-byte words, and planes
    whose storage is not 16-byte aligned."""
    runs = S.tile_sort_plain(_planes(w, n, seed=n, device=cuda), run)
    shifted = torch.empty(w * n + 1, dtype=torch.int32,
                          device=cuda)[1:].view(w, n)
    shifted.copy_(runs)
    assert torch.equal(S.merge_sorted_runs(shifted, run),
                       S.merge_sorted_runs_plain(runs, run))


def test_merge_sorted_runs_matches_plain(cuda):
    x = _planes(3, 1 << 18, seed=3, device=cuda)
    run = 1 << 17
    halves = torch.cat([S.sort_u32_limbs_plain(x[:, :run].contiguous()),
                        S.sort_u32_limbs_plain(x[:, run:].contiguous())],
                       dim=1).contiguous()
    before = dict(S.launches)
    assert torch.equal(S.merge_sorted_runs(halves, run),
                       S.sort_u32_limbs_plain(x))
    assert S.launches["merge_partition"] == before["merge_partition"] + 1
    assert S.launches["merge_tiles"] == before["merge_tiles"] + 1


def test_count_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), size=2000))
    reads = [genome[i:i + 100] for i in range(0, 1900, 4)]
    kw = dict(kmer_size=31, abundance_min=1, batch_reads=64,
              superbatch_rows=1 << 16)
    on_card = count_kmers(BankStrings(*reads), device="cuda", **kw)
    on_cpu = count_kmers(BankStrings(*reads), device="cpu", **kw)
    assert np.array_equal(on_card.solid_kmers, on_cpu.solid_kmers)
    assert np.array_equal(on_card.solid_counts, on_cpu.solid_counts)
    assert on_card.as_dict() == count_kmers_py(reads, 31, abundance_min=1)


@pytest.mark.parametrize("k", [31, 63])
def test_three_pass_count_on_card_merges_there(cuda, k, monkeypatch):
    """A three-pass count on the card equals the one-pass count on the
    card and on the CPU, its passes' solid rows merged on the card by
    ``merge_tiles``: one level per doubling of the four runs."""
    from gatb_core_tpu_torch.kmer import counting as tc

    rng = np.random.default_rng(9)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    reads = [genome[i:i + 150] for i in range(0, 2850, 5)]
    kw = dict(kmer_size=k, abundance_min=2, batch_reads=64,
              superbatch_rows=1 << 16)
    one = count_kmers(BankStrings(*reads), device="cuda", **kw)
    merges = []
    merge = tc._merge_solid_parts

    def counted(parts):
        n, before = len(parts), S.launches["merge_tiles"]
        out = merge(parts)
        merges.append((n, S.launches["merge_tiles"] - before,
                       out[0].is_cuda))
        return out

    monkeypatch.setattr(tc, "_merge_solid_parts", counted)
    three = count_kmers(BankStrings(*reads), device="cuda", nb_passes=3,
                        **kw)
    assert merges == [(3, 2, True)]
    on_cpu = count_kmers(BankStrings(*reads), device="cpu", nb_passes=3,
                         **kw)
    for got in (three, on_cpu):
        assert np.array_equal(got.solid_kmers, one.solid_kmers)
        assert np.array_equal(got.solid_counts, one.solid_counts)
        assert np.array_equal(got.histogram.bins, one.histogram.bins)
    assert three.info["nb_passes_effective"] == 3
    assert three.as_dict() == count_kmers_py(reads, k, abundance_min=2)


def test_three_pass_count_on_card_through_the_host(cuda, monkeypatch):
    """Where the passes' solid rows would not fit on the card with their
    merge, each goes to pinned host memory at its pass end and the host
    merges them: the count equals the one-pass count on the card."""
    from gatb_core_tpu_torch.kmer import counting as tc

    rng = np.random.default_rng(9)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    reads = [genome[i:i + 150] for i in range(0, 2850, 5)]
    kw = dict(kmer_size=31, abundance_min=2, batch_reads=64,
              superbatch_rows=1 << 16, device="cuda")
    one = count_kmers(BankStrings(*reads), **kw)
    monkeypatch.setattr(tc, "_parts_fit", lambda parts, more: False)
    merges = []
    merge = tc._merge_host_parts

    def counted(parts):
        merges.append([(r.is_pinned(), c.is_pinned()) for r, c in parts])
        return merge(parts)

    monkeypatch.setattr(tc, "_merge_host_parts", counted)
    three = count_kmers(BankStrings(*reads), nb_passes=3, **kw)
    assert merges == [[(True, True)] * 3]
    assert np.array_equal(three.solid_kmers, one.solid_kmers)
    assert np.array_equal(three.solid_counts, one.solid_counts)
    assert np.array_equal(three.histogram.bins, one.histogram.bins)


def _window_reads():
    """A bank whose superbatches hold ~1,600 distinct k-mers each (see
    ``tests/test_torch_count_window.py``): a tiny distinct ratio makes
    their compact tables overflow."""
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    return [genome[i:i + 100] for i in range(0, 5900, 20)]


WINDOW_KW = dict(kmer_size=31, abundance_min=2, batch_reads=16,
                 batch_len=128, superbatch_rows=1 << 13)


@pytest.mark.parametrize("fold", [True, False], ids=["fold", "lsm"])
def test_the_count_window_on_card(cuda, fold):
    """The superbatch window: a count with replays forced equals the
    CPU's and the dict reference, with ``resolve_ready`` counted among
    its superbatches; staging and dispatching two superbatches raise
    nothing under torch's sync debug mode (pinned non-blocking uploads,
    readbacks by event; the resolves, which wait on those events, run
    outside the guarded region), and the pass's table equals the same
    superbatches' on the CPU."""
    from gatb_core_tpu_torch.kmer import counting as tc
    from gatb_core_tpu_torch.misc import time_info as T

    reads = _window_reads()
    kw = dict(WINDOW_KW, carry_accumulator=fold, distinct_ratio_hint=1e-4)
    T.clear_spans()
    with T.recording():
        on_card = tc.SortingCount(tc.CountConfig(device="cuda", **kw)).run(
            BankStrings(*reads))
    (count,) = [sp for sp in T.spans() if sp.name == "count"]
    T.clear_spans()
    on_cpu = count_kmers(BankStrings(*reads), device="cpu", **kw)
    assert np.array_equal(on_card.solid_kmers, on_cpu.solid_kmers)
    assert np.array_equal(on_card.solid_counts, on_cpu.solid_counts)
    assert np.array_equal(on_card.histogram.bins, on_cpu.histogram.bins)
    assert on_card.as_dict() == count_kmers_py(reads, 31, abundance_min=2)
    assert count.counts["replays"] >= 1
    assert 0 <= count.counts.get("resolve_ready", 0) \
        <= count.counts["superbatches"]

    tables = []
    for device in ("cuda", "cpu"):
        cfg = tc.CountConfig(device=device, **kw)
        stream = tc._ReadStream(BankStrings(*reads), cfg)
        L = stream.builder.L
        per_batch = cfg.batch_reads * (L - cfg.kmer_size + 1)
        G = cfg.superbatch_rows // per_batch
        groups = list(tc._groups(stream.batches(True, G), G))
        assert len(groups) >= 3
        driver = (tc._FoldDriver if fold else tc._LsmDriver)(
            cfg, 1, L, per_batch, 1 << 30, T.NULL_SPAN, T.TimeInfo(),
            T.Progress(len(groups), "", verbose=False))
        # past its first resolve, the LSM driver keeps superbatches in
        # flight as the fold does
        driver.n_resolved = 1
        cache = tc._BankCache(0, False)
        guard = device == "cuda"
        if guard:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for group in groups[:2]:
                driver.dispatch(tc._stage_superbatch(group, G, driver,
                                                     cache),
                                0, True, len(group))
        finally:
            if guard:
                torch.cuda.set_sync_debug_mode(0)
        for group in groups[2:]:
            driver.dispatch(tc._stage_superbatch(group, G, driver, cache),
                            0, True, len(group))
        planes, counts, n = driver.end_pass()
        tables.append((planes[:, :n].cpu(), counts[:n].cpu(), n,
                       driver.windows))
    (pa, ca, na, wa), (pb, cb, nb, wb) = tables
    assert na == nb > 0 and wa == wb > 0
    assert torch.equal(pa, pb) and torch.equal(ca, cb)


@pytest.mark.parametrize("n", [1 << 7, 1 << 14, 1 << 15, 1 << 19])
def test_bitonic_u64_matches_plain(cuda, n):
    """Less than a tile, one tile, two tiles and many: one bitonic_u64
    launch, then two launches per merge level."""
    g = torch.Generator().manual_seed(n)
    hi = torch.randint(-4, 4, (n,), dtype=torch.int32, generator=g)
    lo = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                       generator=g)
    hi[::7] = -1                          # sentinel pairs
    lo[::7] = -1
    hi, lo = hi.to(cuda), lo.to(cuda)
    kept = hi.clone(), lo.clone()
    before = dict(S.launches)
    oh, ol = S.bitonic_sort_u64(hi, lo)
    ph, pl = S.bitonic_sort_u64_plain(hi, lo)
    assert torch.equal(oh, ph) and torch.equal(ol, pl)
    assert torch.equal(hi, kept[0]) and torch.equal(lo, kept[1])
    tile = min(S.U64_TILE_ROWS, n)
    levels = (n // tile).bit_length() - 1
    assert S.launches["bitonic_u64"] == before["bitonic_u64"] + 1
    assert S.launches["merge_partition"] == before["merge_partition"] + levels
    assert S.launches["merge_tiles"] == before["merge_tiles"] + levels
    assert S.launches["tile_sort"] == before["tile_sort"]
    assert (n, tile) in S.launch_shapes["bitonic_u64"]
    # a smaller tile: more merge levels, the same result
    sh, sl = S.bitonic_sort_u64(hi, lo, tile_log2=5)
    assert torch.equal(sh, ph) and torch.equal(sl, pl)


def test_lsm_count_and_fetches_on_card_match_cpu(cuda):
    from gatb_core_tpu_torch.kmer import counting as tc

    rng = np.random.default_rng(6)
    genome = "".join(rng.choice(list("ACGT"), size=2000))
    reads = [genome[i:i + 100] for i in range(0, 1900, 4)]
    kw = dict(kmer_size=31, abundance_min=1, batch_reads=64,
              superbatch_rows=1 << 14, carry_accumulator=False,
              nb_passes=2)
    on_card = count_kmers(BankStrings(*reads), device="cuda", **kw)
    assert on_card.as_dict() == count_kmers_py(reads, 31, abundance_min=1)
    # the fetch of a device table equals the same table's on the CPU
    n = 3000
    planes = torch.arange(2 * 4096, dtype=torch.int32,
                          device=cuda).reshape(2, 4096).contiguous()
    counts = (torch.arange(4096, dtype=torch.int32, device=cuda) % 300) + 1
    got = tc._fetch_table(planes, counts, n, 2)
    ref = tc._fetch_table(planes.cpu(), counts.cpu(), n, 2)
    assert got[1].dtype == np.int32 and got[1].max() == 300
    assert np.array_equal(got[0], ref[0])
    assert np.array_equal(got[1], ref[1])


def _rank_table(w, n, cap, g):
    """A sorted table of up to n distinct random rows of w limbs under an
    all-ones padded tail of cap rows (on the CPU), and its live rows."""
    rows = torch.randint(-2**31, 2**31 - 1, (w, max(n, 1)),
                         dtype=torch.int32, generator=g)
    rows = S.sort_u32_limbs_plain(rows).T[:n]
    if n > 1:
        keep = torch.ones(n, dtype=torch.bool)
        keep[1:] = (rows[1:] != rows[:-1]).any(dim=1)
        rows = rows[keep]
    live = rows.shape[0]
    table = torch.full((cap, w), -1, dtype=torch.int32)
    table[:live] = rows
    return table, live


def _rank_queries(table, live, q, g):
    w = table.shape[1]
    queries = torch.randint(-2**31, 2**31 - 1, (q, w), dtype=torch.int32,
                            generator=g)
    if live:
        queries[::2] = table[torch.randint(0, live, ((q + 1) // 2,),
                                           generator=g)]
    queries[7] = -1
    queries[9] = 0
    return queries


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("n,cap", [(0, 4), (1, 1), (1000, 1024),
                                   (70_000, 1 << 17)])
def test_rank_rows_matches_plain(cuda, w, n, cap):
    """Templated widths and the generic one (5), an empty table, a padded
    tail; queries present, absent, duplicated, the padding row, none."""
    g = torch.Generator().manual_seed(w * 1000 + n)
    table, live = _rank_table(w, n, cap, g)
    queries = _rank_queries(table, live, 5000, g)
    table, queries = table.to(cuda), queries.to(cuda)
    before = R.launches["rank_rows"]
    for q in (queries, queries[:1].contiguous(), queries[:0].contiguous()):
        rank, found = R.rank_rows(table, q, live)
        ref_rank, ref_found = R.rank_rows_plain(table, q, live)
        assert torch.equal(rank, ref_rank) and torch.equal(found, ref_found)
        assert rank.dtype == torch.int32 and found.dtype == torch.bool
    assert R.launches["rank_rows"] == before + 2      # none for no query
    assert (w, cap, live, 5000) in R.launch_shapes["rank_rows"]
    rank, found = R.rank_rows(table, table[:live].contiguous(), live)
    assert found.all() and torch.equal(
        rank, torch.arange(live, dtype=torch.int32, device=cuda))
    # storage off 16-byte alignment
    flat = torch.empty(table.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = flat[1:].view_as(table)
    shifted.copy_(table)
    rank, _ = R.rank_rows(shifted, queries, live)
    assert torch.equal(rank, R.rank_rows_plain(table, queries, live)[0])


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 8])
def test_rank_rows_walks_a_held_index(cuda, w):
    """The kernel with a held index and with a transient one against the
    plain walk of the same index and the binary search: n_table at every
    block and level boundary under a padded tail, one index over several
    query batches, and a tall index (2^20 rows of 1 limb, 3 levels)."""
    b = R.node_rows(w)
    g = torch.Generator().manual_seed(w)
    sizes = sorted({0, 1, b - 1, b, b + 1, b * b - 1, b * b, b * b + 1,
                    b ** 3 - 1, b ** 3 + 1})
    for n in sizes:
        table, live = _rank_table(w, n, n + 5, g)
        table = table.to(cuda)
        index = R.RankIndex(table, live)
        for q in (4000, 1, 130):
            queries = _rank_queries(table.cpu(), live, max(q, 10), g)[:q]
            queries = queries.to(cuda).contiguous()
            ref = R.rank_rows_plain(table, queries, live)
            for got in (R.rank_rows(table, queries, live, index=index),
                        R.rank_rows(table, queries, live),
                        R.rank_rows_indexed_plain(index, queries)):
                assert torch.equal(got[0], ref[0])
                assert torch.equal(got[1], ref[1])
    # rows of 1 limb: 2^20 rows index into 3 levels
    table, live = _rank_table(1, 1 << 20, 1 << 20, g)
    table = table.to(cuda)
    index = R.RankIndex(table, live)
    assert len(index.lengths) == 3
    queries = _rank_queries(table.cpu(), live, 1 << 16, g).to(cuda)
    assert torch.equal(R.rank_rows(table, queries, live, index=index)[0],
                       R.rank_rows_plain(table, queries, live)[0])
    with pytest.raises(ValueError):
        R.rank_rows(table, queries, live - 1, index=index)


NEIGHBOR_KS = [11, 16, 17, 31, 32, 33, 63, 65, 95, 111, 127]


def _kmer_rows(k, n, g, device):
    """n rows of k-mers drawn at random (limb 0 holds only the k-mer's
    bits), not from any genome: mostly absent nodes."""
    w = (k + 15) // 16
    x = torch.randint(-2**31, 2**31 - 1, (n, w), dtype=torch.int32,
                      generator=g)
    bits = 2 * k - 32 * (w - 1)
    if bits < 32:
        x[:, 0] &= (1 << bits) - 1
    return x.to(device)


@pytest.mark.parametrize("k", NEIGHBOR_KS)
def test_neighbor_masks_matches_plain(cuda, k):
    """The kernel against its plain version on the CPU: W 1-8, the index's
    walk (W 1, 2, 3, 4, 8) and the binary search (5-7), with the table's
    index held and with a transient one; a padded table, fewer live rows,
    one and none; absent nodes and the all-ones row; one node, no node;
    storage off 16-byte alignment; one launch a call."""
    from gatb_core_tpu_torch.ops import neighbor_ops as N
    from gatb_core_tpu_torch.tools.rank_sweep import genome_rows

    table = genome_rows(torch, k, 20_000, k, device=cuda)
    live, w = table.shape
    padded = torch.cat([table, torch.full((11, w), -1, dtype=torch.int32,
                                          device=cuda)])
    g = torch.Generator().manual_seed(k)
    nodes = torch.cat([
        table[torch.randperm(live, generator=g).to(cuda)],
        _kmer_rows(k, 700, g, cuda),
        torch.full((1, w), -1, dtype=torch.int32, device=cuda)])
    cpu_nodes, cpu_padded = nodes.cpu(), padded.cpu()
    N.reset_launches()
    R.reset_launches()
    for n in (live, live - 3, 1, 0):
        want = N.neighbor_masks_plain(cpu_nodes, cpu_padded, n, k)
        if n == live:
            assert (want[:live] != 0).float().mean() > 0.9
        for index in (R.RankIndex(padded, n), None):
            got = N.neighbor_masks(nodes, padded, n, k, index=index)
            assert got.is_cuda and got.dtype == torch.uint8
            assert torch.equal(got.cpu(), want), n
    assert N.launches["neighbor_masks"] == 8
    assert R.launches["rank_rows"] == 0
    assert (w, k, padded.shape[0], live, len(nodes)) in \
        N.launch_shapes["neighbor_masks"]
    want = N.neighbor_masks_plain(cpu_nodes, cpu_padded, live, k)
    one = N.neighbor_masks(nodes[:1].contiguous(), padded, live, k)
    assert torch.equal(one.cpu(), want[:1])
    none = N.neighbor_masks(nodes[:0], padded, live, k)
    assert none.shape == (0,) and N.launches["neighbor_masks"] == 9
    # storage off 16-byte alignment: the wrapper hands the kernel copies
    shifted = []
    for x in (nodes, padded):
        flat = torch.empty(x.numel() + 1, dtype=torch.int32, device=cuda)
        shifted.append(flat[1:].view_as(x))
        shifted[-1].copy_(x)
    got = N.neighbor_masks(shifted[0], shifted[1], live, k)
    assert torch.equal(got.cpu(), want)


def test_neighbor_masks_at_the_query_shape(cuda):
    """A Dispatcher group's 71,000 k=31 nodes, ~6/7 present, on a table of
    ~1M rows through its held index, against the plain version on the
    CPU; the graph sweep's shape (every node of the table)."""
    from gatb_core_tpu_torch.ops import neighbor_ops as N
    from gatb_core_tpu_torch.tools.rank_sweep import genome_rows

    table = genome_rows(torch, 31, 1_000_030, 3, device=cuda)
    live = table.shape[0]
    assert live > 990_000
    index = R.RankIndex(table, live)
    g = torch.Generator().manual_seed(71)
    nodes = table[torch.randint(0, live, (71_000,), generator=g).to(cuda)]
    nodes[::7] = _kmer_rows(31, len(nodes[::7]), g, cuda)
    cpu_table = table.cpu()
    cpu_index = R.RankIndex(cpu_table, live)
    N.reset_launches()
    got = N.neighbor_masks(nodes, table, live, 31, index=index)
    assert N.launches["neighbor_masks"] == 1
    want = N.neighbor_masks_plain(nodes.cpu(), cpu_table, live, 31,
                                  cpu_index)
    assert torch.equal(got.cpu(), want)
    sweep = N.neighbor_masks(table, table, live, 31, index=index)
    want = N.neighbor_masks_plain(cpu_table, cpu_table, live, 31, cpu_index)
    assert torch.equal(sweep.cpu(), want) and (want != 0).all()


def test_graph_masks_on_card_launch_one_kernel(cuda, monkeypatch):
    """adjacency_masks and the single-device adjacency sweep on the card
    equal a CPU Graph's: one neighbor_masks launch a call and one a sweep
    chunk, no rank_rows launch and no neighbor_candidates call."""
    from gatb_core_tpu_torch import Graph
    from gatb_core_tpu_torch.debruijn import graph as graph_mod
    from gatb_core_tpu_torch.ops import neighbor_ops as N

    rng = np.random.default_rng(17)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    reads = [genome[i:i + 120] for i in range(0, 5880, 7)]
    kw = dict(kmer_size=31, abundance_min=2, batch_reads=64,
              superbatch_rows=1 << 16, mphf_kind="none",
              build_branching=False)
    a = Graph.create(BankStrings(*reads), device="cuda", **kw)
    b = Graph.create(BankStrings(*reads), device="cpu", **kw)
    assert a._adjacency is None and a.nb_nodes > 3000
    absent = a.solid_limbs[:300].copy()
    absent[:, -1] ^= 1
    q = np.concatenate([a.solid_limbs[::3], absent])
    want = b.adjacency_masks(q)
    sweep_want = b.precompute_adjacency(chunk=1000)

    def no_candidates(*args, **kwargs):
        raise AssertionError("neighbor_candidates ran on the masks' path")

    monkeypatch.setattr(N, "neighbor_candidates", no_candidates)
    monkeypatch.setattr(graph_mod, "neighbor_candidates", no_candidates)
    N.reset_launches()
    R.reset_launches()
    for _ in range(3):
        assert np.array_equal(a.adjacency_masks(q), want)
    assert N.launches["neighbor_masks"] == 3
    assert (2, 31, a.nb_nodes, a.nb_nodes, len(q)) in \
        N.launch_shapes["neighbor_masks"]
    got = a.precompute_adjacency(chunk=1000)
    assert np.array_equal(got, sweep_want)
    assert N.launches["neighbor_masks"] == 3 + -(-a.nb_nodes // 1000)
    assert R.launches["rank_rows"] == 0


@pytest.mark.parametrize("k", [31, 63])
def test_graph_on_card_matches_cpu(cuda, k):
    """Bloom, debloom, adjacency and branching on the card (kernels)
    against the same build on the CPU (plain versions)."""
    from gatb_core_tpu_torch import Graph

    rng = np.random.default_rng(k)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    reads = [genome[i:i + 120] for i in range(0, 5880, 7)]
    kw = dict(kmer_size=k, abundance_min=2, batch_reads=64,
              superbatch_rows=1 << 16, mphf_kind="none")
    from gatb_core_tpu_torch.ops import neighbor_ops as N

    for name in R.launches:
        R.launches[name] = 0
    N.reset_launches()
    a = Graph.create(BankStrings(*reads), device="cuda", **kw)
    # the debloom probe's rank search, and the adjacency sweep's masks
    assert R.launches["rank_rows"] >= 1
    assert N.launches["neighbor_masks"] >= 1
    b = Graph.create(BankStrings(*reads), device="cpu", **kw)
    assert np.array_equal(a.solid_limbs, b.solid_limbs)
    assert np.array_equal(a._adjacency, b._adjacency)
    assert np.array_equal(a.branching_nodes(), b.branching_nodes())
    assert a.checksum_branching() == b.checksum_branching()
    da, db = a._debloom, b._debloom
    assert da.bloom.words.is_cuda and not db.bloom.words.is_cuda
    assert np.array_equal(da.bloom.to_numpy(), db.bloom.to_numpy())
    assert np.array_equal(da.cfp, db.cfp) and da.info == db.info
    assert np.array_equal(da.cascade.t4, db.cascade.t4)
    for x, y in zip(da.cascade.blooms, db.cascade.blooms):
        assert np.array_equal(x.to_numpy(), y.to_numpy())
    q = np.concatenate([a.solid_limbs[:500], da.cfp[:500]])
    for mode in ("exact", "bloom_cfp"):
        assert np.array_equal(a.contains(q, mode=mode),
                              b.contains(q, mode=mode))
    assert np.array_equal(a.node_index(q), b.node_index(q))
    assert np.array_equal(a.adjacency_masks(q), b.adjacency_masks(q))


def test_ascii_to_codes_on_card_matches_cpu(cuda):
    from gatb_core_tpu_torch.ops.bitpack import ascii_to_codes

    buf = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    codes, valid = ascii_to_codes(buf.to(cuda))
    assert codes.is_cuda and valid.is_cuda
    want = ascii_to_codes(buf)
    assert torch.equal(codes.cpu(), want[0])
    assert torch.equal(valid.cpu(), want[1])


@pytest.mark.parametrize("k", [31, 63])
def test_check_graph_on_card_matches_cpu(cuda, k, tmp_path):
    """dbgcheck's sums on the card, over several sweep chunks, against the
    same graph on the CPU; the topology matrix alike; the FileStorage
    blobs of the card's postsolid build byte-equal to the CPU's."""
    from gatb_core_tpu_torch import Graph
    from gatb_core_tpu_torch.ops import sortops
    from gatb_core_tpu_torch.storage.filedir import FileStorage
    from gatb_core_tpu_torch.tools.dbgcheck import check_graph
    from gatb_core_tpu_torch.tools.dbgtopology import topology_matrix

    rng = np.random.default_rng(k + 1)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    reads = [genome[i:i + 120] for i in range(0, 5880, 7)]
    reads += [r[:60] + "A" + r[61:] for r in reads[::9]]
    kw = dict(kmer_size=k, abundance_min=1, batch_reads=64,
              superbatch_rows=1 << 16, build_branching=False)
    a = Graph.create(BankStrings(*reads), device="cuda", **kw)
    b = Graph.create(BankStrings(*reads), device="cpu", **kw)
    chunk = sortops.sweep_chunk
    try:
        sortops.sweep_chunk = lambda n: 1000
        got = check_graph(a)
    finally:
        sortops.sweep_chunk = chunk
    want = check_graph(b)
    got.pop("time")
    want.pop("time")
    assert got == want and got["nbBranching"] > 2
    assert got["checksumBranching"] == b.checksum_branching()
    assert np.array_equal(topology_matrix(a), topology_matrix(b))
    folders = []
    for graph, device in ((a, "cuda"), (b, "cpu")):
        st = FileStorage(str(tmp_path / device), "w")
        g = Graph(k, graph.solid_limbs, graph.solid_counts, storage=st,
                  device=device)
        g.build_postsolid()
        folders.append(st.folder)
    names = sorted(n for n in os.listdir(folders[0]) if n.endswith(".data"))
    assert names == sorted(n for n in os.listdir(folders[1])
                           if n.endswith(".data"))
    assert "mphf.bits.data" in names and "bloom.bloom.data" in names
    for n in names:
        with open(os.path.join(folders[0], n), "rb") as f, \
                open(os.path.join(folders[1], n), "rb") as g:
            assert f.read() == g.read(), n


@pytest.mark.parametrize("k", [31, 63])
def test_mphf_and_unitigs_on_card_match_cpu(cuda, k):
    """The default-flag build (the MPHF with it) and the unitig graph on
    the card against the same on the CPU: every BooPHF array, its rank of
    every node, node_index, unitig sequences, means, node maps and
    links."""
    from gatb_core_tpu_torch import Graph
    from gatb_core_tpu_torch.convert import boophf_to_numpy, u32_to_torch

    rng = np.random.default_rng(k + 1)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    reads = [genome[i:i + 120] for i in range(0, 5880, 7)]
    reads.append(genome[100:100 + k] + "ACGTTGCA" * 6)
    kw = dict(kmer_size=k, abundance_min=2, batch_reads=64,
              superbatch_rows=1 << 16)
    a = Graph.create(BankStrings(*reads), device="cuda", **kw)
    b = Graph.create(BankStrings(*reads), device="cpu", **kw)
    assert a._mphf.bits.is_cuda and not b._mphf.bits.is_cuda
    ma, mb = boophf_to_numpy(a._mphf), boophf_to_numpy(b._mphf)
    for key in ma:
        assert np.array_equal(ma[key], mb[key]), key
    absent = a.solid_limbs.copy()
    absent[:, -1] ^= 1
    q = np.concatenate([a.solid_limbs, absent])
    R.reset_launches()
    assert np.array_equal(a.node_index(q), b.node_index(q))
    assert (a.node_index(a.solid_limbs) == np.arange(a.nb_nodes)).all()
    got = a._mphf.rank(u32_to_torch(a.solid_limbs, "cuda")).cpu().numpy()
    assert np.array_equal(got, np.arange(a.nb_nodes))
    ua, ub = a.unitig_graph(), b.unitig_graph()
    assert R.launches["rank_rows"] >= 2
    assert list(ua.sequences) == list(ub.sequences)
    assert ua.mean_abundance.tobytes() == ub.mean_abundance.tobytes()
    for f in ("kmer_counts", "link_offsets", "link_targets"):
        assert np.array_equal(getattr(ua, f), getattr(ub, f)), f
    assert a.contigs()[0] == b.contigs()[0]


def test_simplify_and_monument_on_card_match_cpu(cuda):
    """simplify() (one candidate sweep, reused by the Monument contigs),
    the unitig graph of the simplified graph, Monument contigs and an
    iterative extension on the card against the same calls on the CPU, on
    reads with 1% substitutions (tips and bulges to remove)."""
    from gatb_core_tpu_torch import Graph
    from gatb_core_tpu_torch.debruijn.iterative_extensions import \
        IterativeExtensions

    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=3000, dtype=np.uint8)
    reads = genome[rng.integers(0, 2850, size=600)[:, None] + np.arange(150)]
    hit = rng.random(reads.shape) < 0.01
    reads = np.where(hit, (reads + rng.integers(1, 4, size=reads.shape,
                                                dtype=np.uint8)) & 3, reads)
    nts = np.frombuffer(b"ACTG", np.uint8)
    seqs = [nts[r].tobytes().decode() for r in reads]
    a = Graph.create(BankStrings(*seqs), kmer_size=21, abundance_min=2,
                     batch_reads=64, superbatch_rows=1 << 16,
                     mphf_kind="none", device="cuda")
    b = Graph(21, a.solid_limbs, a.solid_counts, device="cpu")
    R.reset_launches()
    sa = a.simplify()
    assert R.launches["rank_rows"] == 1          # one sweep, one chunk
    assert vars(sa) == vars(b.simplify()) and sa.tips_removed > 0
    assert np.array_equal(a.node_state, b.node_state)
    for f in ("tip_removal", "bubble_removal", "ec_removal"):
        assert getattr(a._simplifications, f) == \
            getattr(b._simplifications, f)
    assert a._simplifications._full_ranks.is_cuda
    ca, cb = a.contigs(traversal="monument"), b.contigs(traversal="monument")
    assert R.launches["rank_rows"] == 1 and ca == cb and ca[0]
    ua, ub = a.unitig_graph(), b.unitig_graph()
    assert list(ua.sequences) == list(ub.sequences)
    assert ua.mean_abundance.tobytes() == ub.mean_abundance.tobytes()
    for f in ("kmer_counts", "link_offsets", "link_targets"):
        assert np.array_equal(getattr(ua, f), getattr(ub, f)), f
    seed = "".join("ACTG"[c] for c in genome[100:121])
    ea = IterativeExtensions(a).extend(seed)
    assert vars(ea) == vars(IterativeExtensions(b).extend(seed))
    assert ea.nb_nucleotides > 0


def _stacked_tables(nb, rows, w, cap, seed):
    """nb sorted distinct-key tables of capacity cap (int32 limb storage,
    all-ones padding with count 0) and their union's distinct count."""
    rng = np.random.default_rng(seed)
    ks = np.full((nb, cap, w), -1, np.int32)
    cs = np.zeros((nb, cap), np.int32)
    for i in range(nb):
        raw = rng.integers(0, 1 << 32, size=(rows, w), dtype=np.uint64) \
            .astype(np.uint32)
        raw[:, 0] &= 0xFF                   # overlap between the tables
        uniq, cnt = np.unique(raw, axis=0, return_counts=True)
        ks[i, :len(uniq)] = uniq.view(np.int32)
        cs[i, :len(uniq)] = cnt
    flat = ks.reshape(-1, w)[cs.reshape(-1) > 0]
    return ks, cs, len(np.unique(flat, axis=0))


@pytest.mark.parametrize("nb,w", [(8, 2), (5, 4), (16, 1)])
def test_stacked_merges_on_card_match_plain(cuda, nb, w):
    """The three stacked merges on the card (merge levels and the sort on
    the kernels) equal their runs on the CPU (the plain versions), and one
    another; the tree launches two merge kernels per level."""
    from gatb_core_tpu_torch.ops import sortops as T

    ks, cs, distinct = _stacked_tables(nb, 3000, w, 4096, nb + w)
    kc, cc = torch.from_numpy(ks).cuda(), torch.from_numpy(cs).cuda()
    kh, ch = torch.from_numpy(ks), torch.from_numpy(cs)

    def same(a, b):
        return (torch.equal(a.kmers.cpu(), b.kmers.cpu())
                and torch.equal(a.counts.cpu(), b.counts.cpu())
                and int(a.n) == int(b.n))

    S.reset_launches()
    tree = T.merge_stacked_tree(kc, cc)
    levels = (T._next_pow2(nb)).bit_length() - 1
    assert S.launches["merge_tiles"] == S.launches["merge_partition"] \
        == levels
    assert same(tree, T.merge_stacked_tree(kh, ch))
    assert int(tree.n) == distinct
    for cap, overflow in ((distinct, False), (distinct // 2, True)):
        got, ov = T.merge_stacked_tree_capped(kc, cc, cap)
        want, ov_h = T.merge_stacked_tree_capped(kh, ch, cap)
        assert bool(ov) is bool(ov_h) is overflow
        assert same(got, want)
    n = int(tree.n)
    got, _ = T.merge_stacked_tree_capped(kc, cc, distinct)
    assert torch.equal(got.kmers[:n].cpu(), tree.kmers[:n].cpu())
    S.reset_launches()
    flat = T.merge_stacked(kc, cc)
    assert S.launches["tile_sort"] == 1
    assert same(flat, T.merge_stacked(kh, ch))
    assert torch.equal(flat.kmers[:n].cpu(), tree.kmers[:n].cpu())
    assert torch.equal(flat.counts[:n].cpu(), tree.counts[:n].cpu())


def _leon_fastq(path, n_reads=300, genome_len=3000, read_len=100, seed=3):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=genome_len))
    with open(path, "w") as f:
        for i in range(n_reads):
            s = int(rng.integers(0, genome_len - read_len))
            r = list(genome[s:s + read_len])
            if i % 9 == 0:
                r[int(rng.integers(0, read_len))] = "N"
            q = "".join(chr(int(c)) for c in rng.integers(33, 74, read_len))
            f.write(f"@r{i} pos:{s}\n{''.join(r)}\n+\n{q}\n")
    return str(path)


def test_leon_on_card_matches_cpu(cuda, tmp_path):
    """The GTBL1 file of a count on the card equals the one of a count on
    the CPU, byte for byte; the reference container's contents (its Bloom
    built on the card) equal the CPU's, lossy and lossless."""
    from gatb_core_tpu_torch.compression.leon import (LeonCompressor,
                                                      LeonDecompressor)
    from gatb_core_tpu_torch.compression.leon_ref import leon_ref_contents

    src = _leon_fastq(tmp_path / "r.fq")
    S.reset_launches()
    LeonCompressor(kmer_size=21, device="cuda").compress(
        src, str(tmp_path / "card.leon"))
    assert S.launches["tile_sort"] > 0
    LeonCompressor(kmer_size=21, device="cpu").compress(
        src, str(tmp_path / "cpu.leon"))
    card = open(tmp_path / "card.leon", "rb").read()
    assert card == open(tmp_path / "cpu.leon", "rb").read()
    seqs = LeonDecompressor().decompress(str(tmp_path / "card.leon"))
    assert len(seqs) == 300
    for lossless in (False, True):
        assert leon_ref_contents(src, 21, lossless=lossless,
                                 device="cuda") == \
            leon_ref_contents(src, 21, lossless=lossless, device="cpu")


def test_linear_counter_on_card_matches_cpu(cuda, tmp_path):
    from gatb_core_tpu_torch.kmer.linear_counter import (
        LinearCounter, estimate_distinct_kmers)

    rng = np.random.default_rng(2)
    limbs = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (5000, 2),
                                          dtype=np.int64).astype(np.int32))
    valid = torch.from_numpy(rng.random(5000) < 0.9)
    a, b = LinearCounter(40009, "cuda"), LinearCounter(40009, "cpu")
    a.add(limbs.cuda(), valid.cuda())
    b.add(limbs, valid)
    assert torch.equal(a._bits.cpu(), b._bits) and a.count() == b.count()
    src = _leon_fastq(tmp_path / "r.fq")
    assert estimate_distinct_kmers(src, 31, device="cuda") == \
        estimate_distinct_kmers(src, 31, device="cpu")


# ---------------------------------------------------------------------------
# the mesh paths at world size 1 on the card (NCCL, this process)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A world of one rank over NCCL on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from gatb_core_tpu_torch.parallel.mesh import (init_process_group,
                                                   make_mesh)

    init_process_group(0, 1, str(tmp_path_factory.mktemp("nccl")
                                 / "rendezvous"), "nccl", 120)
    try:
        yield make_mesh(1, "cuda")
    finally:
        dist.destroy_process_group()


def _error_seqs(seed=5, n_reads=600):
    """150 bp reads of a 3 kbp genome with 1% substitutions."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=3000, dtype=np.uint8)
    reads = genome[rng.integers(0, 2850, size=n_reads)[:, None]
                   + np.arange(150)]
    hit = rng.random(reads.shape) < 0.01
    reads = np.where(hit, (reads + rng.integers(1, 4, size=reads.shape,
                                                dtype=np.uint8)) & 3, reads)
    nts = np.frombuffer(b"ACTG", np.uint8)
    return [nts[r].tobytes().decode() for r in reads]


def test_mesh_count_on_card_matches_cpu(mesh1):
    """count_kmers_distributed (the superbatch exchange) at one rank over
    NCCL, with a forced replay, against count_kmers on the CPU."""
    from gatb_core_tpu_torch.parallel import superbatch
    from gatb_core_tpu_torch.parallel.exchange import \
        count_kmers_distributed

    seqs = _error_seqs()
    before = superbatch.retries["superbatch"]
    S.reset_launches()
    got = count_kmers_distributed(BankStrings(*seqs), mesh1, kmer_size=31,
                                  abundance_min=2, nb_passes=2,
                                  distinct_ratio_hint=0.001,
                                  superbatch_rows=1 << 15)
    assert superbatch.retries["superbatch"] > before
    assert S.launches["tile_sort"] > 0 and S.launches["merge_tiles"] > 0
    ref = count_kmers(BankStrings(*seqs), kmer_size=31, abundance_min=2,
                      device="cpu")
    assert np.array_equal(got.solid_kmers, ref.solid_kmers)
    assert np.array_equal(got.solid_counts, ref.solid_counts)
    assert got.info["kmers_nb_valid"] == ref.info["kmers_nb_valid"]


def test_mesh_postsolid_stages_on_card_match_cpu(mesh1):
    """distributed_adjacency, the debloom probe, the candidate ranks and
    the list ranking at one rank on the card, against the single-device
    stages on the CPU."""
    from gatb_core_tpu_torch import Graph
    from gatb_core_tpu_torch.debruijn import unitigs as U
    from gatb_core_tpu_torch.parallel import postsolid as P

    res = count_kmers(BankStrings(*_error_seqs()), kmer_size=31,
                      abundance_min=2, device="cpu")
    cpu = Graph(31, res.solid_kmers, res.solid_counts, device="cpu")
    cpu.build_postsolid(mphf_kind="none")
    R.reset_launches()
    adj = P.distributed_adjacency(mesh1, res.solid_kmers, 31)
    assert R.launches["rank_rows"] > 0
    assert np.array_equal(adj, cpu.precompute_adjacency())
    bloom = cpu._debloom.bloom._replace(words=cpu._debloom.bloom.words
                                        .cuda())
    assert np.array_equal(P.distributed_debloom_probe(
        mesh1, res.solid_kmers, 31, bloom), cpu._debloom.cfp)
    ranks, flips = P.distributed_cand_ranks(mesh1, res.solid_kmers, 31)
    want_r, want_f = U.cand_sweep(cpu._padded_table(), cpu.nb_nodes, 31)
    assert torch.equal(ranks.cpu(), want_r) and torch.equal(flips.cpu(),
                                                            want_f)
    pred = U._chain_parents(want_r, want_f, torch.from_numpy(
        cpu.precompute_adjacency()), cpu.nb_nodes)
    par, cut = P.distributed_cut_cycles(mesh1, pred)
    roots, rank = P.distributed_pointer_double(mesh1, par)
    want = U._cut_cycles(pred)
    assert torch.equal(par.cpu(), want[0]) and torch.equal(cut.cpu(),
                                                           want[1])
    for a, b in zip((roots, rank), U._pointer_double(want[0])):
        assert torch.equal(a.cpu(), b)


def test_mesh_graph_on_card_matches_cpu(mesh1):
    """Graph.create(mesh=) at one rank on the card: unitigs, simplify(),
    node_state and Monument contigs equal the CPU graph's."""
    from gatb_core_tpu_torch import Graph

    seqs = _error_seqs(seed=7)
    kw = dict(kmer_size=21, abundance_min=2, batch_reads=64,
              superbatch_rows=1 << 16, mphf_kind="none")
    a = Graph.create(BankStrings(*seqs), mesh=mesh1, **kw)
    b = Graph.create(BankStrings(*seqs), device="cpu", **kw)
    assert a.device.type == "cuda" and a.mesh is mesh1
    ua, ub = a.unitig_graph(), b.unitig_graph()
    assert list(ua.sequences) == list(ub.sequences)
    sa, sb = a.simplify(), b.simplify()
    assert vars(sa) == vars(sb) and sa.tips_removed > 0
    assert np.array_equal(a.node_state, b.node_state)
    assert a.contigs(traversal="monument") == b.contigs(traversal="monument")


def _packed_reads(n_reads, L, k, seed, with_n):
    """Packed reads of a small genome, reverse complements among them,
    lengths from under k to L, scattered N bases (with_n)."""
    from gatb_core_tpu_torch.ops.bitpack import pack_batch_np

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    starts = rng.integers(0, 600 - L, n_reads)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    codes[::4] = codes[::4, ::-1] ^ 2
    lengths = rng.integers(L - 40, L + 1, n_reads).astype(np.int32)
    lengths[0] = L
    lengths[1::5] = rng.integers(0, k, len(lengths[1::5]))
    valid = np.arange(L)[None, :] < lengths[:, None]
    if with_n:
        valid &= rng.random((n_reads, L)) > 0.02
    words, vmask = pack_batch_np(codes, valid)
    return words.view(np.int32), vmask.view(np.int32), lengths


@pytest.mark.parametrize("mode", ["dense", "masked"])
@pytest.mark.parametrize("k,L", [(15, 150), (16, 151), (31, 150), (32, 151),
                                 (63, 151), (95, 150), (127, 160)])
def test_extract_planes_matches_plain(cuda, k, L, mode):
    """The extraction kernel against extract_planes_plain on the same
    tensors: one and three passes (each pass in turn), one launch a call."""
    from gatb_core_tpu_torch.ops import kmer_ops as tk

    words, vmask, lengths = _packed_reads(300, L, k, k + L, mode == "masked")
    words = torch.from_numpy(words).to(cuda)
    vmask = None if mode == "dense" else torch.from_numpy(vmask).to(cuda)
    lengths = torch.from_numpy(lengths).to(cuda)
    rows = 300 * (L - k + 1)
    cap = 1 << (rows - 1).bit_length()
    for nb_passes, pass_i in ((1, 0), (3, 0), (3, 1), (3, 2)):
        before = tk.launches["extract_planes"]
        got = tk.extract_planes(words, vmask, lengths, k, L, cap, m=10,
                                nb_passes=nb_passes, pass_i=pass_i)
        assert tk.launches["extract_planes"] == before + 1
        ref = tk.extract_planes_plain(words, vmask, lengths, k, L, cap, m=10,
                                      nb_passes=nb_passes, pass_i=pass_i)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b), (nb_passes,
                                                              pass_i)


# (P, n, n_valid, weight rows: 0 = none, 1 = (N,), 3 = multi, cap_out)
REDUCE_CASES = [
    (1, 12411, 12000, 0, None), (2, 12411, 11000, 1, None),
    (3, 8192, 8000, 0, 64), (4, 8192, 8192, 1, 1000),
    (5, 5000, 4999, 3, None), (6, 4096, 3000, 1, 100),
    (7, 9000, 8500, 3, 200), (8, 4097, 4097, 0, None),
    (9, 12411, 12000, 1, 300), (2, 4096, 0, 0, 512), (3, 4096, 0, 1, None),
    (2, 4096, 0, 3, 16), (1, 12411, 12000, 1, 7), (2, 1, 1, 0, None),
    (3, 1 << 20, (1 << 20) - 5, 1, 1 << 19), (2, 3 * 4096 + 1, 9000, 3, 4)]


@pytest.mark.parametrize("P,n,n_valid,nw,cap_out", REDUCE_CASES)
def test_run_reduce_matches_plain(cuda, P, n, n_valid, nw, cap_out):
    """The reduce kernel against count_sorted_planes[_multi]_plain: sorted
    rows with long runs (one across the kernel's 4096-row blocks), weights
    up to 2^30 (the counts wrap mod 2^32 in both), one launch a call."""
    from gatb_core_tpu_torch.ops import sortops as ts

    rng = np.random.default_rng(P * 13 + nw + n)
    rows = rng.integers(0, 40 if P == 1 else 3, (n_valid, P)).astype(
        np.uint32)
    rows[::3, 0] |= np.uint32(0x80000000)
    if n_valid > 9000:
        rows[100:5200] = rows[100]
    rows = rows[np.lexsort(rows.T[::-1])]
    planes = np.full((P, n), 0xFFFFFFFF, np.uint32)
    planes[:, :n_valid] = rows.T
    planes = torch.from_numpy(planes.view(np.int32)).to(cuda)
    inv = torch.arange(n, device=cuda) >= n_valid
    weights = torch.from_numpy(rng.integers(1, 1 << 30, (max(nw, 1), n))
                               .astype(np.int32)).to(cuda)
    before = ts.launches["run_reduce"]
    if nw == 3:
        got = ts.count_sorted_planes_multi(planes, inv, weights, cap_out)
        ref = ts.count_sorted_planes_multi_plain(planes, inv, weights,
                                                 cap_out)
    else:
        w = None if nw == 0 else weights[0]
        got = ts.count_sorted_planes(planes, inv, w, cap_out)
        ref = ts.count_sorted_planes_plain(planes, inv, w, cap_out)
    assert ts.launches["run_reduce"] == before + 1
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def test_count_launches_the_extraction_and_reduce(cuda):
    """A fold count and an LSM count on the card: one extract_planes launch
    per superbatch, the run_reduce kernel in every reduce and one
    solid_select a pass; tables equal to the CPU's."""
    from gatb_core_tpu_torch.ops import kmer_ops as tk
    from gatb_core_tpu_torch.ops import sortops as ts

    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), size=4000))
    reads = [genome[i:i + 100] for i in range(0, 3900, 3)]
    for kw in ({}, {"carry_accumulator": False, "nb_passes": 2}):
        tk.reset_launches()
        ts.reset_launches()
        SS.reset_launches()
        res = count_kmers(BankStrings(*reads), kmer_size=31, abundance_min=1,
                          superbatch_rows=1 << 14, **kw)
        assert tk.launches["extract_planes"] >= 2
        assert ts.launches["run_reduce"] >= 1
        # the processor chain: one select a pass
        assert SS.launches["solid_select"] == kw.get("nb_passes", 1)
        cpu = count_kmers(BankStrings(*reads), kmer_size=31, abundance_min=1,
                          superbatch_rows=1 << 14, device="cpu", **kw)
        assert np.array_equal(res.solid_kmers, cpu.solid_kmers)
        assert np.array_equal(res.solid_counts, cpu.solid_counts)


def _skewed_counts(n, cap, g):
    """(cap,) int32 counts of a read bank's distinct table: four in five
    rows seen once, the others spread to the coverage and past it, the
    edges (negative, 0, the fetch's 254/255, histo_max and above, the int32
    maximum) among them; 0 past n."""
    c = np.zeros(cap, np.int32)
    live = g.geometric(0.05, n).astype(np.int32) + 1
    live[g.random(n) < 0.8] = 1
    edges = np.array([-3, 0, 254, 255, 9999, 10000, 10001, 12000, 2**31 - 1],
                     np.int32)
    live[g.integers(0, n, 64)] = np.resize(edges, 64)
    c[:n] = live
    return c


# (W, live rows, capacity): the chr14 count's W at 2^24 rows, the k 63
# count's W, one tile and one row past it, a single row
SELECT_CASES = [(2, 1 << 24, 1 << 24), (4, 3_000_017, 1 << 22),
                (1, 8193, 1 << 14), (3, 1, 16)]


@pytest.mark.parametrize("w,n,cap", SELECT_CASES)
def test_solid_select_matches_plain(cuda, w, n, cap):
    """The kernel against solid_select_plain on the card, bit for bit:
    bins, rows and counts; with the histogram and a fixed cutoff, without
    it at a finite abundance max, histo_max past the shared bins, and the
    histogram alone; the launch counters move by one a call."""
    g = np.random.default_rng(w * 7 + n)
    planes = torch.from_numpy(g.integers(-2**31, 2**31, (w, cap),
                                         dtype=np.int64).astype(np.int32))
    planes = planes.to(cuda)
    counts = torch.from_numpy(_skewed_counts(n, cap, g)).to(cuda)
    for lo, hi, histo_max, with_bins in ((2, 2**31 - 1, 10000, True),
                                         (1, 20, 10000, False),
                                         (3, 2**31 - 1, 20000, True)):
        bins = torch.zeros(histo_max + 1, dtype=torch.int64, device=cuda)
        ref_bins = bins.clone()
        before = SS.launches["solid_select"]
        got = SS.solid_select(planes, counts, n, lo, hi,
                              bins if with_bins else None, histo_max)
        assert SS.launches["solid_select"] == before + 1
        assert (w, n, cap, histo_max) in SS.launch_shapes["solid_select"]
        ref = SS.solid_select_plain(planes, counts, n, lo, hi,
                                    ref_bins if with_bins else None,
                                    histo_max)
        for a, b in zip(got, ref):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)
        assert torch.equal(bins, ref_bins)
        before = SS.launches["solid_histogram"]
        SS.solid_histogram(counts, n, bins, histo_max)
        assert SS.launches["solid_histogram"] == before + 1
        SS.solid_histogram_plain(counts, n, ref_bins, histo_max)
        assert torch.equal(bins, ref_bins)

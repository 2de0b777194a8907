"""gatb_core_tpu_torch on a CUDA card: each kernel against its plain
PyTorch version (bit for bit), and a count and a graph build on the card
against the same on the CPU and the dict ground truth.

Every test here needs a card and skips without one. The file imports
neither jax nor gatb_core_tpu, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gatb_core_tpu_torch import BankStrings, count_kmers
from gatb_core_tpu_torch.kmer.model import count_kmers_py
from gatb_core_tpu_torch.ops import limb_sort as S
from gatb_core_tpu_torch.ops import rank_search as R

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
    # the three fetches of one device table agree
    n = 3000
    planes = torch.arange(2 * 4096, dtype=torch.int32,
                          device=cuda).reshape(2, 4096).contiguous()
    counts = (torch.arange(4096, dtype=torch.int32, device=cuda) % 300) + 1
    whole = tc._fetch_table_whole(planes, counts, n, 2)
    packed = tc._fetch_table(planes, counts, n, 2)
    streamed = tc._StreamedTable(planes, counts, n, 2,
                                 chunk_rows=1024).materialize()
    for got in (packed, streamed):
        assert np.array_equal(got[0], whole[0])
        assert np.array_equal(got[1], whole[1])


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("n,cap", [(0, 4), (1, 1), (1000, 1024),
                                   (70_000, 1 << 17)])
def test_rank_rows_matches_plain(cuda, w, n, cap):
    """Templated widths and the generic one (5), an empty table, a padded
    tail; queries present, absent, duplicated, the padding row, none."""
    g = torch.Generator().manual_seed(w * 1000 + n)
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
    queries = torch.randint(-2**31, 2**31 - 1, (5000, w), dtype=torch.int32,
                            generator=g)
    if live:
        queries[::2] = table[torch.randint(0, live, (2500,), generator=g)]
    queries[7] = -1
    queries[9] = 0
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
    for name in R.launches:
        R.launches[name] = 0
    a = Graph.create(BankStrings(*reads), device="cuda", **kw)
    assert R.launches["rank_rows"] >= 2
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

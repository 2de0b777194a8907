"""gatb_core_tpu_torch limb sort and merge against the JAX package.

On the CPU the wrappers run their plain PyTorch versions through the
same orchestration the CUDA kernels take on the card (sorted tiles, then
merge levels of a merge-path partition and a tile merge each). The
JAX side is the Pallas ``sort_u32_limbs`` in interpret mode and
``jax.lax.sort(num_keys=w)``; outputs are integers and must be equal.
The kernels themselves are held to these plain versions on a card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gatb_core_tpu.ops.pallas_sort import _merge_sorted_runs
from gatb_core_tpu.ops.pallas_sort import sort_u32_limbs as jax_sort
from gatb_core_tpu_torch.convert import planes_to_numpy, planes_to_torch
from gatb_core_tpu_torch.ops import limb_sort as S


def _planes(w, n, seed):
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, 4, n, dtype=np.uint32) for _ in range(w)]
    planes[0][1::5] = 0x80000000 + rng.integers(0, 3, len(planes[0][1::5]),
                                                dtype=np.uint32)
    for p in planes:                 # sentinel rows (all-ones)
        p[::9] = 0xFFFFFFFF
    return tuple(planes)


def _eq(got: torch.Tensor, exp) -> bool:
    return all(np.array_equal(a, np.asarray(b))
               for a, b in zip(planes_to_numpy(got), exp))


@pytest.mark.parametrize("w", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("n", [256, 2048])
def test_sort_matches_jax(w, n):
    planes = _planes(w, n, seed=w * 100 + n)
    jp = tuple(jnp.asarray(p) for p in planes)
    exp_lax = jax.lax.sort(jp, num_keys=w)
    exp_pallas = jax_sort(jp, tile_log2=8, interpret=True)
    got = S.sort_u32_limbs(planes_to_torch(planes), tile_log2=8)
    assert _eq(got, exp_lax) and _eq(got, exp_pallas)
    # default tile (whole array in one tile here) and the plain sort
    assert _eq(S.sort_u32_limbs(planes_to_torch(planes)), exp_lax)
    assert _eq(S.sort_u32_limbs_plain(planes_to_torch(planes)), exp_lax)


@pytest.mark.parametrize("w,n,run", [(1, 512, 64), (3, 2048, 1024),
                                     (9, 1024, 128)])
def test_merge_sorted_runs_matches_jax(w, n, run):
    planes = _planes(w, n, seed=run)
    runs = []
    for p in planes:
        runs.append(p.copy())
    # each run sorted lexicographically across the planes
    for s in range(0, n, run):
        order = np.lexsort(tuple(p[s:s + run] for p in planes[::-1]))
        for i, p in enumerate(planes):
            runs[i][s:s + run] = p[s:s + run][order]
    exp = _merge_sorted_runs(tuple(jnp.asarray(p) for p in runs), run,
                             style="reshape")
    got = S.merge_sorted_runs(planes_to_torch(runs), run, tile_log2=5)
    assert _eq(got, exp)
    got1 = S.merge_sorted_runs(planes_to_torch(runs), run)
    assert _eq(got1, exp)


def test_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        S.sort_u32_limbs(torch.zeros((2, 300), dtype=torch.int32))
    with pytest.raises(ValueError):
        S.merge_sorted_runs(torch.zeros((2, 300), dtype=torch.int32), 100)


def test_plain_twins_are_one_network():
    """The plain versions compose into the full sort: sorted tiles, then
    per level the partition and the tile merge; and one level of them is
    the merge of two sorted halves."""
    planes = planes_to_torch(_planes(3, 1024, seed=5))
    before = dict(S.launches)
    x = S.tile_sort_plain(planes, 64)
    run = 64
    while run < 1024:
        split = S.merge_partition_plain(x, run, 32)
        x = S.merge_tiles_plain(x, run, split, 32)
        run *= 2
    assert torch.equal(x, S.sort_u32_limbs_plain(planes))
    y = S.sort_u32_limbs_plain(planes[:, :512].contiguous())
    z = S.sort_u32_limbs_plain(planes[:, 512:].contiguous())
    halves = torch.cat([y, z], 1)
    kept = halves.clone()
    m = S.merge_sorted_runs(halves, 512, tile_log2=6)
    assert torch.equal(m, S.sort_u32_limbs_plain(planes))
    assert torch.equal(m, S.merge_sorted_runs_plain(halves, 512))
    assert torch.equal(halves, kept)     # a merge leaves its input alone
    assert S.launches == before      # CPU tensors launch no kernel


def _sorted_runs(w, n, run, kind, seed):
    """(w, n) uint32 planes of ascending runs of length ``run``."""
    rng = np.random.default_rng(seed)
    ones = np.uint32(0xFFFFFFFF)
    if kind == "random":
        x = rng.integers(0, 1 << 32, (w, n), dtype=np.uint64).astype(np.uint32)
    else:
        # two values per plane, the top bit set in some: heavy ties inside
        # and across the runs
        x = rng.integers(0, 2, (w, n), dtype=np.uint32)
        x[0] |= rng.integers(0, 2, n, dtype=np.uint32) << np.uint32(31)
    if kind == "sentinel_tails":         # every run ends in all-ones rows
        for s in range(0, n, run):
            x[:, s + run - rng.integers(1, run + 1):s + run] = ones
    if kind == "second_all_sentinel":    # an accumulator beside nothing
        for s in range(run, n, 2 * run):
            x[:, s:s + run] = ones
    for s in range(0, n, run):
        order = np.lexsort(tuple(x[p, s:s + run] for p in range(w - 1, -1, -1)))
        x[:, s:s + run] = x[:, s:s + run][:, order]
    return x


def _split_truth(x, run, tile):
    """The split array from a stable numpy lexsort of every pair of runs
    (stable: on a tie the first run's row comes first)."""
    w, n = x.shape
    out = []
    for pair, s in enumerate(range(0, n, 2 * run)):
        rows = x[:, s:s + 2 * run]
        order = np.lexsort(tuple(rows[p] for p in range(w - 1, -1, -1)))
        from_first = np.concatenate([[0], np.cumsum(order < run)])
        out.extend(pair * run + from_first[0:2 * run:tile])
    return np.array(out + [n // 2], dtype=np.int64)


@pytest.mark.parametrize("w", [1, 3, 9])
@pytest.mark.parametrize("n,run,tile", [(512, 64, 16), (256, 32, 32),
                                        (512, 128, 256), (64, 1, 2)])
@pytest.mark.parametrize("kind", ["random", "ties", "sentinel_tails",
                                  "second_all_sentinel"])
def test_merge_partition_plain_matches_numpy(w, n, run, tile, kind):
    x = _sorted_runs(w, n, run, kind, seed=w * 1000 + n + run)
    planes = planes_to_torch(tuple(x))
    split = S.merge_partition_plain(planes, run, tile)
    assert split.dtype == torch.int64
    assert np.array_equal(split.numpy(), _split_truth(x, run, tile))
    # the wrappers take the same plain versions on a CPU tensor
    assert torch.equal(S.merge_partition(planes, run, tile), split)
    merged = S.merge_tiles(planes, run, split, tile)
    assert torch.equal(merged, S.merge_sorted_runs_plain(planes, run))
    assert torch.equal(merged, S.merge_tiles_plain(planes, run, split, tile))


def test_merge_tile_rows_and_argument_checks():
    for w, rows in ((1, 4096), (2, 2048), (3, 2048), (5, 1024), (9, 512),
                    (64, 256), (200, 256)):
        assert S.merge_tile_rows(w) == rows
        assert S.merge_smem_bytes(w, rows) <= S.SMEM_BYTES
    with pytest.raises(ValueError):
        S.merge_tile_rows(300)
    x = torch.zeros((2, 256), dtype=torch.int32)
    split = S.merge_partition(x, 64, 32)
    with pytest.raises(ValueError):      # a tile longer than a pair of runs
        S.merge_partition(x, 8, 32)
    with pytest.raises(ValueError):      # out must be another tensor
        S.merge_tiles(x, 64, split, 32, out=x)
    with pytest.raises(ValueError):      # a split array of another tiling
        S.merge_tiles(x, 64, split[:-1].contiguous(), 32)
    with pytest.raises(TypeError):       # stop_j went with the network
        S.merge_sorted_runs(x, 64, stop_j=32)


def _kind_planes(w, n, kind, seed):
    """(w, n) uint32 rows: random, sorted, reversed, all equal, or random
    with a tail of all-ones sentinel rows."""
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return np.full((w, n), 0x80000001, dtype=np.uint32)
    x = rng.integers(0, 1 << 32, (w, n), dtype=np.uint64).astype(np.uint32)
    x[:-1] &= np.uint32(0x80000003)      # ties in all but the last plane
    if kind == "sentinel_tail":
        x[:, n - n // 3:] = 0xFFFFFFFF
    if kind in ("sorted", "reversed"):
        x = x[:, np.lexsort(tuple(x[::-1]))]
        if kind == "reversed":
            x = x[:, ::-1].copy()
    return x


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 9])
@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("kind", ["random", "sorted", "reversed", "equal",
                                  "sentinel_tail"])
def test_sort_with_tile_cap_matches_lexsort(w, n, kind):
    """``sort_u32_limbs`` at its own tile and with ``tile_log2`` as a cap
    (tiles of 2, 8 and 64 rows, the rest merge levels) against a numpy
    lexsort of the same rows. Integers: equality."""
    x = _kind_planes(w, n, kind, seed=w * 7 + n)
    exp = x[:, np.lexsort(tuple(x[::-1]))]
    for tile_log2 in (1, 3, 6, None):
        got = S.sort_u32_limbs(planes_to_torch(tuple(x)), tile_log2=tile_log2)
        assert _eq(got, exp), tile_log2


def test_sort_tile_rows_and_argument_checks():
    """The tile chooser: the largest tile where the rows live in registers,
    a smaller one for any other number of planes, always within what
    ``tile_sort`` takes; a tile beyond that is rejected."""
    for w, rows in ((1, 16384), (2, 16384), (3, 8192), (4, 8192), (5, 8192),
                    (9, 4096)):
        assert w in S.SORT_REGISTER_PLANES
        assert S.sort_tile_rows(w) == S.sort_tile_max(w) == rows
    for w, rows, most in ((6, 2048, 8192), (7, 2048, 4096), (64, 512, 512),
                          (110, 512, 512)):
        assert S.sort_tile_rows(w) == rows and S.sort_tile_max(w) == most
    for w in (1, 2, 3, 4, 5, 6, 7, 9, 64, 110):
        assert S.sort_smem_bytes(w, S.sort_tile_max(w)) <= S.SMEM_BYTES
    with pytest.raises(ValueError):      # a warp's rows of 113 planes
        S.sort_tile_max(113)
    x = torch.zeros((9, 8192), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        S.tile_sort(x, 8192)             # 9 planes take 4096 rows at most
    with pytest.raises(ValueError):
        S.tile_sort(x, 48)               # not a power of two
    assert torch.equal(S.tile_sort(x.clone(), 4096), x)
    # a tile_log2 beyond the chooser's tile is a cap, not a demand
    y = planes_to_torch(_planes(9, 8192, seed=2))
    assert torch.equal(S.sort_u32_limbs(y.clone(), tile_log2=13),
                       S.sort_u32_limbs_plain(y))


@pytest.mark.parametrize("w,n,tile", [(1, 64, 2), (2, 192, 64), (7, 96, 32),
                                      (3, 1024, 1024), (9, 6144, 2048)])
def test_tile_sort_wrapper_matches_numpy(w, n, tile):
    """``tile_sort`` on the CPU (the plain version, in place) against a
    numpy lexsort of every tile, row counts that are no power of two
    included."""
    x = _kind_planes(w, n, "random", seed=n + tile)
    exp = x.copy()
    for s in range(0, n, tile):
        order = np.lexsort(tuple(x[p, s:s + tile] for p in range(w - 1, -1, -1)))
        exp[:, s:s + tile] = x[:, s:s + tile][:, order]
    planes = planes_to_torch(tuple(x))
    out = S.tile_sort(planes, tile)
    assert out.data_ptr() == planes.data_ptr() and _eq(out, exp)

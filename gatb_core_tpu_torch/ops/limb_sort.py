"""Lexicographic sort and merge of uint32 limb planes.

Port of gatb_core_tpu/ops/pallas_sort.py. torch has no counterpart of
``jax.lax.sort(planes, num_keys=w)`` (``torch.sort`` takes one key), so on
this package's counting path the multi-plane sort and every merge of two
sorted tables are the hand-written CUDA kernels of ``csrc/limb_sort.cu``:

- ``tile_sort`` (plain version ``tile_sort_plain``) replaces
  ``_tile_sort_kernel`` (pallas_sort.py:150, via ``_pallas_tile_sweep``):
  every tile of rows sorted by one block. It is a merge sort, not the
  TPU's bitonic network: each thread sorts a few rows in registers, then
  the runs double inside the block by merge-path merges through shared
  memory;
- ``merge_partition`` (``merge_partition_plain``) replaces the cross-tile
  stages of ``_merge_sorted_runs`` (pallas_sort.py:204, jnp there): it cuts
  the merged output of every pair of runs into tiles by a binary search
  along the merge path;
- ``merge_tiles`` (``merge_tiles_plain``) replaces ``_tile_merge_kernel``
  (pallas_sort.py:181): one block merges the two input segments of one
  output tile in shared memory;
- ``bitonic_u64`` (wrapper ``bitonic_sort_u64``, plain version
  ``bitonic_sort_u64_plain``) replaces ``_bitonic_kernel``
  (pallas_sort.py:45, via ``bitonic_sort_u64`` :343): the same block merge
  sort over (hi, lo) pairs joined into 64-bit keys; above one tile the
  wrapper finishes with merge levels, so a sort is several launches where
  the JAX package's is one ``pallas_call``. Nothing on the counting path
  calls it, as in the JAX package.

Planes are one (P, N) int32 tensor holding uint32 bit patterns, plane 0
most significant; rows order as big-endian unsigned integers. N is a power
of two. Invalid rows and padding must be all-ones in every plane (the
sentinel), so they sort to the tail.

The sort tile is not the largest that fits shared memory but the largest
whose rows fit the registers of one block's threads (``sort_tile_max``):
each halving of it costs one more merge level, a trip through device
memory, which is more than the block sort's last round.
``sort_tile_rows`` holds the choice per number of planes.

The merge level is a merge-path merge, not the bitonic merge network of
the JAX package (a network stage that crosses tiles is a trip of the whole
array through device memory, and a level has log2(2 * run) stages; the TPU
takes them because it has no cheap data-dependent addressing). A level is
two launches whatever the run length and moves 2 * 4 * P * N bytes, its
bound on an H100: each row is read once and written once. The result is
the same as the network's wherever rows equal in every plane are
identical, which holds for every caller (payload planes are keys).

``tile_sort`` works in place. A merge level is out of place: it reads its
argument and returns a new tensor. ``sort_u32_limbs`` uses its argument as
one of two ping-pong buffers and returns the one that holds the result, so
callers take the return value and give up the argument. For a CUDA tensor a
wrapper launches its kernel and counts the launch in ``launches``; for a
CPU tensor it runs its plain PyTorch version, and for any other device it
raises. There is no fallback from a kernel to its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

SMEM_BYTES = 232448           # shared memory one block may use on sm_90
# tile_sort and bitonic_u64: rows a thread keeps in registers (SORT_ITEMS of
# csrc/limb_sort.cu), the numbers of planes whose rows the kernel keeps in
# registers (any other number sorts slots into shared memory) and the most
# rows of a tile for those other numbers; pairs of a bitonic_u64 tile
SORT_ITEMS = 16
SORT_REGISTER_PLANES = (1, 2, 3, 4, 5, 9)
SORT_TILE_ROWS_ANY = 2048
U64_TILE_ROWS = 16384
# merge_tiles: shared memory wanted per block, so that several blocks share
# one SM, and output rows each thread merges serially
MERGE_SMEM_BYTES = 32768
MERGE_ITEMS = 8
_BIAS = -(1 << 31)            # x ^ _BIAS orders int32 storage as uint32

# kernel launches made through the wrappers (CUDA tensors only), and the
# distinct argument shapes they launched with: (P, N, tile) for tile_sort,
# (P, N, run, tile) for the two merge kernels, (N, tile) for bitonic_u64
launches = {"tile_sort": 0, "merge_partition": 0, "merge_tiles": 0,
            "bitonic_u64": 0}
launch_shapes: dict[str, set] = {name: set() for name in launches}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        launch_shapes[name].clear()


def as_planes(planes) -> torch.Tensor:
    """(P, N) int32 planes from a (P, N) tensor (returned as is) or a
    sequence of (N,) tensors (stacked into a new tensor)."""
    if isinstance(planes, torch.Tensor):
        x = planes if planes.dim() == 2 else planes[None]
    else:
        x = torch.stack([torch.as_tensor(p) for p in planes])
    if x.dtype != torch.int32:
        raise TypeError(f"limb planes must be int32 storage, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("limb planes must be contiguous")
    return x


def _log2_exact(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what}: size must be a power of two")
    return n.bit_length() - 1


def sort_max_threads(words: int, items: int = SORT_ITEMS) -> int:
    """Threads a block of the sort kernels may have when a row takes
    ``words`` registers and a thread keeps ``items`` rows
    (``sort_max_threads`` of csrc/limb_sort.cu): rows, the serial merge's
    two heads, two rows of temporaries and about 24 registers of indexes
    within the SM's 65,536."""
    threads = 1024
    while threads * (words * (items + 4) + 24) > 65536:
        threads >>= 1
    return threads


def sort_smem_bytes(n_planes: int, tile: int,
                    items: int = SORT_ITEMS) -> int:
    """Shared memory of one ``tile_sort`` block: a block holds at least one
    warp's rows; a plane takes a word per row, one more per 32 rows (so
    that the threads' stores meet in no bank) and one at the end. For a
    number of planes outside SORT_REGISTER_PLANES: the rows unpadded, and
    one such plane of slots."""
    rows = max(tile, 32 * items)
    words = rows + rows // 32 + 1
    if n_planes in SORT_REGISTER_PLANES:
        return words * 4 * n_planes
    return (rows * n_planes + words) * 4


def sort_tile_max(n_planes: int, items: int = SORT_ITEMS) -> int:
    """Rows of the largest tile ``tile_sort`` takes: ``items`` rows for
    each thread the planes' registers allow, within one block's shared
    memory."""
    words = n_planes if n_planes in SORT_REGISTER_PLANES else 1
    tile = items * sort_max_threads(words, items)
    while tile > 2 and sort_smem_bytes(n_planes, tile, items) > SMEM_BYTES:
        tile >>= 1
    if sort_smem_bytes(n_planes, tile, items) > SMEM_BYTES:
        raise ValueError(f"tile_sort: no tile of {n_planes} planes fits "
                         "shared memory")
    return tile


def sort_tile_rows(n_planes: int) -> int:
    """Rows of the tile ``sort_u32_limbs`` hands to ``tile_sort``. Halving
    the tile adds one merge level (a trip of every row through device
    memory, 0.22 ms on 2 x 2^25 rows of an H100) and takes away the block
    sort's last round (0.15 ms there), and the block sort keeps its pace up
    to the largest tile: so the tile is ``sort_tile_max`` where the rows
    live in registers (2^14 rows for 1 and 2 planes, 2^13 for 3 to 5, 2^12
    for 9). For any other number of planes it is at most
    SORT_TILE_ROWS_ANY: the tile's rows lie in shared memory there, and
    beyond 2^11 of them too few blocks share an SM. From
    ``python -m gatb_core_tpu_torch.tools.sort_sweep``."""
    if n_planes in SORT_REGISTER_PLANES:
        return sort_tile_max(n_planes)
    return min(SORT_TILE_ROWS_ANY, sort_tile_max(n_planes))


def merge_smem_bytes(n_planes: int, tile: int) -> int:
    """Shared memory of one ``merge_tiles`` block: P planes of tile + 16
    words (the padding lets 16-byte loads keep their alignment) and a
    16-bit source slot per output row."""
    return (tile + 16) * 4 * n_planes + 2 * tile


def merge_tile_rows(n_planes: int) -> int:
    """Output rows of one ``merge_tiles`` block: the largest power of two
    whose shared memory fits MERGE_SMEM_BYTES, at least 256 rows where
    those still fit one block's shared memory."""
    t = 1 << 15
    while t > 256 and merge_smem_bytes(n_planes, t) > MERGE_SMEM_BYTES:
        t >>= 1
    if merge_smem_bytes(n_planes, t) > SMEM_BYTES:
        raise ValueError(f"merge_tiles: no tile of {n_planes} planes fits "
                         "shared memory")
    return t


# ---------------------------------------------------------------------------
# kernel launchers
# ---------------------------------------------------------------------------


def load_library(items: int = SORT_ITEMS) -> ctypes.CDLL:
    """The kernel library built for ``items`` rows per thread of the sort
    kernels, with its C signatures declared. The wrappers use the default
    build; another one is a variant for ``tools/sort_sweep.py``."""
    from ._build import load_cuda

    lib = load_cuda("limb_sort", () if items == SORT_ITEMS
                    else (f"SORT_ITEMS={items}",))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.limb_tile_sort.argtypes = [vp, ll, i, i, vp]
    lib.limb_merge_partition.argtypes = [vp, vp, ll, i, ll, ll, vp]
    lib.limb_merge_tiles.argtypes = [vp, vp, vp, ll, i, ll, i, i, vp]
    lib.limb_bitonic_u64.argtypes = [vp, vp, vp, ll, i, vp]
    lib.limb_sort_items.argtypes = []
    for fn in (lib.limb_tile_sort, lib.limb_merge_partition,
               lib.limb_merge_tiles, lib.limb_bitonic_u64,
               lib.limb_sort_items):
        fn.restype = ctypes.c_int
    if lib.limb_sort_items() != items:
        raise RuntimeError(f"limb_sort: the library was not built for "
                           f"{items} rows per thread")
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    """The wrappers' kernel library (built at the first launch, never at
    import)."""
    return load_library()


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _route(x: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU
    tensor); any other device raises."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"limb_sort: unsupported device {x.device}")


def _check_tile(n: int, tile: int, what: str) -> None:
    _log2_exact(tile, what)
    if n % tile:
        raise ValueError(f"{what}: size {n} is not a multiple of the tile")


def tile_sort(planes: torch.Tensor, tile: int) -> torch.Tensor:
    """Sort every run of ``tile`` rows ascending, in place. ``tile`` is a
    power of two up to ``sort_tile_max``."""
    x = as_planes(planes)
    P, n = x.shape
    _check_tile(n, tile, "tile_sort")
    if tile > sort_tile_max(P):
        raise ValueError(f"tile_sort: a tile of {tile} rows of {P} planes "
                         "does not fit one block")
    if tile < 2:
        return x
    if not _route(x):
        x.copy_(tile_sort_plain(x, tile))
        return x
    with torch.cuda.device(x.device):
        rc = _lib().limb_tile_sort(x.data_ptr(), n, P, tile, _stream(x))
    _check(rc, "tile_sort")
    launches["tile_sort"] += 1
    launch_shapes["tile_sort"].add((P, n, tile))
    return x


def _check_merge(x: torch.Tensor, run: int, tile: int, what: str) -> None:
    n = x.shape[1]
    _log2_exact(n, what)
    _log2_exact(run, f"{what}(run)")
    _log2_exact(tile, f"{what}(tile)")
    if 2 * run > n:
        raise ValueError(f"{what}: 2 * run exceeds the size")
    if tile > 2 * run or tile > 1 << 15:
        raise ValueError(f"{what}: the tile exceeds a pair of runs or 2^15")
    if merge_smem_bytes(x.shape[0], tile) > SMEM_BYTES:
        raise ValueError(f"{what}: the tile does not fit shared memory")


def merge_partition(planes: torch.Tensor, run: int,
                    tile: int) -> torch.Tensor:
    """Where the tiles of a merge level begin in their inputs.

    planes holds N / (2 * run) pairs of adjacent ascending runs of length
    ``run``; each pair merges into 2 * run rows, cut into output tiles of
    ``tile`` rows. Returns the (N / tile + 1,) int64 split array:
    ``split[t]`` is the number of first-run rows among the first
    ``t * tile`` rows of the merged array (pair * run of the earlier pairs
    plus those of the boundary's own pair), ties taking the first run
    first; the second-run rows before the boundary are the rest."""
    x = as_planes(planes)
    P, n = x.shape
    _check_merge(x, run, tile, "merge_partition")
    if not _route(x):
        return merge_partition_plain(x, run, tile)
    split = torch.empty((n // tile + 1,), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().limb_merge_partition(x.data_ptr(), split.data_ptr(), n, P,
                                         run, tile, _stream(x))
    _check(rc, "merge_partition")
    launches["merge_partition"] += 1
    launch_shapes["merge_partition"].add((P, n, run, tile))
    return split


def merge_tiles(planes: torch.Tensor, run: int, split: torch.Tensor,
                tile: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Merge every pair of adjacent ascending runs of length ``run`` tile
    by tile along ``split`` (see ``merge_partition``). Out of place: the
    merged rows go to ``out`` (a new tensor by default), which is returned;
    ``planes`` is left as it is."""
    x = as_planes(planes)
    P, n = x.shape
    _check_merge(x, run, tile, "merge_tiles")
    if (split.dtype != torch.int64 or split.device != x.device
            or split.shape != (n // tile + 1,) or not split.is_contiguous()):
        raise ValueError("merge_tiles: split must be the contiguous int64 "
                         "array of merge_partition on the planes' device")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()
          or out.data_ptr() == x.data_ptr()):
        raise ValueError("merge_tiles: out must be another contiguous "
                         "tensor like the planes")
    if not _route(x):
        out.copy_(merge_tiles_plain(x, run, split, tile))
        return out
    with torch.cuda.device(x.device):
        rc = _lib().limb_merge_tiles(x.data_ptr(), out.data_ptr(),
                                     split.data_ptr(), n, P, run, tile,
                                     MERGE_ITEMS, _stream(x))
    _check(rc, "merge_tiles")
    launches["merge_tiles"] += 1
    launch_shapes["merge_tiles"].add((P, n, run, tile))
    return out


def bitonic_sort_u64(hi: torch.Tensor, lo: torch.Tensor,
                     tile_log2: int | None = None):
    """Sort flat (N,) uint32 (hi, lo) pairs (int32 storage) ascending as
    unsigned 64-bit values; all-ones pairs go to the tail. N must be a
    power of two and a multiple of 128. The inputs are left as they are;
    the result is a new (2, N) tensor, returned as its two planes.

    Tiles of U64_TILE_ROWS pairs (at most 2^tile_log2 where that is given,
    at least 2) are sorted by the ``bitonic_u64`` kernel, one launch counted in
    ``launches["bitonic_u64"]``; the run then doubles with one merge level
    (``merge_partition`` + ``merge_tiles`` at two planes, counted under
    their names) at a time, as in ``sort_u32_limbs``. The JAX package sorts
    in one ``pallas_call``. On a CUDA tensor the kernels launch or raise;
    on a CPU tensor the same composition runs over the plain versions."""
    if hi.shape != lo.shape or hi.dim() != 1:
        raise ValueError("bitonic_sort_u64: hi and lo must be flat and of "
                         "one size")
    if hi.dtype != torch.int32 or lo.dtype != torch.int32:
        raise TypeError("bitonic_sort_u64: planes must be int32 storage")
    n = hi.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError("bitonic_sort_u64: size must be a power of two")
    if n % 128:
        raise ValueError("bitonic_sort_u64: size must be a multiple of 128")
    if hi.device != lo.device:
        raise ValueError("bitonic_sort_u64: hi and lo on different devices")
    tile = min(U64_TILE_ROWS, n)
    if tile_log2 is not None:
        tile = min(tile, max(2, 1 << tile_log2))
    if _route(hi):
        hi, lo = hi.contiguous(), lo.contiguous()
        x = torch.empty((2, n), dtype=torch.int32, device=hi.device)
        with torch.cuda.device(x.device):
            rc = _lib().limb_bitonic_u64(hi.data_ptr(), lo.data_ptr(),
                                         x.data_ptr(), n, tile, _stream(x))
        _check(rc, "bitonic_u64")
        launches["bitonic_u64"] += 1
        launch_shapes["bitonic_u64"].add((n, tile))
    else:
        x = tile_sort_plain(torch.stack([hi, lo]), tile)
    return tuple(_merge_levels(x, tile, tile_log2))


# ---------------------------------------------------------------------------
# the sort and the merge
# ---------------------------------------------------------------------------


def _merge_tile(n_planes: int, run: int, tile_log2: int | None) -> int:
    """Rows of a merge level's output tile: ``merge_tile_rows``, capped at
    the caller's 2^tile_log2 and at one pair of runs."""
    tile = min(merge_tile_rows(n_planes), 2 * run)
    return tile if tile_log2 is None else min(tile, 1 << tile_log2)


def _merge_levels(x: torch.Tensor, run: int,
                  tile_log2: int | None) -> torch.Tensor:
    """Ascending runs of ``run`` rows -> the whole array ascending: one
    merge level per doubling, between x and one scratch tensor of its
    size. Returns whichever of the two holds the result."""
    P, n = x.shape
    other = None
    while run < n:
        tile = _merge_tile(P, run, tile_log2)
        if other is None:
            other = torch.empty_like(x)
        merge_tiles(x, run, merge_partition(x, run, tile), tile, out=other)
        x, other = other, x
        run *= 2
    return x


def sort_u32_limbs(planes, tile_log2: int | None = None) -> torch.Tensor:
    """Sort rows ascending by their big-endian lexicographic order
    (== integer order of the concatenated value).

    N must be a power of two. Tiles of ``sort_tile_rows`` rows (at most
    2^tile_log2 where that is given) are sorted by ``tile_sort``; the run
    then doubles with one merge level (``merge_partition`` +
    ``merge_tiles``) at a time, between the argument and one scratch tensor
    of its size: 1 + 2 * (log2 N - log2 tile) launches. Returns whichever
    of the two holds the sorted rows: take the return value, the argument's
    contents are given up. A given ``tile_log2`` also caps the merge
    levels' output tile.
    """
    x = as_planes(planes)
    P, n = x.shape
    _log2_exact(n, "sort_u32_limbs")
    tile = min(sort_tile_rows(P), n)
    if tile_log2 is not None:
        tile = min(tile, 1 << tile_log2)
    tile_sort(x, tile)
    return _merge_levels(x, tile, tile_log2)


def merge_sorted_runs(planes, run: int,
                      tile_log2: int | None = None) -> torch.Tensor:
    """One merge level: pairs of adjacent ascending runs of length ``run``
    -> ascending runs of 2 * run, in a new tensor (the argument is left as
    it is). Two launches, ``merge_partition`` and ``merge_tiles``, whatever
    ``run`` is. Equals the JAX ``_merge_sorted_runs`` wherever rows equal
    in every plane are identical."""
    x = as_planes(planes)
    tile = _merge_tile(x.shape[0], run, tile_log2)
    return merge_tiles(x, run, merge_partition(x, run, tile), tile)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU tensors and tests, and the reference the
# kernels are held to on the card); each returns a new tensor
# ---------------------------------------------------------------------------


def _lex_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a < b over the leading plane axis (uint32 order)."""
    lt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[1:], dtype=torch.bool, device=a.device)
    for p in range(a.shape[0]):
        ap, bp = a[p] ^ _BIAS, b[p] ^ _BIAS
        lt = lt | (eq & (ap < bp))
        eq = eq & (ap == bp)
    return lt


def tile_sort_plain(planes: torch.Tensor, tile: int) -> torch.Tensor:
    """Every run of ``tile`` rows sorted: stable ``torch.sort`` passes from
    the least significant plane up, one gather per plane."""
    x = as_planes(planes)
    P, n = x.shape
    v = x.reshape(P, n // tile, tile)
    perm = torch.arange(tile, device=x.device).expand(n // tile, tile)
    for p in range(P - 1, -1, -1):
        key = torch.gather(v[p] ^ _BIAS, 1, perm)
        _, idx = torch.sort(key, dim=1, stable=True)
        perm = torch.gather(perm, 1, idx)
    return torch.gather(v, 2, perm.expand(P, -1, -1)).reshape(P, n)


def sort_u32_limbs_plain(planes) -> torch.Tensor:
    """Full lexicographic sort of the rows (see tile_sort_plain)."""
    x = as_planes(planes)
    return tile_sort_plain(x, x.shape[1])


def bitonic_sort_u64_plain(hi: torch.Tensor, lo: torch.Tensor):
    """Plain version of ``bitonic_sort_u64`` on any device: one
    ``torch.sort`` of the pairs joined into int64 keys (top bit flipped, so
    the signed order is the unsigned one)."""
    top = torch.iinfo(torch.int64).min
    m32 = 0xFFFFFFFF
    key = (((hi.to(torch.int64) & m32) << 32) | (lo.to(torch.int64) & m32)) \
        ^ top
    key = torch.sort(key).values ^ top
    return (key >> 32).to(torch.int32), key.to(torch.int32)


def merge_partition_plain(planes: torch.Tensor, run: int,
                          tile: int) -> torch.Tensor:
    """Plain version of ``merge_partition``: the same binary search along
    each boundary's merge-path diagonal, all boundaries at once."""
    x = as_planes(planes)
    P, n = x.shape
    dev = x.device
    g = torch.arange(n // tile, dtype=torch.int64, device=dev) * tile
    pair = g // (2 * run)
    first = pair * (2 * run)
    d = g - first
    lo = torch.clamp(d - run, min=0)
    hi = torch.clamp(d, max=run)
    for _ in range(run.bit_length()):
        open_ = lo < hi
        mid = (lo + hi) // 2
        # first-run row mid lies before the boundary iff second-run row
        # d - mid - 1 is not smaller (ties take the first run first)
        a = x[:, torch.where(open_, first + mid, first)]
        b = x[:, torch.where(open_, first + run + d - mid - 1, first)]
        take = open_ & ~_lex_lt(b, a)
        lo = torch.where(take, mid + 1, lo)
        hi = torch.where(open_ & ~take, mid, hi)
    end = torch.full((1,), n // 2, dtype=torch.int64, device=dev)
    return torch.cat([pair * run + lo, end])


def merge_tiles_plain(planes: torch.Tensor, run: int, split: torch.Tensor,
                      tile: int) -> torch.Tensor:
    """Plain version of ``merge_tiles``: every output tile's two input
    segments gathered side by side and sorted by the plain lexicographic
    sort (a merge of sorted runs equals their sort)."""
    x = as_planes(planes)
    P, n = x.shape
    dev = x.device
    g = torch.arange(n // tile, dtype=torch.int64, device=dev) * tile
    pair = g // (2 * run)
    first = pair * (2 * run)
    a0 = split[:-1] - pair * run            # first-run rows before the tile
    na = split[1:] - split[:-1]             # first-run rows inside it
    b0 = g - first - a0
    i = torch.arange(tile, dtype=torch.int64, device=dev)[None, :]
    from_a = (first + a0)[:, None] + i
    from_b = (first + run + b0 - na)[:, None] + i
    src = torch.where(i < na[:, None], from_a, from_b).reshape(-1)
    return tile_sort_plain(x[:, src], tile)


def merge_sorted_runs_plain(planes: torch.Tensor, run: int) -> torch.Tensor:
    """Every pair of adjacent runs sorted by the plain lexicographic sort."""
    return tile_sort_plain(as_planes(planes), 2 * run)

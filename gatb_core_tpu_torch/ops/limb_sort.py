"""Lexicographic sort and merge of uint32 limb planes (bitonic network).

Port of gatb_core_tpu/ops/pallas_sort.py. torch has no counterpart of
``jax.lax.sort(planes, num_keys=w)`` (``torch.sort`` takes one key), so on
this package's counting path the multi-plane sort and the fold's merge
level are the hand-written CUDA kernels of ``csrc/limb_sort.cu``:

- ``tile_sort`` (plain twin ``tile_sort_plain``) replaces
  ``_tile_sort_kernel`` (pallas_sort.py:150, via ``_pallas_tile_sweep``);
- ``tile_merge`` (``tile_merge_plain``) replaces ``_tile_merge_kernel``
  (pallas_sort.py:181);
- ``merge_stage`` (``merge_stage_plain``) replaces the cross-tile stages of
  ``_merge_sorted_runs`` (pallas_sort.py:204, jnp there);
- ``bitonic_u64`` (wrapper ``bitonic_sort_u64``, plain twin
  ``bitonic_sort_u64_plain``) replaces ``_bitonic_kernel``
  (pallas_sort.py:45, via ``bitonic_sort_u64`` :343): the whole network
  over (hi, lo) pairs in one launch. Nothing on the counting path calls it,
  as in the JAX package.

Planes are one (P, N) int32 tensor holding uint32 bit patterns, plane 0
most significant; rows order as big-endian unsigned integers. N is a power
of two. Invalid rows and padding must be all-ones in every plane (the
sentinel), so they sort to the tail.

Each wrapper works IN PLACE on its (P, N) argument (the JAX functions are
pure; the port reuses the buffer instead of allocating a copy per stage).
For a CUDA tensor it launches its kernel and counts the launch in
``launches``; for a CPU tensor it runs its plain PyTorch twin, and for any
other device it raises. There is no fallback from the kernel to the twin.

Bounds on an H100 (see the note at the top of limb_sort.cu): a stage in
device memory moves 2 * 4 * P * N bytes; tile_sort/tile_merge keep every
stage below the tile in shared memory, so a merge level costs one
merge_stage launch per cross-tile stage plus one tile_merge sweep.
"""

from __future__ import annotations

import ctypes
import functools

import torch

SMEM_BYTES = 232448           # shared memory one block may use on sm_90
_BIAS = -(1 << 31)            # x ^ _BIAS orders int32 storage as uint32

# kernel launches made through the wrappers (CUDA tensors only), and the
# distinct argument shapes they launched with: (P, N, tile) for the tile
# kernels, (P, N, run, j) for merge_stage, (N,) for bitonic_u64
launches = {"tile_sort": 0, "tile_merge": 0, "merge_stage": 0,
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


def tile_log2_for(n_planes: int, n: int) -> int:
    """Largest tile (log2) whose P planes fit one block's shared memory,
    capped at the array size."""
    t = 1
    while (2 << t) * 4 * n_planes <= SMEM_BYTES:
        t += 1
    return min(t, n.bit_length() - 1)


# ---------------------------------------------------------------------------
# kernel launchers
# ---------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built at
    the first launch, never at import)."""
    from ._build import load_cuda

    lib = load_cuda("limb_sort")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.limb_tile_sort.argtypes = [vp, ll, i, i, vp]
    lib.limb_tile_merge.argtypes = [vp, ll, i, i, vp]
    lib.limb_merge_stage.argtypes = [vp, ll, i, ll, ll, vp]
    lib.limb_bitonic_u64.argtypes = [vp, vp, ll, vp]
    for fn in (lib.limb_tile_sort, lib.limb_tile_merge, lib.limb_merge_stage,
               lib.limb_bitonic_u64):
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _route(x: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain twin (CPU
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
    """Sort every run of ``tile`` rows ascending, in place."""
    x = as_planes(planes)
    P, n = x.shape
    _check_tile(n, tile, "tile_sort")
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


def tile_merge(planes: torch.Tensor, tile: int) -> torch.Tensor:
    """Stages j = tile/2 .. 1 (ascending) of a merge level inside every
    tile, in place."""
    x = as_planes(planes)
    P, n = x.shape
    _check_tile(n, tile, "tile_merge")
    if tile < 2:
        return x
    if not _route(x):
        x.copy_(tile_merge_plain(x, tile))
        return x
    with torch.cuda.device(x.device):
        rc = _lib().limb_tile_merge(x.data_ptr(), n, P, tile, _stream(x))
    _check(rc, "tile_merge")
    launches["tile_merge"] += 1
    launch_shapes["tile_merge"].add((P, n, tile))
    return x


def merge_stage(planes: torch.Tensor, run: int, j: int) -> torch.Tensor:
    """Stage ``j`` of the merge level of ascending runs of length ``run``,
    in place (j == run: the flip stage)."""
    x = as_planes(planes)
    P, n = x.shape
    _log2_exact(run, "merge_stage(run)")
    _log2_exact(j, "merge_stage(j)")
    if j > run or n % (2 * run):
        raise ValueError("merge_stage: needs j <= run and runs pairing up")
    if not _route(x):
        x.copy_(merge_stage_plain(x, run, j))
        return x
    with torch.cuda.device(x.device):
        rc = _lib().limb_merge_stage(x.data_ptr(), n, P, run, j, _stream(x))
    _check(rc, "merge_stage")
    launches["merge_stage"] += 1
    launch_shapes["merge_stage"].add((P, n, run, j))
    return x


def bitonic_sort_u64(hi: torch.Tensor, lo: torch.Tensor):
    """Sort flat (N,) uint32 (hi, lo) pairs (int32 storage) ascending as
    unsigned 64-bit values; all-ones pairs go to the tail. N must be a
    power of two and a multiple of 128. Returns new (hi, lo) tensors.

    On a CUDA tensor this is one launch of the ``bitonic_u64`` kernel (it
    raises if the kernel cannot be built or launched); on a CPU tensor the
    plain twin."""
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
    if not _route(hi):
        return bitonic_sort_u64_plain(hi, lo)
    oh, ol = hi.contiguous().clone(), lo.contiguous().clone()
    with torch.cuda.device(oh.device):
        rc = _lib().limb_bitonic_u64(oh.data_ptr(), ol.data_ptr(), n,
                                     _stream(oh))
    _check(rc, "bitonic_u64")
    launches["bitonic_u64"] += 1
    launch_shapes["bitonic_u64"].add((n,))
    return oh, ol


# ---------------------------------------------------------------------------
# the sort and the merge
# ---------------------------------------------------------------------------


def sort_u32_limbs(planes, tile_log2: int | None = None) -> torch.Tensor:
    """Sort rows ascending by their big-endian lexicographic order
    (== integer order of the concatenated value).

    N must be a power of two. Tiles of 2^tile_log2 rows (default: the
    largest that fits shared memory) are sorted by ``tile_sort``; each
    further merge level runs its cross-tile stages j = run .. tile with
    ``merge_stage`` and its intra-tile stages with one ``tile_merge``.
    A (P, N) tensor is sorted in place and returned.
    """
    x = as_planes(planes)
    P, n = x.shape
    _log2_exact(n, "sort_u32_limbs")
    t = tile_log2_for(P, n) if tile_log2 is None else tile_log2
    tile = min(1 << t, n)
    tile_sort(x, tile)
    run = tile
    while run < n:
        _merge_level(x, run, tile, stop_j=1)
        run *= 2
    return x


def _merge_level(x: torch.Tensor, run: int, tile: int, stop_j: int) -> None:
    j = run
    while j >= max(stop_j, tile):
        merge_stage(x, run, j)
        j //= 2
    if stop_j < tile:
        tile_merge(x, tile)


def merge_sorted_runs(planes, run: int, stop_j: int = 1,
                      tile_log2: int | None = None) -> torch.Tensor:
    """Bitonic merge level: pairs of adjacent ascending runs of length
    ``run`` -> ascending runs of 2*run, in place.

    Stages j = run .. stop_j run; stop_j must be 1 (complete merge) or at
    least the tile, since the stages below the tile run fused in one
    ``tile_merge``. With stop_j == 1 the result equals the JAX
    ``_merge_sorted_runs``. A partial merge (stop_j > 1) leaves a different
    but equally valid intermediate layout: the first stage here is the
    flip comparator, where the JAX version reverses the second run.
    """
    x = as_planes(planes)
    P, n = x.shape
    _log2_exact(n, "merge_sorted_runs")
    _log2_exact(run, "merge_sorted_runs(run)")
    if 2 * run > n:
        raise ValueError("merge_sorted_runs: 2 * run exceeds the size")
    t = tile_log2_for(P, n) if tile_log2 is None else tile_log2
    tile = min(1 << t, run)
    if 1 < stop_j < tile:
        raise ValueError("merge_sorted_runs: stop_j must be 1 or >= tile")
    _merge_level(x, run, tile, stop_j)
    return x


# ---------------------------------------------------------------------------
# plain PyTorch twins (CPU tests, and the reference the kernels are held
# to on the card); each returns a new tensor
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


def _compare_exchange(v: torch.Tensor, flip: bool) -> None:
    """v: (P, blocks, 2, h) view; min to [:, :, 0], max to [:, :, 1]
    (the second half mirrored when ``flip``)."""
    a = v[:, :, 0]
    b = v[:, :, 1].flip(-1) if flip else v[:, :, 1]
    sw = _lex_lt(b, a)
    lo = torch.where(sw, b, a)
    hi = torch.where(sw, a, b)
    v[:, :, 0] = lo
    v[:, :, 1] = hi.flip(-1) if flip else hi


def merge_stage_plain(planes: torch.Tensor, run: int, j: int) -> torch.Tensor:
    x = as_planes(planes).clone()
    P, n = x.shape
    h = run if j == run else j
    _compare_exchange(x.view(P, n // (2 * h), 2, h), flip=j == run)
    return x


def tile_merge_plain(planes: torch.Tensor, tile: int) -> torch.Tensor:
    x = as_planes(planes).clone()
    P, n = x.shape
    j = tile // 2
    while j >= 1:
        _compare_exchange(x.view(P, n // (2 * j), 2, j), flip=False)
        j //= 2
    return x

"""The count's default processor chain on the device: the abundance
histogram and the select of the solid rows of a pass's distinct table.

No JAX counterpart: the JAX package (and the port until this kernel) ran
the chain histogram -> solidity -> collect of ``kmer/count_processor.py``
in numpy over every distinct row, after the whole table came to the host.
Here, on a CUDA tensor, the hand-written kernel of
``csrc/solid_select.cu`` (three launches a call, counted once in
``launches["solid_select"]``) adds the pass's counts into the histogram's
bins and compacts the rows with ``lo <= count <= hi``, in table order, so
that only they and the bins come to the host. ``solid_histogram`` is its
first launch alone (the histogram an ``abundance_min="auto"`` cutoff is
computed from before the select). On a CPU tensor the plain versions
(``solid_select_plain``, ``solid_histogram_plain``) do the same in torch
ops; any other device raises.

The table is as a pass leaves it: (W, C) int32 planes of uint32 limbs
(plane 0 most significant), rows 0..n-1 live and sorted, and (C,) int32
counts. The bins are a (histo_max + 1,) int64 tensor on the same device,
read as uint64 (``Histogram.bins``): bin i counts the live rows whose
count clamped to [0, histo_max] is i, as ``Histogram.add_counts``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

I32 = torch.int32

# calls of each kernel (CUDA tensors only) and the distinct (W, rows,
# capacity, histo_max) they launched with (W 0 for the histogram alone)
launches = {"solid_select": 0, "solid_histogram": 0}
launch_shapes: dict[str, set] = {"solid_select": set(),
                                 "solid_histogram": set()}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        launch_shapes[name].clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at the first launch, never at import)."""
    from ._build import load_cuda

    lib = load_cuda("solid_select")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.solid_select_count.argtypes = [vp, ll, i, i, i, vp, vp, ll, vp, vp]
    lib.solid_select_count.restype = ctypes.c_int
    lib.solid_select_scatter.argtypes = [vp, i, ll, vp, ll, i, i, vp, vp, vp,
                                         vp]
    lib.solid_select_scatter.restype = ctypes.c_int
    lib.solid_select_tile.argtypes = []
    lib.solid_select_tile.restype = ctypes.c_int
    return lib


def _check(planes, counts, n: int, bins, histo_max: int) -> None:
    if counts.dim() != 1 or counts.dtype != I32:
        raise ValueError("solid_select: counts must be (C,) int32")
    if not 0 <= n <= counts.shape[0]:
        raise ValueError(f"solid_select: {n} live rows of "
                         f"{counts.shape[0]}")
    if planes is not None and (planes.dim() != 2 or planes.dtype != I32
                               or planes.shape[1] != counts.shape[0]
                               or planes.device != counts.device):
        raise ValueError("solid_select: planes must be (W, C) int32 beside "
                         "the counts")
    if bins is not None and (bins.shape != (histo_max + 1,)
                             or bins.dtype != torch.int64
                             or bins.device != counts.device):
        raise ValueError("solid_select: bins must be (histo_max + 1,) "
                         "int64 beside the counts")


def _bounds(lo: int, hi: int) -> tuple[int, int]:
    """[lo, hi] cut to the int32 range, which holds every count."""
    return max(int(lo), -2**31), min(int(hi), 2**31 - 1)


def solid_histogram_plain(counts: torch.Tensor, n: int, bins: torch.Tensor,
                          histo_max: int) -> None:
    """Plain version of ``solid_histogram``: adds the histogram of the
    first n counts, clamped to [0, histo_max], into ``bins``."""
    n = int(n)
    _check(None, counts, n, bins, histo_max)
    bins += torch.bincount(counts[:n].clamp(0, histo_max),
                           minlength=histo_max + 1)


def solid_select_plain(planes: torch.Tensor, counts: torch.Tensor, n: int,
                       lo: int, hi: int, bins: torch.Tensor | None = None,
                       histo_max: int = 10000):
    """Plain version of ``solid_select``, torch ops on any device."""
    n = int(n)
    _check(planes, counts, n, bins, histo_max)
    if bins is not None:
        solid_histogram_plain(counts, n, bins, histo_max)
    lo, hi = _bounds(lo, hi)
    c = counts[:n]
    keep = (c >= lo) & (c <= hi)
    return planes[:, :n].T[keep].contiguous(), c[keep]


def _kernel_args(planes, counts):
    """(planes, plane stride, counts) as the kernel reads them: planes with
    unit row stride, counts contiguous and 16-byte aligned."""
    counts = counts.contiguous()
    if counts.data_ptr() % 16:
        counts = counts.clone()
    if planes is not None and planes.stride(1) != 1:
        planes = planes.contiguous()
    return planes, (planes.stride(0) if planes is not None else 0), counts


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _device_of(counts: torch.Tensor) -> str:
    if counts.device.type == "cpu":
        return "cpu"
    if not counts.is_cuda:
        raise ValueError(f"solid_select: unsupported device {counts.device}")
    return "cuda"


def solid_histogram(counts: torch.Tensor, n: int, bins: torch.Tensor,
                    histo_max: int) -> None:
    """Adds the histogram of the first n counts, each clamped to [0,
    histo_max], into ``bins`` ((histo_max + 1,) int64). A CUDA tensor
    launches the kernel's first launch alone on the current stream, a CPU
    tensor runs ``solid_histogram_plain``."""
    n = int(n)
    if _device_of(counts) == "cpu":
        return solid_histogram_plain(counts, n, bins, histo_max)
    _check(None, counts, n, bins, histo_max)
    if n == 0:
        return
    _, _, counts = _kernel_args(None, counts)
    with torch.cuda.device(counts.device):
        rc = _lib().solid_select_count(
            counts.data_ptr(), n, 0, 0, histo_max, bins.data_ptr(), None, 0,
            None, _stream(counts.device))
    if rc != 0:
        raise RuntimeError(f"solid_histogram: CUDA launch failed with error "
                           f"{rc}")
    launches["solid_histogram"] += 1
    launch_shapes["solid_histogram"].add((0, n, counts.shape[0], histo_max))


def solid_select(planes: torch.Tensor, counts: torch.Tensor, n: int,
                 lo: int, hi: int, bins: torch.Tensor | None = None,
                 histo_max: int = 10000):
    """The solid rows of a sorted distinct table, and its histogram.

    planes: (W, C) int32, counts: (C,) int32, rows 0..n-1 live. With
    ``bins`` ((histo_max + 1,) int64), the histogram of the live counts
    is added into it, as ``solid_histogram``. Returns (rows (n_solid, W)
    int32, counts (n_solid,) int32) of the live rows with lo <= count <=
    hi, in table order. A CUDA tensor launches the kernel on the current
    stream and reads n_solid once, to allocate the outputs at their size;
    a CPU tensor runs ``solid_select_plain``."""
    n = int(n)
    if _device_of(counts) == "cpu":
        return solid_select_plain(planes, counts, n, lo, hi, bins, histo_max)
    _check(planes, counts, n, bins, histo_max)
    dev = counts.device
    w = planes.shape[0]
    if n == 0:
        return (torch.empty((0, w), dtype=I32, device=dev),
                torch.empty((0,), dtype=I32, device=dev))
    lo, hi = _bounds(lo, hi)
    planes, stride, counts = _kernel_args(planes, counts)
    lib = _lib()
    tiles = torch.empty((-(-n // lib.solid_select_tile()),), dtype=I32,
                        device=dev)
    n_solid = torch.empty((), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.solid_select_count(
            counts.data_ptr(), n, lo, hi, histo_max,
            None if bins is None else bins.data_ptr(), tiles.data_ptr(),
            tiles.numel(), n_solid.data_ptr(), _stream(dev))
        if rc == 0:
            m = int(n_solid)
            rows = torch.empty((m, w), dtype=I32, device=dev)
            out_counts = torch.empty((m,), dtype=I32, device=dev)
            if m:
                rc = lib.solid_select_scatter(
                    planes.data_ptr(), w, stride, counts.data_ptr(), n, lo,
                    hi, tiles.data_ptr(), rows.data_ptr(),
                    out_counts.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"solid_select: CUDA launch failed with error "
                           f"{rc}")
    launches["solid_select"] += 1
    launch_shapes["solid_select"].add((w, n, counts.shape[0], histo_max))
    return rows, out_counts

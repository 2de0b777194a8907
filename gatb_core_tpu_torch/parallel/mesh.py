"""Process-group meshes over torch.distributed.

Port of gatb_core_tpu/parallel/mesh.py. The JAX package runs its mesh
paths on one controller: a ``jax.sharding.Mesh`` names the devices, and a
sharded function takes the whole bank or table and returns global arrays.
Here every rank is a process that calls the same function with the same
arguments and returns the same global result (SPMD). A ``Mesh`` is this
rank's view of an initialised process group, laid out as named axes: its
``rank``, its ``device`` and one group per axis, with the four collectives
the mesh paths use (a fixed-window all-to-all, ``all_gather``, a sum and a
max all-reduce). Every collective is called by every rank of its group in
the same order; a host branch that follows one rank's data reads a reduced
flag first, so a rank with an empty shard never waits alone.

``make_mesh2d(nb_hosts, chips_per_host)`` lays rank ``h * chips + c`` at
(host h, chip c), as JAX's device order groups a host's chips; the counting
exchange rides the ``chip`` axis and the pass-end merge the ``host`` axis.

The backend is the caller's choice, given where the group is initialised
(``init_process_group``): NCCL when each rank has a card of its own, gloo on
the CPU. Nothing switches from one to the other. NCCL needs a card per rank,
so a world larger than the number of cards raises. Gloo moves host tensors:
with ranks on a CUDA device it stages each collective's tensors through the
host by design (``Mesh.staged``), which is how two ranks share one card.

``RankPool`` spawns n ranks, joins them in one group and runs functions on
all of them; the dry run, the tests and ``chip_smoke.py`` use it.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

DATA_AXIS = "d"
# 2-D topology: the counting exchange's all-to-all rides the intra-host
# axis; cross-host reduces (the pass-table merge) ride the host axis
HOST_AXIS = "host"
CHIP_AXIS = "chip"


def init_process_group(rank: int, world_size: int, init_file: str,
                       backend: str, timeout: float = 120.0) -> None:
    """Join this process to a group of ``world_size`` ranks that meet
    through ``init_file`` (a ``file://`` rendezvous: no port to collide
    on). Every collective of the group gives up after ``timeout``
    seconds."""
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))


def _rank_device(device) -> torch.device:
    """``"cuda"`` -> this rank's card, ``cuda:{rank % count}``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device")
    if dist.get_backend() == "nccl" and dist.get_world_size() > count:
        raise RuntimeError(
            f"make_mesh: NCCL takes one card per rank; {count} card(s) "
            f"for {dist.get_world_size()} ranks")
    if dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % count)
    torch.cuda.set_device(dev)
    return dev


class Mesh:
    """This rank's view of the process group as named axes.

    ``shape`` maps each axis name to its size, ``coords`` to this rank's
    index along it. Rank order is row-major over ``axis_names``."""

    def __init__(self, axis_names, sizes, groups: dict, device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = dist.get_backend()
        self.device = device
        # gloo collectives take host tensors
        self.staged = self.backend == "gloo" and device.type != "cpu"
        self._groups = groups
        self.coords = {}
        rest = self.rank
        for name in reversed(self.axis_names):
            self.coords[name] = rest % self.shape[name]
            rest //= self.shape[name]

    def _group(self, axes):
        if axes is None or (not isinstance(axes, str)
                            and len(axes) == len(self.axis_names)):
            return None           # the whole world
        if not isinstance(axes, str):
            (axes,) = axes
        return self._groups[axes]

    def _size(self, axes) -> int:
        g = self._group(axes)
        return self.size if g is None else dist.get_world_size(g)

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self.staged else x

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self.staged else x

    def all_to_all(self, x: torch.Tensor, axis: str = DATA_AXIS):
        """Fixed windows: x is (n, ...) with n the axis size; row s of the
        result is row ``coords[axis]`` of what rank s of the axis sent
        (``jax.lax.all_to_all(x, axis, 0, 0)``)."""
        src = self._out(x.contiguous())
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self._group(axis))
        return self._back(out)

    def all_gather(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """(n, *x.shape): every rank's x along ``axes`` (default: all
        ranks) in axis order."""
        src = self._out(x.contiguous())
        parts = [torch.empty_like(src) for _ in range(self._size(axes))]
        dist.all_gather(parts, src, group=self._group(axes))
        return self._back(torch.stack(parts))

    def _reduce(self, x: torch.Tensor, op, axes) -> torch.Tensor:
        buf = self._out(x.clone())
        dist.all_reduce(buf, op=op, group=self._group(axes))
        return self._back(buf)

    def psum(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """Sum over ``axes`` (default: all ranks)."""
        return self._reduce(x, dist.ReduceOp.SUM, axes)

    def pmax(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """Maximum over ``axes``; an or on 0/1 flags."""
        return self._reduce(x, dist.ReduceOp.MAX, axes)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """1-D mesh over the initialised group (axis ``"d"``): rank d is JAX's
    device d. ``n_devices``, where given, must be the world size."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"need {n_devices} ranks, the group has {world}")
    return Mesh((DATA_AXIS,), (world,), {DATA_AXIS: None},
                _rank_device(device))


def make_mesh2d(nb_hosts: int, chips_per_host: int, device="cuda") -> Mesh:
    """(host, chip) mesh: rank h * chips_per_host + c is chip c of host h.
    Every rank creates every axis group, in the same order."""
    need = nb_hosts * chips_per_host
    if dist.get_world_size() != need:
        raise ValueError(f"need {need} ranks, the group has "
                         f"{dist.get_world_size()}")
    groups = {}
    rank = dist.get_rank()
    for h in range(nb_hosts):
        g = dist.new_group([h * chips_per_host + c
                            for c in range(chips_per_host)])
        if rank // chips_per_host == h:
            groups[CHIP_AXIS] = g
    for c in range(chips_per_host):
        g = dist.new_group([h * chips_per_host + c
                            for h in range(nb_hosts)])
        if rank % chips_per_host == c:
            groups[HOST_AXIS] = g
    return Mesh((HOST_AXIS, CHIP_AXIS), (nb_hosts, chips_per_host), groups,
                _rank_device(device))


def data_sharding(mesh: Mesh, n_rows: int) -> slice:
    """The rows of a global batch of ``n_rows`` that are this rank's: the
    contiguous slice JAX's ``P(DATA_AXIS)`` (2-D: ``P((host, chip))``)
    gives its device of the same index."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not split over {mesh.size} "
                         "ranks")
    per = n_rows // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated(mesh: Mesh, n_rows: int) -> slice:
    """Every row of a replicated array is every rank's."""
    return slice(0, n_rows)


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, world, init_file, backend, device, timeout, threads,
               tasks, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_process_group(rank, world, init_file, backend, timeout)
        mesh = make_mesh(world, device)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(mesh, *args)))
            except Exception:
                # the boundary of a worker: report, then take the next task
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``n`` spawned ranks in one process group (a ``file://`` rendezvous
    in a temporary directory), each holding ``make_mesh(n, device)``.
    ``run(fn, *args)`` calls ``fn(mesh, *args)`` on every rank and returns
    the n results in rank order; ``fn`` must be importable by name and
    return picklable values (numpy, not tensors). A rank that raises makes
    ``run`` raise with its traceback. ``close`` stops every rank. On the
    CPU each rank runs ``cpu_count // n`` torch threads."""

    def __init__(self, n: int, device="cuda", backend: str | None = None,
                 timeout: float = 120.0):
        import multiprocessing as mp

        if backend is None:
            backend = "gloo" if torch.device(device).type == "cpu" \
                else "nccl"
        self.n = n
        self.timeout = timeout
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="gatb_ranks_")
        init_file = os.path.join(self._dir, "rendezvous")
        threads = max(1, (os.cpu_count() or 1) // n) \
            if torch.device(device).type == "cpu" else 0
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, args=(r, n, init_file, backend, device,
                                     timeout, threads, self._tasks[r],
                                     self._results), daemon=True)
            for r in range(n)]
        try:
            for p in self._procs:
                p.start()
            self._collect()
        except BaseException:
            self.close()
            raise

    def _collect(self) -> list:
        import queue
        import time

        out = [None] * self.n
        errors = []
        deadline = time.monotonic() + self.timeout + 60
        for _ in range(self.n):
            while True:
                try:
                    rank, ok, value = self._results.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [p.exitcode for p in self._procs
                            if not p.is_alive()]
                    if dead:
                        raise RuntimeError(f"RankPool: a rank exited "
                                           f"(exit codes {dead})") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError("RankPool: a rank did not "
                                           "answer") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("RankPool: " + "\n".join(errors))
        return out

    def run(self, fn, *args) -> list:
        for q in self._tasks:
            q.put((fn, args))
        return self._collect()

    def close(self) -> None:
        import queue

        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        while True:       # unread results would keep their writers alive
            try:
                self._results.get_nowait()
            except queue.Empty:
                break
        for p in self._procs:
            if p.pid is not None:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

#!/usr/bin/env python3
"""Smoke run of gatb_core_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile [--reads 6000000] [--out DIR]

With ``--profile`` it runs none of the phases below: it counts the stress
bank once on the fold path and once on the LSM chain without the profiler
(host clock, the run's stopwatches, the peak of device memory), then
once on each under ``torch.profiler``, and prints per path the wall time,
the device time summed over kernels and copies, the busy share (device
time over wall time) and the kernels by device time; the full lists go to
``DIR/profile_<path>.txt`` (default ``chiprun_out``).

Builds the CUDA kernels of the port from this checkout (nvcc), holds each
against its plain PyTorch version, then counts k-mers through the port's
public entry points on synthetic banks and checks every result against a
numpy ground truth computed here:

  1. kernels: rank_rows (ops/rank_search) bit for bit against its plain
     version for 1, 2, 3, 4, 5 and 8 limbs, tables of 0, 1, 2^10, 2^20 and
     777,777 live rows under an all-ones padded tail, queries present,
     absent, below the first row, above the last live row, equal to the
     padding row and duplicated, no query at all, and a table whose storage
     is off 16-byte alignment; its time at 8 x 2^20 queries on a 2^20-row
     table (2 and 4 limbs) beside its plain version, torch.searchsorted on
     int64 keys (2 limbs) and the co-sort of table and queries through
     sort_u32_limbs (the JAX package's formulation), and the time of
     neighbor_candidates for 2^20 nodes;
     tile_sort bit for bit against its plain version for 1, 2,
     3, 4, 5 and 9 planes (rows in registers) and 7 (the kernel's path for
     any other number), at every tile from 2 rows to the largest it takes
     and on row counts that are no power of two, on random /
     heavy-duplicate / sorted / reversed / all-equal / half-sentinel /
     all-sentinel inputs; tile_sort at the sort's own tile,
     merge_partition (split arrays equal) and merge_tiles against their
     plain versions for N from 2^10 to 2^25; the full sort and
     merge_sorted_runs (run 2^24, and 3 x 2^26 rows at run 2^25, partition
     and tile merge held there too) against the plain sort; merge_tiles'
     and tile_sort's 4-byte paths (planes off 16-byte alignment, 2 and 4
     rows); the launch
     counters of one merge level (two launches whatever the run), of a
     sort of 2^25 rows and of bitonic_sort_u64 (1 + 2 * (log2 N - log2
     tile), the tile read from the wrappers' choosers); bitonic_sort_u64
     against its plain version for every N from 2^7 to 2^22 (one tile at
     2^14, two at 2^15); then each kernel's time at the shapes the stress
     count gives it (bitonic_u64: N = 2^14 and 2^22; CUDA events, median
     after warm-up) beside its plain version's and, where one PyTorch call
     computes the same function, that call's (torch.sort), with the
     outputs held against each other, and the whole sort of 2 and of 4
     planes x 2^25 rows beside torch.sort; and the fetch of a 30M-row
     table, whole, packed and streamed;
  2. bench bank: 200k x 150 bp reads of a 1 Mbp genome (seed 7, the
     generator of bench.make_dataset), k=31, abundance-min 3;
  3. multi-limb: 20k reads of the same generator, k=63 (W=4);
  4. stress bank: 6M x 150 bp reads of a 30 Mbp genome (seed 11, the
     generator of tools_dev/stress_r3.py:gen, ~0.9 GB of FASTA in a
     temporary directory), k=31, abundance-min 3: 29,999,950 solid k-mers;
  5. main-path shapes: every kernel bit for bit against its plain version
     at each argument shape the counted phases launched it with (run last);
  6. LSM merge chain (``carry_accumulator=False``): the bench bank in one
     pass and in three (bank cache on, and ``bank_cache_bytes=0``) and the
     stress bank in one pass, each solid table equal to the fold phase's;
     a two-bank multibank count (the bench bank in two halves, solidity
     kinds sum and all) against numpy;
  7. dbgh5, counting stage: ``Graph.create`` on the bench bank with every
     postsolid stage off, ``write_kff`` and ``read_kff`` of its table
     against numpy, and the repartitor's minimizer census on the card
     against its run on the CPU. (The ``.h5`` file is held by the CPU
     tests: h5py is not installed beside the card.)
  8. ``bitonic_sort_u64`` on 2^22 (hi, lo) pairs against ``np.sort``.
  9. postsolid graph build (Bloom, debloom, adjacency, branching; MPHF
     off): (a) ``Graph.create`` on the bench bank: adjacency masks,
     branching count and checksum against a numpy lookup over uint64 k-mer
     values; every cFP absent from the solid set, present in the Bloom and
     a neighbour of a solid node; ``contains`` in both modes equal on all 8
     candidates of every node; Bloom words, cFP set and T4 equal to a
     second build on the CPU (the plain versions); (b) the same on a k=63
     bank (4 limbs), the masks of 2^16 sampled nodes against Python
     integers; (c) ``Graph(31, table).build_postsolid`` on the stress
     count's solid table (29,999,950 nodes): stage times, peak device
     memory, masks of 2^20 sampled nodes against numpy, then rank_rows
     against its plain version on every sweep chunk's queries.
 10. MPHF: ``build_postsolid`` with the default ``mphf_kind`` on each of
     the three phase-9 graphs, then the BooPHF's code and ``node_index``
     (the rank search) of every node (2^20 sampled on the stress table)
     equal to its rank, node_index -1 on the cFP set and on random k-mers
     numpy finds outside the table;
     ``perm`` a permutation, the fallback keys the keys no level placed;
     on the bench and k=63 tables every array equal to a build on the CPU;
     stage time, peak device memory, and 2^20 queries through the MPHF
     beside rank_rows on the same queries (CUDA events).
 11. unitigs: ``Graph.unitig_graph()`` and ``Graph.contigs()`` on the same
     three graphs, checked from the sequences alone with numpy (uint64
     k-mer values at k=31, Python integers at k=63): the canonical
     windows of the unitigs, in order, are every node once and are the
     nodes at node_pos 0..len-1 of a second build's node maps; internal
     k-mers have in- and out-degree 1 in their orientation (all, or a
     sample of 2^20 / 2^14); every end is maximal (it branches, is a tip,
     or closes a cycle); the float32 means equal numpy's float64 means
     cast; contigs are the unitigs of at least 2k+1 bases; on the bench
     and k=63 tables the whole unitig graph (sequences, means, links, GFA
     text) equals a build on the CPU; stage times, peak device memory and
     the steps of ``build_unitigs`` timed by its own CUDA events (candidate
     ranks, successor rule, cycle cut, list ranking, node maps, emit) with
     the doubling rounds.
 12. simplification and Monument assembly: (a) ``Graph.create`` (default
     flags, abundance-min 2) on the bench generator's reads with 1%
     substitutions from a second generator (1,157,174 nodes at k=31), then
     ``simplify()``, ``contigs(traversal="monument")`` and
     ``unitig_graph()``: the stats, pass counters, removal strings,
     node_state, contigs and unitig graph equal to the same calls on the
     CPU (a graph made from the card's table; its unitig graph is its
     simplify run's final compaction) and to the JAX package's constants
     (``JAX_BANK_A``); (b) the same at k=63 on 20k reads of a 100 kbp
     genome; (c) ``simplify()`` on the stress table: nothing deleted, its
     compaction equal to phase 11's unitig graph. Logged: the times of the
     sweep, each recompaction and each bulge-walker call with its
     candidates and fallbacks, peak device memory, the share of genome
     k-mers live and of error k-mers deleted, contig N50 and longest.

Phases 2-4 and 6-12 each run with the kernels' launch counters set to 0
just before and read just after; every kernel of the phase's path must
have launched in each (the three limb-sort kernels in the counts;
bitonic_u64 and the two merge kernels in phase 8; rank_rows and the three
limb-sort kernels in each part of phase 9 and in each ``Graph.create`` of
phase 12; rank_rows in each part of phases 10 and 11, the MPHF's fallback
search and the unitig candidate ranks). In phase 12 ``simplify()`` with
``contigs(traversal="monument")`` must launch rank_rows exactly once per
chunk of one full sweep, and ``unitig_graph()`` of the simplified graph
(a fresh Simplifications, as in the JAX package) once more per chunk. The stress counts also log the peak of device memory allocated
during the count. h5py is not installed beside the card, so the MPHF's
``.h5`` datasets, ``Graph.load`` and ``dbginfo`` are held by the CPU tests
only.
Exits non-zero on any failure (and at once without a CUDA device). The
line before the last is the card's name and power limit as nvidia-smi
reports them; the last line is the JSON result.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = {
    "tile_sort": "gatb_core_tpu_torch/ops/csrc/limb_sort.cu",
    "merge_partition": "gatb_core_tpu_torch/ops/csrc/limb_sort.cu",
    "merge_tiles": "gatb_core_tpu_torch/ops/csrc/limb_sort.cu",
    "bitonic_u64": "gatb_core_tpu_torch/ops/csrc/limb_sort.cu",
    "rank_rows": "gatb_core_tpu_torch/ops/csrc/rank_search.cu",
}
# rank_rows has no Pallas original: it replaces the jnp sort-join
REPLACES = {
    "tile_sort": "gatb_core_tpu/ops/pallas_sort.py:150",
    "merge_partition": "gatb_core_tpu/ops/pallas_sort.py:204",
    "merge_tiles": "gatb_core_tpu/ops/pallas_sort.py:181",
    "bitonic_u64": "gatb_core_tpu/ops/pallas_sort.py:45",
    "rank_rows": "gatb_core_tpu/ops/sortops.py:839",
}
LIMB_KERNELS = ("tile_sort", "merge_partition", "merge_tiles",
                "bitonic_u64")
SORT_KERNELS = ("tile_sort", "merge_partition", "merge_tiles")
GRAPH_KERNELS = SORT_KERNELS + ("rank_rows",)
# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and
# the float32 rate outside the tensor cores as the nearest published rate
# for 32-bit compare work
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


class Failure(Exception):
    pass


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


# ---------------------------------------------------------------------------
# synthetic banks (same rng calls as bench.make_dataset and
# tools_dev/stress_r3.py:gen, so the known exact counts hold)
# ---------------------------------------------------------------------------

NTS = np.frombuffer(b"ACTG", dtype=np.uint8)


def write_reads(f, codes: np.ndarray, first_index: int) -> None:
    """Write reads as '>r<i>\\n<seq>\\n' records, vectorized: rows whose
    index has the same number of digits share one fixed-width layout."""
    n, rl = codes.shape
    idx = np.arange(first_index, first_index + n, dtype=np.int64)
    ndig = np.ones(n, np.int64)
    for p in range(1, 19):
        ndig += idx >= 10 ** p
    start = 0
    while start < n:
        d = int(ndig[start])
        end = start + int(np.searchsorted(ndig[start:], d, side="right"))
        rows = np.empty((end - start, 2 + d + 1 + rl + 1), np.uint8)
        rows[:, 0] = ord(">")
        rows[:, 1] = ord("r")
        sub = idx[start:end]
        for t in range(d):
            rows[:, 2 + t] = 48 + (sub // 10 ** (d - 1 - t)) % 10
        rows[:, 2 + d] = 10
        rows[:, 3 + d:3 + d + rl] = NTS[codes[start:end]]
        rows[:, -1] = 10
        f.write(rows.tobytes())
        start = end


def bench_reads(n_reads=200_000, read_len=150, genome_len=1_000_000,
                seed=7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - read_len, size=n_reads)
    return genome[starts[:, None] + np.arange(read_len)[None, :]]


def write_stress_bank(path: str, n_reads=6_000_000, genome_len=30_000_000,
                      read_len=150, seed=11) -> None:
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    chunk = 200_000
    with open(path, "wb") as f:
        done = 0
        while done < n_reads:
            m = min(chunk, n_reads - done)
            starts = rng.integers(0, genome_len - read_len, size=m)
            write_reads(f, genome[starts[:, None]
                                  + np.arange(read_len)[None, :]], done)
            done += m


# ---------------------------------------------------------------------------
# numpy ground truth: canonical k-mers of 2-bit code reads
# ---------------------------------------------------------------------------


def truth_k31(codes: np.ndarray, k: int = 31):
    """(distinct canonical values uint64, counts) for k <= 32."""
    n, rl = codes.shape
    P = rl - k + 1
    c = codes.astype(np.uint64)
    fwd = np.zeros((n, P), np.uint64)
    rev = np.zeros((n, P), np.uint64)
    for t in range(k):
        win = c[:, t:t + P]
        fwd = (fwd << np.uint64(2)) | win
        rev |= (win ^ np.uint64(2)) << np.uint64(2 * t)
    return np.unique(np.minimum(fwd, rev).ravel(), return_counts=True)


def truth_k63(codes: np.ndarray, k: int = 63):
    """(distinct canonical limb rows (N, 4) uint32, counts) for 33 <= k
    <= 64: the 2k-bit value as (hi, lo) uint64 halves."""
    n, rl = codes.shape
    P = rl - k + 1
    c = codes.astype(np.uint64)
    fh = np.zeros((n, P), np.uint64)
    fl = np.zeros((n, P), np.uint64)
    rh = np.zeros((n, P), np.uint64)
    rl_ = np.zeros((n, P), np.uint64)
    for t in range(k):
        win = c[:, t:t + P]
        pos = 2 * (k - 1 - t)           # forward: base t
        if pos >= 64:
            fh |= win << np.uint64(pos - 64)
        else:
            fl |= win << np.uint64(pos)
        comp = win ^ np.uint64(2)        # reverse complement: base t at 2t
        if 2 * t >= 64:
            rh |= comp << np.uint64(2 * t - 64)
        else:
            rl_ |= comp << np.uint64(2 * t)
    take_f = (fh < rh) | ((fh == rh) & (fl < rl_))
    hi = np.where(take_f, fh, rh).ravel()
    lo = np.where(take_f, fl, rl_).ravel()
    m32 = np.uint64(0xFFFFFFFF)
    rows = np.stack([hi >> np.uint64(32), hi & m32, lo >> np.uint64(32),
                     lo & m32], axis=1).astype(np.uint32)
    return np.unique(rows, axis=0, return_counts=True)


def limbs_to_u64(kmers: np.ndarray) -> np.ndarray:
    k = kmers.astype(np.uint64)
    return (k[:, 0] << np.uint64(32)) | k[:, 1]


def revcomp_u64(v: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of k-mers (k <= 32) held as uint64 values."""
    u = np.uint64
    x = v
    for sh, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        x = ((x >> u(sh)) & u(m)) | ((x & u(m)) << u(sh))
    x = (x >> u(32)) | (x << u(32))
    return (x ^ u(0xAAAAAAAAAAAAAAAA)) >> u(64 - 2 * k)


def neighbors_u64(nodes: np.ndarray, k: int) -> np.ndarray:
    """(N, 8) uint64: the 8 canonical neighbour candidates of canonical
    k-mers (k <= 31), 0-3 out by nucleotide, 4-7 in, as the reference
    defines them (Graph.cpp getItems_visitor)."""
    u = np.uint64
    mask = u((1 << (2 * k)) - 1)
    top = u(2 * k - 2)
    f, r = nodes, revcomp_u64(nodes, k)
    out = np.empty((len(nodes), 8), np.uint64)
    for nt in range(4):
        c, rc = u(nt), u(nt ^ 2)
        out[:, nt] = np.minimum(((f << u(2)) | c) & mask,
                                (r >> u(2)) | (rc << top))
        out[:, 4 + nt] = np.minimum((f >> u(2)) | (c << top),
                                    ((r << u(2)) | rc) & mask)
    return out


def member_u64(table: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Membership of uint64 values in a sorted uint64 table."""
    pos = np.minimum(np.searchsorted(table, q), len(table) - 1)
    return table[pos] == q


def masks_of(found: np.ndarray) -> np.ndarray:
    """(N, 8) bool -> (N,) uint8 adjacency masks."""
    return (found.astype(np.uint8) << np.arange(8, dtype=np.uint8)).sum(
        axis=1, dtype=np.uint8)


def popcount4(x: np.ndarray) -> np.ndarray:
    return ((x >> 0) & 1) + ((x >> 1) & 1) + ((x >> 2) & 1) + ((x >> 3) & 1)


def branching_of(masks: np.ndarray) -> np.ndarray:
    """Bool per node: out-degree or in-degree other than 1."""
    return (popcount4(masks & 0x0F) != 1) | (popcount4(masks >> 4) != 1)


def solid_neighbour_u64(nodes: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Bool per (N, 2) limb row (k = 31): one of its 8 neighbour candidates
    is in the sorted uint64 table ``nodes``."""
    cands = neighbors_u64(limbs_to_u64(rows), 31)
    return member_u64(nodes, cands.ravel()).reshape(-1, 8).any(axis=1)


def u64_to_limbs(v: np.ndarray) -> np.ndarray:
    return np.stack([(v >> np.uint64(32)).astype(np.uint32),
                     (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)], axis=1)


_RC_BYTE = bytes(
    sum((((b >> (2 * i)) & 3) ^ 2) << (6 - 2 * i) for i in range(4))
    for b in range(256))


def revcomp_py(v: int, k: int) -> int:
    """Reverse complement of one k-mer held as a Python int (any k)."""
    nbytes = (2 * k + 7) // 8
    return int.from_bytes(v.to_bytes(nbytes, "little").translate(_RC_BYTE),
                          "big") >> (8 * nbytes - 2 * k)


def neighbors_py(v: int, k: int) -> list:
    """The 8 canonical neighbour candidates of one k-mer as Python ints
    (any k)."""
    r = revcomp_py(v, k)
    mask = (1 << (2 * k)) - 1
    top = 2 * k - 2
    out = [min(((v << 2) | nt) & mask, (r >> 2) | ((nt ^ 2) << top))
           for nt in range(4)]
    return out + [min((v >> 2) | (nt << top), ((r << 2) | (nt ^ 2)) & mask)
                  for nt in range(4)]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def build_all():
    """nvcc (one per CUDA source) and g++ (native FASTA batcher), all
    started together."""
    from concurrent.futures import ThreadPoolExecutor

    from gatb_core_tpu_torch import native
    from gatb_core_tpu_torch.ops import _build

    t0 = time.time()
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(_build.load_cuda, "limb_sort"),
                pool.submit(_build.load_cuda, "rank_search"),
                pool.submit(native.available)]
        native_ok = [job.result() for job in jobs][2]
    log(f"build: {time.time() - t0:.2f} s wall "
        f"(nvcc limb_sort.cu {_build.build_seconds.get('limb_sort', 0):.2f}"
        f" s, nvcc rank_search.cu "
        f"{_build.build_seconds.get('rank_search', 0):.2f}"
        f" s, g++ fastx.cpp {_build.build_seconds.get('fastx', 0):.2f} s)"
        f"; parser: {'native' if native_ok else 'python'}"
        + ("" if native_ok else f" ({native.unavailable_reason})"))


def kernel_inputs(P: int, n: int, kind: str, gen, torch):
    if kind == "random":
        x = torch.randint(-2**31, 2**31 - 1, (P, n), dtype=torch.int32,
                          device="cuda", generator=gen)
    elif kind == "duplicates":
        x = torch.randint(0, 3, (P, n), dtype=torch.int32, device="cuda",
                          generator=gen)
        x[0] = torch.where(x[0] == 2, -2, x[0])   # high bit set
    elif kind == "sentinels":
        x = torch.randint(0, 1 << 20, (P, n), dtype=torch.int32,
                          device="cuda", generator=gen)
        x[:, ::3] = -1
        x[:, n // 2:] = -1
    elif kind in ("sorted", "reversed"):
        from gatb_core_tpu_torch.ops.limb_sort import sort_u32_limbs_plain

        x = sort_u32_limbs_plain(kernel_inputs(P, n, "random", gen, torch))
        if kind == "reversed":
            x = x.flip(1)
    elif kind == "all_sentinel":
        x = torch.full((P, n), -1, dtype=torch.int32, device="cuda")
    else:
        x = torch.full((P, n), 12345, dtype=torch.int32, device="cuda")
    return x.contiguous()


def log2(n: int) -> int:
    return n.bit_length() - 1


def max_abs_err(a, b) -> int:
    """Largest |a - b| over the words of two integer tensors."""
    return int((a.long() - b.long()).abs().max())


def check_merge_level(S, runs, run: int, tile: int, err: dict) -> None:
    """merge_partition and merge_tiles against their plain versions on
    ``runs`` (ascending runs of length ``run``), output tiles of ``tile``
    rows; the worst differences go into ``err``."""
    split = S.merge_partition(runs, run, tile)
    ref = S.merge_partition_plain(runs, run, tile)
    err["merge_partition"] = max(err["merge_partition"],
                                 max_abs_err(split, ref))
    err["merge_tiles"] = max(err["merge_tiles"], max_abs_err(
        S.merge_tiles(runs, run, ref, tile),
        S.merge_tiles_plain(runs, run, ref, tile)))


def phase_kernels(torch, S):
    """Kernel vs plain on the card, bit for bit. Returns max |err| per
    kernel."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    err = {name: 0 for name in LIMB_KERNELS}
    err_sort = 0
    n_checks = 0
    # tile_sort at every tile it takes: rows in registers for the planes of
    # SORT_REGISTER_PLANES, sorted slots for any other number (7 here);
    # then row counts that are no power of two (a last block half empty)
    check(7 not in S.SORT_REGISTER_PLANES,
          "phase 1: 7 planes no longer take tile_sort's generic path")
    for P in S.SORT_REGISTER_PLANES + (7,):
        n = 1 << 16
        for kind in ("random", "duplicates", "sorted", "reversed", "equal",
                     "sentinels", "all_sentinel"):
            x = kernel_inputs(P, n, kind, gen, torch)
            tile = 2
            while tile <= S.sort_tile_max(P):
                err["tile_sort"] = max(err["tile_sort"], max_abs_err(
                    S.tile_sort(x.clone(), tile),
                    S.tile_sort_plain(x, tile)))
                n_checks += 1
                tile *= 2
        for n, tile in ((6, 2), (3 * 64, 64), (5 * 1024, 1024),
                        (3 * S.sort_tile_max(P), S.sort_tile_max(P))):
            x = kernel_inputs(P, n, "duplicates", gen, torch)
            err["tile_sort"] = max(err["tile_sort"], max_abs_err(
                S.tile_sort(x.clone(), tile), S.tile_sort_plain(x, tile)))
            n_checks += 1
    for P in (1, 2, 3, 4, 5, 7, 9):
        for lg in (10, 13, 16, 20, 25):
            if lg == 25 and P in (1, 7):
                continue
            n = 1 << lg
            kinds = ("random", "duplicates", "sentinels", "equal") \
                if lg < 25 else ("duplicates", "sentinels")
            for kind in kinds:
                x = kernel_inputs(P, n, kind, gen, torch)
                tile = min(S.sort_tile_rows(P), n)
                a = S.tile_sort(x.clone(), tile)
                err["tile_sort"] = max(err["tile_sort"], max_abs_err(
                    a, S.tile_sort_plain(x, tile)))
                # a merge level over sorted runs (the sorted tiles, or
                # the halves of one tile), at the default output tile and
                # at a small one
                run = tile if n >= 2 * tile else n // 2
                if run < tile:
                    a = S.tile_sort(x.clone(), run)
                for mt in sorted({min(S.merge_tile_rows(P), 2 * run), 256}):
                    check_merge_level(S, a, run, mt, err)
                s = S.sort_u32_limbs(x.clone())
                err_sort = max(err_sort, max_abs_err(
                    s, S.sort_u32_limbs_plain(x)))
                n_checks += 1
                del x
    # merge_sorted_runs over two sorted runs: run = 2^24, and the stress
    # count's fold merge (3 planes, run = 2^25)
    for P, run in ((3, 1 << 24), (9, 1 << 24), (3, 1 << 25)):
        x = kernel_inputs(P, 2 * run, "duplicates", gen, torch)
        halves = torch.cat([S.sort_u32_limbs_plain(x[:, :run].contiguous()),
                            S.sort_u32_limbs_plain(x[:, run:].contiguous())],
                           dim=1).contiguous()
        m = S.merge_sorted_runs(halves, run)
        err_sort = max(err_sort, max_abs_err(m, S.sort_u32_limbs_plain(x)))
        check_merge_level(S, halves, run, S.merge_tile_rows(P), err)
        n_checks += 1
        del x, halves, m
    # merge_tiles' 4-byte path: too few rows for 16-byte words, and planes
    # whose storage is not 16-byte aligned
    for P, n, run in ((2, 2, 1), (3, 4, 1), (3, 1 << 16, 1 << 12)):
        runs = S.tile_sort_plain(kernel_inputs(P, n, "duplicates", gen,
                                               torch), run)
        shifted = torch.empty(P * n + 1, dtype=torch.int32,
                              device="cuda")[1:].view(P, n)
        shifted.copy_(runs)
        check_merge_level(S, shifted, run,
                          min(S.merge_tile_rows(P), 2 * run), err)
        # tile_sort's 4-byte path on the same planes
        tile = min(S.sort_tile_max(P), n)
        ref = S.tile_sort_plain(shifted, tile)
        err["tile_sort"] = max(err["tile_sort"],
                               max_abs_err(S.tile_sort(shifted, tile), ref))
        n_checks += 1
    # launches: two per merge level whatever the run; 1 + 2 * (log2 N - log2
    # tile) for a sort and for bitonic_sort_u64, the tile from the choosers
    x = S.sort_u32_limbs(kernel_inputs(2, 1 << 25, "random", gen, torch))
    for run in (1, 1 << 7, 1 << 14, 1 << 20, 1 << 24):
        S.reset_launches()
        S.merge_sorted_runs(x, run)
        check(S.launches == {"tile_sort": 0, "merge_partition": 1,
                             "merge_tiles": 1, "bitonic_u64": 0},
              f"a merge level of run {run} is not two launches")
    x = kernel_inputs(2, 1 << 25, "random", gen, torch)
    levels = 25 - log2(S.sort_tile_rows(2))
    S.reset_launches()
    S.sort_u32_limbs(x)
    log(f"launches of one merge level: 2 at every run; of sort_u32_limbs "
        f"on 2 x 2^25 rows (tile {S.sort_tile_rows(2)}): {dict(S.launches)}")
    check(S.launches == {"tile_sort": 1, "merge_partition": levels,
                         "merge_tiles": levels, "bitonic_u64": 0},
          f"sort_u32_limbs of 2^25 rows is not 1 + 2 * {levels} launches")
    del x
    # bitonic_sort_u64: one bitonic_u64 launch, then the merge levels; one
    # tile at N = U64_TILE_ROWS, two at twice that
    for lg in range(7, 23):
        levels = max(0, lg - log2(S.U64_TILE_ROWS))
        for kind in ("random", "duplicates", "sentinels", "equal"):
            x = kernel_inputs(2, 1 << lg, kind, gen, torch)
            S.reset_launches()
            got = torch.stack(S.bitonic_sort_u64(x[0], x[1]))
            check(S.launches == {"tile_sort": 0, "merge_partition": levels,
                                 "merge_tiles": levels, "bitonic_u64": 1},
                  f"bitonic_sort_u64 of 2^{lg} pairs is not 1 + 2 * "
                  f"{levels} launches")
            ref = torch.stack(S.bitonic_sort_u64_plain(x[0], x[1]))
            err["bitonic_u64"] = max(err["bitonic_u64"],
                                     max_abs_err(got, ref))
            n_checks += 1
            del x, got, ref
    S.reset_launches()
    torch.cuda.synchronize()
    log(f"phase 1 kernels: {n_checks} inputs, max |kernel - plain| "
        f"{err}, full sort/merge vs plain sort {err_sort}")
    check(all(v == 0 for v in err.values()) and err_sort == 0,
          "a kernel disagrees with its plain version")
    return err


def time_ms(torch, fn, src, warm=2, reps=7, fresh=True):
    """Median CUDA-event time of fn on a fresh copy of src (on src itself
    with fresh=False, for a fn that leaves its argument alone), and what
    the last call returned."""
    y = torch.empty_like(src) if fresh else src
    times = []
    for r in range(warm + reps):
        if fresh:
            y.copy_(src)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(y)
        end.record()
        torch.cuda.synchronize()
        if r >= warm:
            times.append(start.elapsed_time(end))
    return float(np.median(times)), out


def bound(n_bytes: int, n_ops: int):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of bytes over its memory rate and operations over its peak."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = n_ops / PEAK_OPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def sort_ops(n: int, run: int) -> int:
    """Comparisons a comparison sort of every run of ``run`` rows among n
    needs at the least: log2(run) per row, one word comparison each (a
    further plane is compared only on a tie in the planes before it)."""
    return n * log2(run)


def partition_work(P: int, n: int, run: int, tile: int):
    """(bytes, comparisons) merge_partition needs: per boundary one probe
    per halving of the diagonal (two rows read each), and the split array
    written once."""
    probes = n // tile * run.bit_length()
    return probes * 2 * P * 4 + 8 * (n // tile + 1), probes


def phase_timing(torch, S, card: str):
    """Each kernel and its plain version at the stress count's shapes:
    the raw sort (2 planes x 2^25 rows) and the fold merge (3 planes x
    2^26 rows, runs of 2^25); bitonic_u64 at 2^14 and 2^22 pairs; the
    whole sort also at 4 planes. The outputs of each pair are held against
    each other. Each bound is computed from the timed input: every byte
    read once and written once, log2(run) comparisons per row of a sort
    and one per output row of a merge. The library call is one torch.sort of the same rows joined
    into int64 keys (the join is made before the clock starts); no PyTorch
    call merges sorted runs of multi-word rows or finds their merge path.
    Returns {name: {ms, plain_ms, library_ms, bound_ms, bound_by}} and
    max |kernel - plain| per name."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    raw = torch.randint(-2**31, 2**31 - 1, (2, 1 << 25), dtype=torch.int32,
                        device="cuda", generator=gen)
    t_sort = S.sort_tile_rows(2)
    run = 1 << 25
    fold = torch.randint(-2**31, 2**31 - 1, (3, 2 * run), dtype=torch.int32,
                         device="cuda", generator=gen)
    fold = torch.cat([S.sort_u32_limbs_plain(fold[:, :run].contiguous()),
                      S.sort_u32_limbs_plain(fold[:, run:].contiguous())],
                     dim=1).contiguous()
    t_fold = S.merge_tile_rows(3)
    split = S.merge_partition_plain(fold, run, t_fold)
    part_bytes, part_ops = partition_work(3, 2 * run, run, t_fold)
    top = torch.iinfo(torch.int64).min

    def keys_of(x):
        """(2, N) uint32 planes -> (N,) int64 keys in unsigned order."""
        return (((x[0].long() & 0xFFFFFFFF) << 32)
                | (x[1].long() & 0xFFFFFFFF)) ^ top

    raw_keys = keys_of(raw)
    # name: (kernel, plain, input, whether the call gives up its input,
    #        shape, library call, its input, bytes moved, comparisons)
    pairs = {
        "tile_sort": (lambda y: S.tile_sort(y, t_sort),
                      lambda y: S.tile_sort_plain(y, t_sort), raw, True,
                      f"2 x 2^25 rows, tile {t_sort}; library: torch.sort "
                      "of the int64 keys along each tile",
                      lambda q: torch.sort(q.view(-1, t_sort), dim=1).values,
                      raw_keys, 2 * raw.numel() * 4,
                      sort_ops(1 << 25, t_sort)),
        "merge_partition": (lambda y: S.merge_partition(y, run, t_fold),
                            lambda y: S.merge_partition_plain(y, run, t_fold),
                            fold, False,
                            f"3 x 2^26 rows, run 2^25, tile {t_fold}; no "
                            "library call", None, None, part_bytes, part_ops),
        "merge_tiles": (lambda y: S.merge_tiles(y, run, split, t_fold),
                        lambda y: S.merge_tiles_plain(y, run, split, t_fold),
                        fold, False,
                        f"3 x 2^26 rows, run 2^25, tile {t_fold}; no "
                        "library call", None, None,
                        2 * fold.numel() * 4 + split.numel() * 8, 2 * run),
        "sort_u32_limbs": (S.sort_u32_limbs, S.sort_u32_limbs_plain, raw,
                           True,
                           "2 x 2^25 rows; plain: stable torch.sort per "
                           "plane; library: one torch.sort of int64 keys",
                           lambda q: torch.sort(q).values, raw_keys,
                           2 * raw.numel() * 4, sort_ops(1 << 25, 1 << 25)),
        "merge_sorted_runs": (lambda y: S.merge_sorted_runs(y, run),
                              lambda y: S.merge_sorted_runs_plain(y, run),
                              fold, False,
                              "3 x 2^26 rows, run 2^25; plain: sort of the "
                              "pair of runs; no library call", None, None,
                              2 * fold.numel() * 4, 2 * run),
    }
    times, errs = {}, {}
    for name, (fn, plain, src, fresh, shape, lib, lib_src, n_bytes,
               n_ops) in pairs.items():
        ms, out = time_ms(torch, fn, src, fresh=fresh)
        plain_ms, ref = time_ms(torch, plain, src, fresh=False)
        errs[name] = max_abs_err(out, ref)
        lib_ms = None
        if lib is not None:
            lib_ms, _ = time_ms(torch, lib, lib_src)
        b_ms, b_by = bound(n_bytes, n_ops)
        times[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
        log(f"time {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms by {b_by} ({shape}; {card}); "
            f"max |kernel - plain| {errs[name]}")
        del out, ref
    del raw, fold, raw_keys, split
    # the whole sort at 4 planes (k = 63 raw rows). No single PyTorch call
    # sorts four-word rows; beside it stands torch.sort of one int64 key
    # per row, half the row's width, the least any version made of
    # torch.sort calls could take
    wide = torch.randint(-2**31, 2**31 - 1, (4, 1 << 25), dtype=torch.int32,
                         device="cuda", generator=gen)
    ms, out = time_ms(torch, S.sort_u32_limbs, wide)
    plain_ms, ref = time_ms(torch, S.sort_u32_limbs_plain, wide, fresh=False)
    half_ms, _ = time_ms(torch, lambda q: torch.sort(q).values, keys_of(wide))
    errs["sort_u32_limbs@4"] = max_abs_err(out, ref)
    b_ms, b_by = bound(2 * wide.numel() * 4, sort_ops(1 << 25, 1 << 25))
    log(f"time sort_u32_limbs: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.sort of the first two planes as int64 keys {half_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms by {b_by} (4 x 2^25 rows; {card}); "
        f"max |kernel - plain| {errs['sort_u32_limbs@4']}")
    del wide, out, ref
    # bitonic_sort_u64: the bitonic_u64 launch and the merge levels that
    # finish the sort, as a caller gets them
    for lg in (14, 22):
        n = 1 << lg
        x = torch.randint(-2**31, 2**31 - 1, (2, n), dtype=torch.int32,
                          device="cuda", generator=gen)
        ms, out = time_ms(torch, lambda y: S.bitonic_sort_u64(y[0], y[1]),
                          x, fresh=False)
        plain_ms, ref = time_ms(
            torch, lambda y: S.bitonic_sort_u64_plain(y[0], y[1]), x,
            fresh=False)
        lib_ms, lib_out = time_ms(torch, lambda q: torch.sort(q).values,
                                  keys_of(x))
        name = f"bitonic_u64@2^{lg}"
        errs[name] = max(max_abs_err(torch.stack(out), torch.stack(ref)),
                         int((keys_of(torch.stack(out)) != lib_out).sum()))
        b_ms, b_by = bound(2 * x.numel() * 4, sort_ops(n, n))
        times[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
        log(f"time {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"(torch.sort of int64 keys) {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms by {b_by} (2 x 2^{lg} words; {card}); "
            f"max |kernel - plain| {errs[name]}")
        del x, out, ref, lib_out
    times["bitonic_u64"] = times["bitonic_u64@2^22"]
    errs["bitonic_u64"] = max(errs["bitonic_u64@2^14"],
                              errs["bitonic_u64@2^22"])
    torch.cuda.empty_cache()
    check(all(v == 0 for v in errs.values()),
          "timing: a kernel disagrees with its plain version")
    return times, errs


def sorted_table(torch, S, w: int, n: int, cap: int, gen):
    """A sorted table of distinct random rows on the card: ((cap, w) int32
    rows, live), the rows past ``live`` all-ones. ``live`` is n less the
    few duplicates a random draw holds."""
    table = torch.full((cap, w), -1, dtype=torch.int32, device="cuda")
    if n == 0:
        return table, 0
    x = torch.randint(-2**31, 2**31 - 1, (w, n), dtype=torch.int32,
                      device="cuda", generator=gen)
    x[0, ::7] &= 0xFFFF                   # rows below 2^31, and above it
    x = S.sort_u32_limbs_plain(x)
    keep = torch.ones((n,), dtype=torch.bool, device="cuda")
    keep[1:] = (x[:, 1:] != x[:, :-1]).any(dim=0)
    keep &= ~(x == -1).all(dim=0) & ~(x == 0).all(dim=0)
    rows = x.T[keep]
    table[:rows.shape[0]] = rows
    return table, int(rows.shape[0])


def rank_queries(torch, table, live: int, q: int, gen):
    """q query rows in random order: half drawn from the live rows (so
    some are duplicated), half random."""
    w = table.shape[1]
    out = torch.randint(-2**31, 2**31 - 1, (q, w), dtype=torch.int32,
                        device="cuda", generator=gen)
    if live and q:
        pick = torch.randint(0, live, (q,), device="cuda", generator=gen)
        hit = torch.rand((q,), device="cuda", generator=gen) < 0.5
        out = torch.where(hit[:, None], table[pick], out)
    return out.contiguous()


def rank_err(R, table, queries, live: int) -> int:
    """max |kernel - plain| over rank and found of one rank_rows call."""
    rank, found = R.rank_rows(table, queries, live)
    ref_rank, ref_found = R.rank_rows_plain(table, queries, live)
    if queries.shape[0] == 0:
        return int(rank.shape != ref_rank.shape
                   or found.shape != ref_found.shape)
    return max(max_abs_err(rank, ref_rank), max_abs_err(found, ref_found))


def phase_rank_kernel(torch, S, R) -> int:
    """rank_rows against rank_rows_plain on the card, bit for bit."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    err, n_checks = 0, 0
    for w in (1, 2, 3, 4, 5, 8):
        for n, cap in ((0, 4), (1, 1), (1, 8), (1 << 10, 1 << 10),
                       (1 << 20, 1 << 20), (777_777, 1 << 20)):
            table, live = sorted_table(torch, S, w, n, cap, gen)
            edge = [torch.zeros((2, w), dtype=torch.int32, device="cuda"),
                    torch.full((3, w), -1, dtype=torch.int32, device="cuda")]
            if live:
                last = table[live - 1:live].clone()
                above = last.clone()
                above[0, -1] += 1          # above the last live row (or,
                below = table[:1].clone()  # on a wrap, far below it)
                below[0, -1] -= 1
                edge += [last, above, below, table[:1], table[:1],
                         table[live // 2:live // 2 + 1]]
            for q in (0, 1, 1 << 12, (1 << 18) + 3):
                queries = torch.cat(
                    [rank_queries(torch, table, live, q, gen)] + edge) \
                    if q else torch.empty((0, w), dtype=torch.int32,
                                          device="cuda")
                err = max(err, rank_err(R, table, queries, live))
                n_checks += 1
            if live:
                rank, found = R.rank_rows(table, table[:live].contiguous(),
                                          live)
                check(bool(found.all()) and bool(
                    (rank == torch.arange(live, device="cuda")).all()),
                    f"rank_rows: {w} limbs, the table's own rows")
                rank, found = R.rank_rows(table, edge[1], live)
                check(not bool(found.any()) and bool((rank == -1).all()),
                      f"rank_rows: {w} limbs, the padding row was found")
    # storage off 16-byte alignment: the wrapper hands the kernel a copy
    for w in (2, 4):
        table, live = sorted_table(torch, S, w, 1 << 12, 1 << 12, gen)
        flat = torch.empty(table.numel() + 1, dtype=torch.int32,
                           device="cuda")
        shifted = flat[1:].view_as(table)
        shifted.copy_(table)
        queries = rank_queries(torch, table, live, 1 << 12, gen)
        err = max(err, rank_err(R, shifted, queries, live))
        n_checks += 1
    R.reset_launches()
    torch.cuda.synchronize()
    log(f"phase 1 rank_rows: {n_checks} inputs, max |kernel - plain| {err}")
    check(err == 0, "rank_rows disagrees with its plain version")
    return err


def rank_cosort(torch, S, table, queries, n_table: int):
    """The JAX package's formulation of the rank (sortops.py:852-884)
    carried over to the port's sort kernels: co-sort table and queries with
    a tag plane (live table row 0 < query 1 < padding 2), read each
    query's rank off a running count of live table rows, and restore the
    query order with a second sort. (The JAX version finds each run's start
    with two ``cummax`` scans; two ``torch.cummax`` calls took 89 of 97 ms
    on 2^24 rows of an H100, so this one gathers the count at the run's
    start instead.)"""
    c, w = table.shape
    q = queries.shape[0]
    n = c + q
    cap = 1 << (n - 1).bit_length()
    dev = table.device
    planes = torch.full((w + 2, cap), -1, dtype=torch.int32, device=dev)
    planes[:w, :c] = table.T
    planes[:w, c:n] = queries.T
    planes[w] = 2
    planes[w, :n_table] = 0
    planes[w, c:n] = 1
    planes[w + 1, c:n] = torch.arange(q, dtype=torch.int32, device=dev)
    out = S.sort_u32_limbs(planes)
    kp, stag, sorig = out[:w], out[w], out[w + 1]
    is_table = stag == 0
    ct = torch.cumsum(is_table, dim=0, dtype=torch.int32)
    starts = torch.ones((cap,), dtype=torch.bool, device=dev)
    starts[1:] = (kp[:, 1:] != kp[:, :-1]).any(dim=0)
    # live table rows before each equal-key run; a run that holds one holds
    # it first, so a query is found iff the count has moved since the start
    before = (ct - is_table.to(torch.int32))[starts]
    run = torch.cumsum(starts, dim=0) - 1
    found = ct > before[run]
    none = torch.full_like(ct, -1)
    rank = torch.where(found, ct - 1, none)
    key2 = torch.where(stag == 1, sorig, none)
    out2 = S.sort_u32_limbs(torch.stack([key2, rank,
                                         found.to(torch.int32)]))
    return out2[1, :q], out2[2, :q] != 0


def phase_rank_timing(torch, S, R, card: str):
    """rank_rows at 8 x 2^20 queries (half present, half random, in random
    order) on a table of 2^20 rows, 2 and 4 limbs: the kernel, its plain
    version, the co-sort through sort_u32_limbs and, for 2 limbs,
    torch.searchsorted on the rows joined into int64 keys (the join made
    before the clock; it gives the lower bound only, so it is the least a
    version made of that call could take). The bound counts the queries
    read once, the live table read once and 5 bytes written per query.
    Returns ({ms, plain_ms, library_ms, bound_ms, bound_by, ...} of the
    2-limb shape with the 4-limb and co-sort times beside, max |kernel -
    plain|)."""
    from gatb_core_tpu_torch.ops.neighbor_ops import neighbor_candidates

    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    top = torch.iinfo(torch.int64).min
    q = 8 << 20
    res, err = {}, 0
    for w in (2, 4):
        table, live = sorted_table(torch, S, w, 1 << 20, 1 << 20, gen)
        queries = rank_queries(torch, table, live, q, gen)
        ms, out = time_ms(torch, lambda y: R.rank_rows(table, y, live),
                          queries, fresh=False)
        plain_ms, ref = time_ms(
            torch, lambda y: R.rank_rows_plain(table, y, live), queries,
            fresh=False)
        co_ms, co = time_ms(
            torch, lambda y: rank_cosort(torch, S, table, y, live), queries,
            fresh=False)
        e = max(max_abs_err(out[0], ref[0]), max_abs_err(out[1], ref[1]),
                max_abs_err(out[0], co[0]), max_abs_err(out[1], co[1]))
        lib_ms = None
        if w == 2:
            def keys_of(x):
                return (((x[:, 0].long() & 0xFFFFFFFF) << 32)
                        | (x[:, 1].long() & 0xFFFFFFFF)) ^ top

            tkeys, qkeys = keys_of(table[:live]), keys_of(queries)
            lib_ms, lb = time_ms(
                torch, lambda y: torch.searchsorted(tkeys, y), qkeys,
                fresh=False)
            e = max(e, int((lb[out[1]] != out[0][out[1]]).sum()))
            del tkeys, qkeys, lb
        nc_ms, _ = time_ms(
            torch, lambda y: neighbor_candidates(y, 16 * w - 1),
            table[:live].contiguous(), fresh=False)
        b_ms, b_by = bound(q * w * 4 + live * w * 4 + q * 5,
                           q * (live.bit_length() + 1))
        log(f"time rank_rows: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"co-sort through sort_u32_limbs {co_ms:.4f} ms, library "
            f"(torch.searchsorted of int64 keys) "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms by {b_by} ({q} queries of {w} limbs on {live} "
            f"rows; {card}); neighbor_candidates of {live} nodes "
            f"{nc_ms:.4f} ms; max |kernel - plain|, |kernel - co-sort| {e}")
        res[w] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "cosort_ms": co_ms,
                  "neighbor_candidates_ms": nc_ms}
        err = max(err, e)
        del table, queries, out, ref, co
    torch.cuda.empty_cache()
    check(err == 0, "timing: rank_rows disagrees with its plain version, "
          "the co-sort or torch.searchsorted")
    times = dict(res[2])
    times["ms_4_limbs"] = res[4]["ms"]
    times["plain_ms_4_limbs"] = res[4]["plain_ms"]
    times["bound_ms_4_limbs"] = res[4]["bound_ms"]
    times["cosort_ms_4_limbs"] = res[4]["cosort_ms"]
    return times, err


def phase_fetch(torch, card: str):
    """The fetch of a 30M-row k=31 table (the stress count's: 2 limb
    planes at capacity 2^25, 29,999,963 live rows) from the card, three
    ways: whole (``.cpu()`` of planes and int32 counts), packed (one
    row-major tensor, uint8 counts and the exception list) and streamed
    (the packed format in chunks of 2^23 rows on a side stream into pinned
    memory). Host clock around each, the device idle before; each way runs
    twice (the first pays the pinned allocations). All three must give the
    same table."""
    from gatb_core_tpu_torch.kmer import counting as C

    cap, n, w = 1 << 25, 29_999_963, 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    planes = torch.randint(-2**31, 2**31 - 1, (w, cap), dtype=torch.int32,
                           device="cuda", generator=gen)
    counts = torch.randint(1, 60, (cap,), dtype=torch.int32, device="cuda",
                           generator=gen)
    counts[::100_003] = 70_000             # a few counts past the uint8
    planes[:, n:] = -1
    counts[n:] = 0
    ways = {
        "whole": lambda: C._fetch_table_whole(planes, counts, n, w),
        "packed": lambda: C._fetch_table(planes, counts, n, w),
        "streamed": lambda: C._StreamedTable(planes, counts, n,
                                             w).materialize(),
    }
    out, secs = {}, {}
    for name, fn in ways.items():
        secs[name] = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            out[name] = fn()
            secs[name].append(time.time() - t0)
    for name in ("packed", "streamed"):
        check(np.array_equal(out[name][0], out["whole"][0])
              and np.array_equal(out[name][1], out["whole"][1]),
              f"fetch: the {name} table differs from the whole one")
    log("fetch of a 30M-row table (2 planes, capacity 2^25): "
        + ", ".join(f"{name} {s[0]:.3f} s then {s[1]:.3f} s"
                    for name, s in secs.items()) + f"; {card}")
    del planes, counts, out
    torch.cuda.empty_cache()
    return secs


def phase_shapes(torch, S, R, shapes: dict) -> dict:
    """Every kernel against its plain version at each argument shape the
    count phases launched it with, on random and on heavy-duplicate
    inputs. Returns max |kernel - plain| per kernel."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    err = {name: 0 for name in REPLACES}
    n_checks = 0
    # rank_rows: a sorted table of the launch's live rows under its padded
    # tail; queries half present, half random
    tables = {}
    for w, cap, n_table, q in sorted(shapes["rank_rows"]):
        if (w, cap, n_table) not in tables:
            tables.clear()              # one table alive at a time
            tables[(w, cap, n_table)] = sorted_table(torch, S, w, n_table,
                                                     cap, gen)
        table, live = tables[(w, cap, n_table)]
        queries = rank_queries(torch, table, live, q, gen)
        err["rank_rows"] = max(err["rank_rows"],
                               rank_err(R, table, queries, live))
        n_checks += 1
        del queries
    tables.clear()
    for P, n, tile in sorted(shapes["tile_sort"]):
        for kind in ("random", "duplicates"):
            x = kernel_inputs(P, n, kind, gen, torch)
            ref = S.tile_sort_plain(x, tile)
            err["tile_sort"] = max(err["tile_sort"],
                                   max_abs_err(S.tile_sort(x, tile), ref))
            n_checks += 1
            del x, ref
    # the two merge kernels launch with the same shapes, on sorted runs
    check(shapes["merge_partition"] == shapes["merge_tiles"],
          "main-path shapes: the merge kernels' launch shapes differ")
    for P, n, run, tile in sorted(shapes["merge_tiles"]):
        for kind in ("random", "duplicates"):
            runs = S.tile_sort_plain(kernel_inputs(P, n, kind, gen, torch),
                                     run)
            check_merge_level(S, runs, run, tile, err)
            n_checks += 2
            del runs
    for n, tile in sorted(shapes["bitonic_u64"]):
        for kind in ("random", "duplicates"):
            x = kernel_inputs(2, n, kind, gen, torch)
            ref = torch.stack(S.bitonic_sort_u64_plain(x[0], x[1]))
            err["bitonic_u64"] = max(err["bitonic_u64"], max_abs_err(
                torch.stack(S.bitonic_sort_u64(x[0], x[1],
                                               tile_log2=log2(tile))), ref))
            n_checks += 1
            del x, ref
    torch.cuda.synchronize()
    log(f"phase 5 main-path shapes: {n_checks} checks over "
        f"{ {k: len(v) for k, v in shapes.items()} } shapes, "
        f"max |kernel - plain| {err}")
    check(all(v == 0 for v in err.values()),
          "main-path shapes: a kernel disagrees with its plain version")
    return err


def counted(S, name: str, fn, path=SORT_KERNELS):
    """Run fn with the launch counters (the limb-sort wrappers' and the
    rank search's) at 0; require every kernel of its path to have launched.
    Returns fn's result, the launch counts and the launch shapes."""
    from gatb_core_tpu_torch.ops import rank_search as R

    S.reset_launches()
    R.reset_launches()
    out = fn()
    got = {**S.launches, **R.launches}
    shapes = {k: set(v) for k, v in
              {**S.launch_shapes, **R.launch_shapes}.items()}
    log(f"{name} launches: {got}")
    check(all(got[k] > 0 for k in path),
          f"{name}: a kernel of the path was not launched")
    return out, got, shapes


class Tally:
    """Launch counts and launch shapes summed over the counted phases."""

    def __init__(self):
        self.launches = {name: 0 for name in REPLACES}
        self.shapes = {name: set() for name in REPLACES}

    def counted(self, S, name: str, fn, path=SORT_KERNELS):
        out, got, shapes = counted(S, name, fn, path)
        for key in self.launches:
            self.launches[key] += got[key]
            self.shapes[key] |= shapes[key]
        return out, got


def same_table(a, b) -> bool:
    return (np.array_equal(a.solid_kmers, b.solid_kmers)
            and np.array_equal(a.solid_counts, b.solid_counts)
            and np.array_equal(a.histogram.bins, b.histogram.bins))


def phase_bench(tally, tmp: str, S, count_kmers):
    """Returns the reads, the bank's path (kept for the later phases), the
    numpy truth and the fold count's result."""
    reads = bench_reads()
    path = os.path.join(tmp, "bench.fa")
    with open(path, "wb") as f:
        write_reads(f, reads, 0)
    t0 = time.time()
    res, _ = tally.counted(S, "phase 2 bench", lambda: count_kmers(
        path, kmer_size=31, abundance_min=3, superbatch_rows=1 << 22))
    wall = time.time() - t0
    info = res.info
    log(f"phase 2 bench: count {wall:.3f} s, distinct "
        f"{info['kmers_nb_distinct']}, solid {info['kmers_nb_solid']}, "
        f"valid {info['kmers_nb_valid']}, parser {info['parser']}")
    check(info["kmers_nb_distinct"] == 999_959, "bench: distinct k-mers")
    check(info["kmers_nb_valid"] == 200_000 * 120, "bench: valid windows")
    vals, cnts = truth_k31(reads)
    solid = cnts >= 3
    check(np.array_equal(limbs_to_u64(res.solid_kmers), vals[solid])
          and np.array_equal(res.solid_counts, cnts[solid]),
          "bench: solid table differs from the numpy ground truth")
    hist = np.bincount(np.minimum(cnts, 10000), minlength=10001)
    check(np.array_equal(res.histogram.bins.astype(np.int64), hist),
          "bench: histogram differs from the numpy ground truth")
    return reads, path, (vals, cnts), res


def phase_k63(tally, tmp: str, S, count_kmers):
    reads = bench_reads(n_reads=20_000)
    path = os.path.join(tmp, "k63.fa")
    with open(path, "wb") as f:
        write_reads(f, reads, 0)
    t0 = time.time()
    res, _ = tally.counted(S, "phase 3 k=63", lambda: count_kmers(
        path, kmer_size=63, abundance_min=1))
    wall = time.time() - t0
    rows, cnts = truth_k63(reads)
    log(f"phase 3 k=63: count {wall:.3f} s, distinct "
        f"{res.info['kmers_nb_distinct']} (numpy {len(rows)})")
    check(res.solid_kmers.shape[1] == 4, "k=63: four limbs")
    check(np.array_equal(res.solid_kmers, rows)
          and np.array_equal(res.solid_counts, cnts),
          "k=63: table differs from the numpy ground truth")
    return path


def stress_count(tally, S, count_kmers, path: str, name: str, card: str,
                 **kw):
    """One count of the stress bank: the known exact result, a sorted
    table, and the run's stopwatches in the log."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res, got = tally.counted(S, name, lambda: count_kmers(
        path, kmer_size=31, abundance_min=3, superbatch_rows=1 << 25,
        nb_passes=1, **kw))
    wall = time.time() - t0
    log(f"{name}: peak device memory allocated during the count "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; {card}")
    info = res.info
    sweep = info.get("fillsolid_time.4.process", 0.0)
    stages = {key.split(".", 1)[1]: info[key] for key in sorted(info)
              if key.startswith("fillsolid_time.")}
    log(f"{name}: count {wall:.3f} s wall (fill "
        f"{info['time_fill']:.3f} s, processor sweep {sweep:.3f} s; "
        f"stopwatches {stages}), "
        f"solid {info['kmers_nb_solid']}, valid {info['kmers_nb_valid']}, "
        f"distinct {info['kmers_nb_distinct']}, parser {info['parser']}, "
        f"passes {info['nb_passes_effective']}; {card}")
    check(info["kmers_nb_solid"] == 29_999_950, f"{name}: solid k-mers")
    check(info["kmers_nb_valid"] == 720_000_000, f"{name}: valid windows")
    u = limbs_to_u64(res.solid_kmers)
    check(bool(np.all(u[1:] > u[:-1])), f"{name}: table not sorted")
    check(int(res.solid_counts.min()) >= 3, f"{name}: counts below cutoff")
    return res, got


def phase_stress(tally, tmp: str, S, count_kmers, card: str):
    """Returns the bank's path (kept for the LSM phase), the fold count's
    result and its launch counts."""
    path = os.path.join(tmp, "stress.fa")
    t0 = time.time()
    write_stress_bank(path)
    t_gen = time.time() - t0
    log(f"phase 4 stress: generation {t_gen:.3f} s "
        f"({os.path.getsize(path) / 1e9:.3f} GB FASTA)")
    res, got = stress_count(tally, S, count_kmers, path, "phase 4 stress",
                            card)
    return path, res, got


def phase_lsm(tally, S, count_kmers, bench_path: str, bench_fold,
              stress_path: str, stress_fold, card: str):
    """The LSM merge chain against the fold path's tables. Returns the
    stress count's launch counts."""
    runs = (("one pass", dict()),
            ("three passes, bank cache", dict(nb_passes=3)),
            ("three passes, no bank cache", dict(nb_passes=3,
                                                 bank_cache_bytes=0)))
    for label, kw in runs:
        t0 = time.time()
        res, _ = tally.counted(
            S, f"phase 6 LSM bench, {label}", lambda: count_kmers(
                bench_path, kmer_size=31, abundance_min=3,
                superbatch_rows=1 << 22, carry_accumulator=False, **kw))
        log(f"phase 6 LSM bench, {label}: count {time.time() - t0:.3f} s, "
            f"distinct {res.info['kmers_nb_distinct']}, solid "
            f"{res.info['kmers_nb_solid']}, passes "
            f"{res.info['nb_passes_effective']}")
        check(res.info["nb_passes_effective"] == kw.get("nb_passes", 1),
              f"LSM bench, {label}: passes")
        check(same_table(res, bench_fold)
              and res.info["kmers_nb_valid"] == 24_000_000
              and res.info["kmers_nb_distinct"] == 999_959,
              f"LSM bench, {label}: differs from the fold count")
    res, got = stress_count(tally, S, count_kmers, stress_path,
                            "phase 6 LSM stress", card,
                            carry_accumulator=False)
    check(same_table(res, stress_fold),
          "LSM stress: differs from the fold count")
    return got


def phase_multibank(tally, tmp: str, S, reads: np.ndarray):
    """Two banks (the halves of the bench bank) through one multibank
    count, solidity kinds sum and all, against numpy."""
    from gatb_core_tpu_torch import count_kmers_multibank

    half = len(reads) // 2
    paths = []
    for j, part in enumerate((reads[:half], reads[half:])):
        paths.append(os.path.join(tmp, f"half{j}.fa"))
        with open(paths[-1], "wb") as f:
            write_reads(f, part, 0)
    v0, c0 = truth_k31(reads[:half])
    v1, c1 = truth_k31(reads[half:])
    union = np.union1d(v0, v1)
    mat = np.zeros((len(union), 2), np.int32)
    mat[np.searchsorted(union, v0), 0] = c0
    mat[np.searchsorted(union, v1), 1] = c1
    expect = {"sum": mat.sum(axis=1) >= 3, "all": (mat >= 3).all(axis=1)}
    for kind in ("sum", "all"):
        t0 = time.time()
        res, _ = tally.counted(
            S, f"phase 6 multibank, {kind}", lambda: count_kmers_multibank(
                paths, kmer_size=31, abundance_min=3, solidity_kind=kind))
        log(f"phase 6 multibank, {kind}: count {time.time() - t0:.3f} s, "
            f"distinct {res.info['kmers_nb_distinct']}, solid "
            f"{res.info['kmers_nb_solid']}")
        check(np.array_equal(limbs_to_u64(res.kmers), union)
              and np.array_equal(res.counts_per_bank, mat)
              and np.array_equal(res.counts_sum, mat.sum(axis=1)),
              f"multibank, {kind}: matrix differs from numpy")
        check(np.array_equal(res.solid_mask, expect[kind])
              and res.info["kmers_nb_solid"] == int(expect[kind].sum()),
              f"multibank, {kind}: solidity differs from numpy")
    for path in paths:
        os.remove(path)


def phase_dbgh5(tally, tmp: str, S, bench_path: str, truth):
    """The counting stage of dbgh5: the graph build with every postsolid
    stage off and no .h5 output, the KFF dump of its table read back, and
    the repartitor's census."""
    from gatb_core_tpu_torch.debruijn.graph import Graph
    from gatb_core_tpu_torch.kmer.repartition import census_minimizers
    from gatb_core_tpu_torch.storage.kff import read_kff, write_kff

    vals, cnts = truth
    solid = cnts >= 3
    t0 = time.time()
    graph, _ = tally.counted(S, "phase 7 dbgh5", lambda: Graph.create(
        bank=bench_path, kmer_size=31, abundance_min=3, output=None,
        bloom_kind="none", debloom_kind="none", mphf_kind="none",
        build_branching=False, superbatch_rows=1 << 22))
    t_graph = time.time() - t0
    info = graph.get_info()
    check(graph.nb_nodes == int(solid.sum()) == info["nb_solid_kmers"]
          and info["kmers_nb_distinct"] == len(vals)
          and np.array_equal(limbs_to_u64(graph.solid_limbs), vals[solid])
          and np.array_equal(graph.solid_counts, cnts[solid]),
          "dbgh5: the graph's solid table differs from numpy")
    kff = os.path.join(tmp, "bench.kff")
    t0 = time.time()
    write_kff(kff, graph.solid_limbs, graph.solid_counts, 31)
    k, entries, _ = read_kff(kff)
    t_kff = time.time() - t0
    codes = np.stack([c for c, _ in entries]).astype(np.uint64)
    got = np.zeros(len(entries), np.uint64)
    for t in range(31):
        got = (got << np.uint64(2)) | codes[:, t]
    check(k == 31 and np.array_equal(got, vals[solid])
          and np.array_equal(np.array([c for _, c in entries]), cnts[solid]),
          "dbgh5: the KFF entries differ from numpy")
    on_card = census_minimizers(bench_path, 31, 10, max_sample_seqs=5000)
    on_cpu = census_minimizers(bench_path, 31, 10, max_sample_seqs=5000,
                               device="cpu")
    check(int(on_card.sum()) == 5000 * 120
          and np.array_equal(on_card, on_cpu),
          "dbgh5: the minimizer census differs between card and CPU")
    log(f"phase 7 dbgh5: graph build {t_graph:.3f} s, {graph.nb_nodes} "
        f"nodes; KFF write and read {t_kff:.3f} s "
        f"({os.path.getsize(kff) / 1e6:.1f} MB), {len(entries)} entries "
        f"equal to numpy; census of 5000 reads equal on card and CPU")
    os.remove(kff)


def phase_bitonic(tally, S, torch, truth):
    """``bitonic_sort_u64`` as a caller uses it: 2^22 (hi, lo) pairs, the
    bench bank's distinct k-mers shuffled and padded with sentinels."""
    vals, _ = truth
    n = 1 << 22
    keys = np.full(n, np.uint64(2**64 - 1))
    keys[:len(vals)] = vals
    np.random.default_rng(3).shuffle(keys)
    hi = torch.from_numpy((keys >> np.uint64(32)).astype(np.uint32)
                          .view(np.int32)).cuda()
    lo = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                          .view(np.int32)).cuda()
    (oh, ol), got = tally.counted(
        S, "phase 8 bitonic_sort_u64", lambda: S.bitonic_sort_u64(hi, lo),
        path=("bitonic_u64", "merge_partition", "merge_tiles"))
    out = (oh.cpu().numpy().view(np.uint32).astype(np.uint64)
           << np.uint64(32)) | ol.cpu().numpy().view(np.uint32)
    check(np.array_equal(out, np.sort(keys)),
          "bitonic_sort_u64: differs from np.sort")
    log(f"phase 8 bitonic_sort_u64: 2^22 pairs ({len(vals)} k-mers and "
        f"sentinels) equal to np.sort")


def check_debloom(name: str, graph, k: int, cands_limbs: np.ndarray,
                  member: np.ndarray, is_candidate) -> None:
    """What every debloom result must satisfy. ``cands_limbs`` are the 8
    candidates of every node ((8N, W) uint32) and ``member`` their exact
    membership from the ground truth; ``is_candidate`` says of cFP rows
    whether each is a neighbour of a solid node (adjacency is symmetric:
    it is one iff one of its own 8 candidates is solid)."""
    from gatb_core_tpu_torch.kmer.debloom import rows_to_device

    deb = graph._debloom
    check(deb is not None and deb.nb_cfp == len(deb.cfp)
          == graph.get_info()["nb_cfp"], f"{name}: no debloom result")
    exact = graph.contains(cands_limbs, mode="exact")
    check(np.array_equal(exact, member),
          f"{name}: contains(exact) differs from the ground truth")
    check(np.array_equal(graph.contains(cands_limbs, mode="bloom_cfp"),
                         exact),
          f"{name}: contains(bloom_cfp) differs from contains(exact)")
    if deb.nb_cfp:
        check(not graph.contains(deb.cfp).any(),
              f"{name}: a cFP is a solid k-mer")
        in_bloom = deb.bloom.contains(rows_to_device(deb.cfp, "cuda"))
        check(bool(in_bloom.all()), f"{name}: a cFP is not in the Bloom")
        check(bool(np.all(is_candidate(deb.cfp))),
              f"{name}: a cFP is no neighbour of a solid node")
        a, b = deb.cfp[:-1], deb.cfp[1:]
        first = (a != b).argmax(axis=1)[:, None]
        check(bool(np.all(np.take_along_axis(a, first, 1)
                          < np.take_along_axis(b, first, 1))),
              f"{name}: the cFP set is not sorted and distinct")


def check_cpu_rebuild(name: str, graph, k: int) -> float:
    """Bloom words, cFP set and T4 of the graph's debloom stage equal to a
    second build of the same table on the CPU (the plain versions)."""
    from gatb_core_tpu_torch.kmer.debloom import build_debloom

    deb = graph._debloom
    t0 = time.time()
    ref = build_debloom(graph.solid_limbs, k, cascading=True,
                        bloom_kind="neighbor", device="cpu")
    secs = time.time() - t0
    check(np.array_equal(ref.bloom.to_numpy(), deb.bloom.to_numpy())
          and np.array_equal(ref.cfp, deb.cfp) and ref.kind == deb.kind
          and ref.info == deb.info,
          f"{name}: Bloom or cFP set differ from the CPU build")
    if deb.cascade is not None:
        check(np.array_equal(ref.cascade.t4, deb.cascade.t4) and all(
            np.array_equal(a.to_numpy(), b.to_numpy())
            and a.size_bits == b.size_bits and a.n_hash == b.n_hash
            for a, b in zip(ref.cascade.blooms, deb.cascade.blooms)),
            f"{name}: the cascade differs from the CPU build")
    return secs


def stage_times(info: dict) -> dict:
    return {key: info[key] for key in sorted(info)
            if key.startswith("postsolid_time")}


def phase_postsolid_bench(tally, S, bench_path: str, truth, card: str):
    """Phase 9a: the bench bank's graph, default postsolid stages bar the
    MPHF, against numpy over uint64 k-mer values."""
    import torch

    from gatb_core_tpu_torch.debruijn.graph import Graph

    vals, cnts = truth
    nodes = vals[cnts >= 3]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    graph, got = tally.counted(S, "phase 9a bench graph", lambda: Graph.create(
        bank=bench_path, kmer_size=31, abundance_min=3, output=None,
        bloom_kind="neighbor", debloom_kind="cascading", mphf_kind="none",
        build_branching=True, superbatch_rows=1 << 22), path=GRAPH_KERNELS)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    info = graph.get_info()
    check(np.array_equal(limbs_to_u64(graph.solid_limbs), nodes),
          "9a: the graph's table differs from numpy")
    cands = neighbors_u64(nodes, 31)
    member = member_u64(nodes, cands.ravel())
    masks = masks_of(member.reshape(-1, 8))
    check(np.array_equal(graph._adjacency, masks),
          "9a: adjacency masks differ from the numpy lookup")
    check(np.array_equal(graph.adjacency_masks(graph.solid_limbs[:4096]),
                         masks[:4096])
          and np.array_equal(graph.node_index(graph.solid_limbs[-4096:]),
                             np.arange(len(nodes) - 4096, len(nodes))),
          "9a: adjacency_masks or node_index differ from numpy")
    br = branching_of(masks)
    total = int(nodes[br].sum(dtype=np.uint64))
    check(np.array_equal(limbs_to_u64(graph.branching_nodes()), nodes[br])
          and info["nb_branching"] == int(br.sum())
          and info["checksum_branching"] == (f"{total:x}" if total else ""),
          "9a: branching nodes or checksum differ from numpy")
    check_debloom("9a", graph, 31, u64_to_limbs(cands.ravel()), member,
                  lambda cfp: solid_neighbour_u64(nodes, cfp))
    cpu_s = check_cpu_rebuild("9a", graph, 31)
    log(f"phase 9a bench graph: {wall:.3f} s wall with the count, "
        f"{graph.nb_nodes} nodes, stages {stage_times(info)}, nb_cfp "
        f"{info['nb_cfp']} ({info['debloom_kind']}), Bloom "
        f"{info['bloom_size_bits']} bits x {info['bloom_nb_hash']} hashes, "
        f"branching {info['nb_branching']}, checksum "
        f"{info['checksum_branching']}, peak device memory {peak:.1f} MiB; "
        f"{card}; the same debloom stage on the CPU {cpu_s:.3f} s; masks, "
        f"branching, cFP and both membership modes equal to numpy")
    return got, graph


def phase_postsolid_k63(tally, S, k63_path: str, card: str):
    """Phase 9b: a 4-limb graph (k=63, abundance-min 2), the masks of 2^16
    sampled nodes against Python integers and the rest against them."""
    from gatb_core_tpu_torch.debruijn.graph import Graph
    from gatb_core_tpu_torch.ops.kmer_ops import kmers_to_py, py_to_limbs
    from gatb_core_tpu_torch.ops.neighbor_ops import neighbor_candidates

    k = 63
    t0 = time.time()
    graph, got = tally.counted(S, "phase 9b k=63 graph", lambda: Graph.create(
        bank=k63_path, kmer_size=k, abundance_min=2, output=None,
        bloom_kind="neighbor", debloom_kind="cascading", mphf_kind="none",
        build_branching=True), path=GRAPH_KERNELS)
    wall = time.time() - t0
    info = graph.get_info()
    n = graph.nb_nodes
    check(graph.solid_limbs.shape == (n, 4) and n > 1 << 16,
          "9b: four limbs and a table worth the name")
    values = kmers_to_py(graph.solid_limbs)
    solid = set(values)
    pick = np.sort(np.random.default_rng(63).choice(n, 1 << 16,
                                                    replace=False))
    sample = [neighbors_py(values[i], k) for i in pick]
    masks = np.array([sum(1 << j for j, c in enumerate(row) if c in solid)
                      for row in sample], np.uint8)
    check(np.array_equal(graph._adjacency[pick], masks),
          "9b: adjacency masks differ from the Python-integer lookup")
    flat = py_to_limbs([c for row in sample for c in row], k)
    cands = neighbor_candidates(graph._padded_table(), k).cpu().numpy() \
        .astype(np.uint32).reshape(-1, 4)
    rows = cands.reshape(n, 8, 4)[pick].reshape(-1, 4)
    check(np.array_equal(rows, flat),
          "9b: neighbor_candidates differ from Python integers")
    br = branching_of(graph._adjacency)
    total = sum(v for v, b in zip(values, br) if b) % (1 << 128)
    words = [f"{(total >> 64) & (2**64 - 1):x}", f"{total & (2**64 - 1):x}"]
    checksum = ".".join(words if total >> 64 else words[1:]) if total else ""
    check(np.array_equal(graph.branching_nodes(), graph.solid_limbs[br])
          and info["nb_branching"] == int(br.sum())
          and info["checksum_branching"] == checksum,
          "9b: branching nodes or checksum differ")
    member = np.fromiter((c in solid for row in sample for c in row), bool,
                         8 * len(sample))
    check(np.array_equal(graph.contains(flat), member),
          "9b: contains(exact) differs from the Python set")
    # all candidates: exact membership through the masks held above
    every = (graph._adjacency[:, None] >> np.arange(8, dtype=np.uint8)) & 1

    def is_candidate(cfp):
        return [any(c in solid for c in neighbors_py(v, k))
                for v in kmers_to_py(cfp)]

    check_debloom("9b", graph, k, cands, every.ravel().astype(bool),
                  is_candidate)
    cpu_s = check_cpu_rebuild("9b", graph, k)
    log(f"phase 9b k=63 graph: {wall:.3f} s wall with the count, {n} nodes, "
        f"stages {stage_times(info)}, nb_cfp {info['nb_cfp']} "
        f"({info['debloom_kind']}), branching {info['nb_branching']}; "
        f"{card}; the same debloom stage on the CPU {cpu_s:.3f} s; masks of "
        f"2^16 nodes equal to Python integers, cFP and both membership "
        f"modes consistent on all {8 * n} candidates")
    return got, graph


def postsolid_breakdown(torch, R, graph, nodes, card: str) -> None:
    """Where one sweep step of the stress postsolid build spends its time
    (CUDA events, median after warm-up): the Bloom build over the whole
    table, then for one chunk of ``nodes`` the candidates, the Bloom
    probe, the rank search and the dedup of the hits, and the adjacency
    step as a whole."""
    from gatb_core_tpu_torch.collections.bloom import _bloom_build
    from gatb_core_tpu_torch.debruijn.graph import _adjacency_kernel
    from gatb_core_tpu_torch.kmer.debloom import _dedup_rows
    from gatb_core_tpu_torch.ops.neighbor_ops import neighbor_candidates
    from gatb_core_tpu_torch.ops.rank_search import as_rows

    table, n = graph._padded_table(), graph.nb_nodes
    b = graph._debloom.bloom
    build_ms, words = time_ms(
        torch, lambda t: _bloom_build(t, None, b.size_bits, b.n_hash,
                                      b.user_seed, b.kind, b.kmer_size),
        table, warm=1, reps=3, fresh=False)
    check(bool((words == b.words).all()), "9c: the Bloom build is not stable")
    cand_ms, cands = time_ms(torch, lambda t: neighbor_candidates(t, 31),
                             nodes, warm=1, reps=3, fresh=False)
    flat = cands.reshape(-1, cands.shape[-1])
    probe_ms, in_bloom = time_ms(torch, b.contains, flat, warm=1, reps=3,
                                 fresh=False)
    rows = as_rows(flat)
    rank_ms, (_, solid) = time_ms(torch, lambda q: R.rank_rows(table, q, n),
                                  rows, warm=1, reps=3, fresh=False)
    hit = in_bloom & ~solid
    dedup_ms, _ = time_ms(torch, lambda q: _dedup_rows(q, hit, len(q) // 8),
                          rows, warm=1, reps=3, fresh=False)
    adj_ms, _ = time_ms(torch, lambda t: _adjacency_kernel(t, table, 31, n),
                        nodes, warm=1, reps=3, fresh=False)
    log(f"phase 9c breakdown: Bloom build over {n} nodes ({b.size_bits} "
        f"bits, {b.n_hash} hashes, kind {b.kind}) {build_ms:.3f} ms; one "
        f"sweep step of {len(nodes)} nodes: neighbor_candidates "
        f"{cand_ms:.3f} ms, Bloom probe of {len(flat)} candidates "
        f"{probe_ms:.3f} ms, rank_rows {rank_ms:.3f} ms, dedup of "
        f"{int(hit.sum())} hits (sort + reduce) {dedup_ms:.3f} ms; one "
        f"adjacency step (candidates + rank_rows + pack) {adj_ms:.3f} ms; "
        f"{card}")


def phase_postsolid_stress(tally, S, R, stress_fold, card: str):
    """Phase 9c: the postsolid stages on the stress count's solid table,
    then rank_rows against its plain version on every sweep chunk's
    queries (after the launch counts are read)."""
    import torch

    from gatb_core_tpu_torch.debruijn.graph import Graph
    from gatb_core_tpu_torch.ops.neighbor_ops import neighbor_candidates
    from gatb_core_tpu_torch.ops.rank_search import as_rows
    from gatb_core_tpu_torch.ops.sortops import sweep_chunk

    nodes = limbs_to_u64(stress_fold.solid_kmers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**20

    def build():
        graph = Graph(31, stress_fold.solid_kmers, stress_fold.solid_counts)
        init_s.append(time.time() - t0)
        graph.build_postsolid(mphf_kind="none")
        torch.cuda.synchronize()
        return graph

    init_s = []
    t0 = time.time()
    graph, got = tally.counted(S, "phase 9c stress graph", build,
                               path=GRAPH_KERNELS)
    wall = time.time() - t0
    check(got["rank_rows"] == 2 * -(-29_999_950 // sweep_chunk(29_999_950)),
          "9c: rank_rows is not one launch per sweep chunk and stage")
    peak = torch.cuda.max_memory_allocated() / 2**20
    info = graph.get_info()
    n = graph.nb_nodes
    check(n == 29_999_950, "9c: nodes")
    pick = np.sort(np.random.default_rng(9).choice(n, 1 << 20,
                                                   replace=False))
    cands = neighbors_u64(nodes[pick], 31)
    member = member_u64(nodes, cands.ravel())
    masks = masks_of(member.reshape(-1, 8))
    check(np.array_equal(graph._adjacency[pick], masks),
          "9c: adjacency masks differ from the numpy lookup")
    br = branching_of(graph._adjacency)
    total = int(nodes[br].sum(dtype=np.uint64))
    check(info["nb_branching"] == int(br.sum())
          and info["checksum_branching"] == (f"{total:x}" if total else "")
          and np.array_equal(limbs_to_u64(graph.branching_nodes()),
                             nodes[br]),
          "9c: branching nodes or checksum differ")
    every = neighbor_candidates(
        graph._padded_table()[torch.from_numpy(pick).cuda()], 31).cpu() \
        .numpy().astype(np.uint32).reshape(-1, 2)
    check(np.array_equal(limbs_to_u64(every), cands.ravel()),
          "9c: neighbor_candidates differ from numpy")
    check_debloom("9c", graph, 31, every, member,
                  lambda cfp: solid_neighbour_u64(nodes, cfp[::16]))
    log(f"phase 9c stress graph: {wall:.3f} s wall ({init_s[0]:.3f} s of it "
        f"Graph(): the table's upload and the abundance codes), {n} nodes, "
        f"stages {stage_times(info)}, nb_cfp {info['nb_cfp']} "
        f"({info['debloom_kind']}), Bloom {info['bloom_size_bits']} bits x "
        f"{info['bloom_nb_hash']} hashes, branching {info['nb_branching']}, "
        f"peak device memory {peak:.1f} MiB ({base:.1f} MiB before); {card};"
        f" masks of 2^20 nodes, branching and both membership modes equal "
        f"to numpy")
    table = graph._padded_table()
    step = sweep_chunk(n)
    postsolid_breakdown(torch, R, graph, table[:step], card)
    # every chunk's queries: the kernel against its plain version
    err, chunks = 0, 0
    for i in range(0, n, step):
        q = as_rows(neighbor_candidates(table[i:i + step], 31)
                    .reshape(-1, 2))
        err = max(err, rank_err(R, table, q, n))
        chunks += 1
        del q
    log(f"phase 9c: rank_rows against its plain version on {chunks} chunks "
        f"of up to {8 * step} queries: max |kernel - plain| {err}")
    check(err == 0, "9c: rank_rows disagrees with its plain version")
    return got, err, graph, pick


# ---------------------------------------------------------------------------
# phases 10-11: the MPHF and unitig compaction on the three postsolid tables
# ---------------------------------------------------------------------------

_CODE = np.zeros(256, np.uint8)
_CODE[np.frombuffer(b"CTG", np.uint8)] = (1, 2, 3)


def table_hi_lo(rows: np.ndarray):
    """(N, W) uint32 limb rows (W <= 4) -> the value as (hi, lo) uint64."""
    r = np.zeros((len(rows), 4), np.uint64)
    r[:, 4 - rows.shape[1]:] = rows
    s = np.uint64(32)
    return (r[:, 0] << s) | r[:, 1], (r[:, 2] << s) | r[:, 3]


def window_values(codes: np.ndarray, k: int):
    """Every k-mer window of a (L,) array of 2-bit codes (k <= 64): the
    canonical value as (hi, lo) uint64 and whether the forward strand is
    the canonical one (hi stays 0 for k <= 32)."""
    P = len(codes) - k + 1
    c = codes.astype(np.uint64)
    fl, rl = np.zeros(P, np.uint64), np.zeros(P, np.uint64)
    fh, rh = (np.zeros(P, np.uint64), np.zeros(P, np.uint64)) if k > 32 \
        else (fl[:0], rl[:0])
    for t in range(k):
        win = c[t:t + P]
        pos = 2 * (k - 1 - t)
        if pos >= 64:
            fh |= win << np.uint64(pos - 64)
        else:
            fl |= win << np.uint64(pos)
        comp = win ^ np.uint64(2)
        if 2 * t >= 64:
            rh |= comp << np.uint64(2 * t - 64)
        else:
            rl |= comp << np.uint64(2 * t)
    if k <= 32:
        fwd = fl < rl
        return np.zeros(P, np.uint64), np.where(fwd, fl, rl), fwd
    fwd = (fh < rh) | ((fh == rh) & (fl < rl))
    return np.where(fwd, fh, rh), np.where(fwd, fl, rl), fwd


def absent_rows(graph, k: int, n_rand: int = 1 << 16) -> np.ndarray:
    """The cFP set and random k-mers numpy finds outside the table."""
    rng = np.random.default_rng(k + 100)
    w = graph.solid_limbs.shape[1]
    rows = rng.integers(0, 2**32, size=(2 * n_rand, w),
                        dtype=np.uint64).astype(np.uint32)
    rows[:, 0] &= np.uint32((1 << (2 * k - 32 * (w - 1))) - 1)
    if k <= 32:
        v = limbs_to_u64(rows)
        nodes = limbs_to_u64(graph.solid_limbs)
        out = ~member_u64(nodes, np.minimum(v, revcomp_u64(v, k)))
    else:
        solid = set(map(bytes, graph.solid_limbs))
        out = np.fromiter((bytes(r) not in solid for r in rows), bool,
                          len(rows))
    rows = rows[out][:n_rand]
    return np.concatenate([graph._debloom.cfp, rows])


def phase_mphf(tally, S, R, name: str, graph, card: str, sample=None):
    """Phase 10: ``build_postsolid`` with the default ``mphf_kind`` on a
    phase-9 graph (Bloom, debloom and branching already built), then the
    BooPHF's rank and node_index (the rank search) of every node (2^20
    sampled on the stress table), node_index of absent k-mers. Returns the
    launch counts."""
    import torch

    from gatb_core_tpu_torch.collections.boophf import BooPHF, _popcount32
    from gatb_core_tpu_torch.convert import boophf_to_numpy, u32_to_torch
    from gatb_core_tpu_torch.kmer.debloom import rows_to_device

    k, n = graph._k, graph.nb_nodes
    pick = np.arange(n) if sample is None else sample
    present = graph.solid_limbs[pick]
    absent = absent_rows(graph, k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()

    def run():
        graph.build_postsolid(bloom_kind="none", build_branching=False)
        torch.cuda.synchronize()
        by_mphf = graph._mphf.rank(rows_to_device(present, "cuda"))
        return (by_mphf.cpu().numpy(), graph.node_index(present),
                graph.node_index(absent))

    (by_mphf, idx, idx_absent), got = tally.counted(
        S, f"phase 10 {name} MPHF", run, path=("rank_rows",))
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    m = graph._mphf
    check(isinstance(m, BooPHF) and m.bits.is_cuda, f"10 {name}: no MPHF")
    check(np.array_equal(by_mphf, pick) and np.array_equal(idx, pick),
          f"10 {name}: the MPHF code or node_index of a node is not its "
          "rank")
    check(bool((idx_absent == -1).all()),
          f"10 {name}: an absent k-mer got an index")
    check(bool((torch.sort(m.perm).values == torch.arange(
        n, device="cuda", dtype=torch.int32)).all()),
        f"10 {name}: perm is not a permutation")
    set_bits = int(_popcount32(m.bits).sum())
    check(m.fallback_keys.shape[0] == n - set_bits,
          f"10 {name}: fallback keys are not the keys no level placed")
    cpu_s = None
    if sample is None:
        t1 = time.time()
        ref = BooPHF.build(u32_to_torch(graph.solid_limbs, "cpu"), n)
        cpu_s = time.time() - t1
        a, b = boophf_to_numpy(m), boophf_to_numpy(ref)
        check(all(np.array_equal(a[key], b[key]) for key in a),
              f"10 {name}: the MPHF differs from the CPU build")
    # one query batch of 2^20 nodes: the MPHF beside rank_rows
    q = rows_to_device(graph.solid_limbs[np.random.default_rng(1).integers(
        0, n, 1 << 20)], "cuda")
    table = graph._padded_table()
    mphf_ms, a = time_ms(torch, m.rank, q, warm=1, reps=5, fresh=False)
    rank_ms, (b, _) = time_ms(torch, lambda y: R.rank_rows(table, y, n), q,
                              warm=1, reps=5, fresh=False)
    check(bool((a == b).all()), f"10 {name}: MPHF and rank_rows disagree")
    log(f"phase 10 {name} MPHF: {n} keys, stage "
        f"{graph.info['postsolid_time.mphf']:.3f} s ({wall:.3f} s wall with "
        f"the queries), levels {m.sizes}, fallback {m.fallback_keys.shape[0]}"
        f" keys; peak device memory {peak:.1f} MiB; 2^20 queries: MPHF rank "
        f"{mphf_ms:.4f} ms, rank_rows {rank_ms:.4f} ms; "
        f"{len(pick)} nodes and {len(absent)} absent k-mers (cFP and random)"
        f" answered right; "
        + ("" if cpu_s is None
           else f"equal to the CPU build ({cpu_s:.3f} s); ")
        + card)
    return got


def oriented_degrees_py(values: list, solid: set, k: int):
    """(out, in) degree of oriented k-mers given as Python ints."""
    mask = (1 << (2 * k)) - 1
    top = 2 * (k - 1)

    def canon(v):
        return min(v, revcomp_py(v, k))

    out = [sum(canon(((v << 2) | nt) & mask) in solid for nt in range(4))
           for v in values]
    inn = [sum(canon((v >> 2) | (nt << top)) in solid for nt in range(4))
           for v in values]
    return out, inn


def oriented_degrees_u64(v: np.ndarray, nodes: np.ndarray, k: int):
    """(out, in) degree of oriented k-mers (k <= 31) held as uint64."""
    u = np.uint64
    mask = u((1 << (2 * k)) - 1)
    top = u(2 * k - 2)

    def deg(cands):
        return sum(member_u64(nodes, np.minimum(c, revcomp_u64(c, k)))
                   .astype(np.int64) for c in cands)

    return (deg([((v << u(2)) | u(nt)) & mask for nt in range(4)]),
            deg([(v >> u(2)) | (u(nt) << top) for nt in range(4)]))


def check_ends(name: str, heads, tails, degrees, succ_of, rc) -> int:
    """Each unitig end is maximal: its oriented out-degree is not 1, or its
    one successor has in-degree other than 1, or the successor is the
    unitig's own head (a cycle) or the tail's twin. ``heads``/``tails``
    are arrays of the first and last oriented k-mers of every unitig
    (uint64, or Python integers in an object array); run it on the
    unitigs and on their reverse complements. Returns the ends that stop
    at a branch or a tip."""
    out_t, _ = degrees(tails)
    succ = succ_of(tails)
    _, in_s = degrees(succ)
    stops = (np.asarray(out_t) != 1) | (np.asarray(in_s) != 1)
    closes = (succ == heads) | (succ == rc(tails))
    check(bool(np.all(stops | closes)),
          f"11 {name}: a unitig end could be extended")
    return int(stops.sum())


def same_unitig_graph(a, b) -> bool:
    return (list(a.sequences) == list(b.sequences)
            and a.mean_abundance.tobytes() == b.mean_abundance.tobytes()
            and all(np.array_equal(getattr(a, f), getattr(b, f)) for f in
                    ("kmer_counts", "link_offsets", "link_targets")))


def phase_unitigs(tally, S, name: str, graph, tmp: str, card: str):
    """Phase 11: Graph.unitig_graph() and Graph.contigs() on a phase-9
    graph, checked against numpy from the sequences alone, and on the bench
    and k=63 tables against the same build on the CPU. Returns the launch
    counts."""
    import torch

    from gatb_core_tpu_torch.debruijn import unitigs as U
    from gatb_core_tpu_torch.debruijn.graph_unitigs import build_unitig_graph

    k, n = graph._k, graph.nb_nodes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    stage = {}

    def run():
        ug = graph.unitig_graph()
        stage["unitigs"] = graph.info["postsolid_time.unitigs"]
        t1 = time.time()
        contigs = graph.contigs()
        stage["contigs"] = time.time() - t1
        return ug, contigs

    (ug, (contig_seqs, contig_means)), got = tally.counted(
        S, f"phase 11 {name} unitigs", run, path=("rank_rows",))
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    t_check = time.time()
    seqs = list(ug.sequences)
    nu = len(seqs)
    kc = np.asarray(ug.kmer_counts, np.int64)
    lens = np.asarray([len(x) for x in seqs], np.int64)
    check(nu > 0 and np.array_equal(lens, kc + k - 1)
          and int(kc.sum()) == n, f"11 {name}: k-mer counts")
    # every window of every unitig, canonical, in order
    codes = _CODE[np.frombuffer("".join(seqs).encode(), np.uint8)]
    hi, lo, fwd = window_values(codes, k)
    starts_u = np.zeros(nu + 1, np.int64)
    starts_u[1:] = np.cumsum(lens)
    first_w = np.zeros(nu + 1, np.int64)
    first_w[1:] = np.cumsum(kc)
    pos = np.arange(n) - np.repeat(first_w[:-1], kc)
    starts = np.repeat(starts_u[:-1], kc) + pos
    hi, lo, fwd = hi[starts], lo[starts], fwd[starts]
    del codes
    # every node in exactly one unitig: the windows sorted are the table
    order = np.argsort(lo) if k <= 32 else np.lexsort((lo, hi))
    thi, tlo = table_hi_lo(graph.solid_limbs)
    check(np.array_equal(hi[order], thi) and np.array_equal(lo[order], tlo),
          f"11 {name}: the unitigs' k-mers are not the nodes, each once")
    node_of = np.empty(n, np.int64)
    node_of[order] = np.arange(n)
    del order, thi
    # the node maps of the same build: the nodes at node_pos 0..len-1;
    # this second build times its steps (the first warmed them up)
    steps = {}
    us = U.build_unitigs(graph._padded_table(), graph.solid_counts,
                         graph._adjacency, k, device=graph.device,
                         timings=steps)
    uid = np.repeat(np.arange(nu), kc)
    check(list(us.sequences) == seqs
          and np.array_equal(us.node_unitig[node_of], uid)
          and np.array_equal(us.node_pos[node_of], pos)
          and np.array_equal(us.node_strand[node_of], (~fwd).astype(np.int8)),
          f"11 {name}: node_unitig / node_pos / node_strand differ from the "
          f"sequences")
    del us
    mean = (np.bincount(uid, weights=graph.solid_counts[node_of]
                        .astype(np.float64), minlength=nu) / kc) \
        .astype(np.float32)
    check(mean.tobytes() == np.asarray(ug.mean_abundance).tobytes(),
          f"11 {name}: mean_abundance differs from numpy")
    # degrees: internal k-mers 1 in and 1 out in their orientation; ends
    # maximal (k=31 on uint64 values, k=63 on Python integers)
    internal = np.nonzero((pos > 0) & (pos < kc[uid] - 1))[0]
    most = 1 << 18 if k <= 32 else 1 << 14
    if len(internal) > most:
        internal = np.random.default_rng(11).choice(internal, most,
                                                    replace=False)
    need = np.concatenate([internal, first_w[:-1], first_w[1:] - 1])
    if k <= 32:
        nodes = tlo
        oriented = np.where(fwd[need], lo[need], revcomp_u64(lo[need], k))
        mask = np.uint64((1 << (2 * k)) - 1)

        def degrees(v):
            return oriented_degrees_u64(v, nodes, k)

        def succ_of(v):
            # the successor where there is exactly one (else any value)
            out = np.zeros_like(v)
            for nt in range(4):
                c = ((v << np.uint64(2)) | np.uint64(nt)) & mask
                hit = member_u64(nodes, np.minimum(c, revcomp_u64(c, k)))
                out = np.where(hit, c, out)
            return out

        def rc(v):
            return revcomp_u64(v, k)
    else:
        from gatb_core_tpu_torch.ops.kmer_ops import kmers_to_py

        solid = set(kmers_to_py(graph.solid_limbs))
        oriented = np.array(
            [((int(h) << 64) | int(x)) if f
             else revcomp_py((int(h) << 64) | int(x), k)
             for h, x, f in zip(hi[need], lo[need], fwd[need])],
            dtype=object)
        mask = (1 << (2 * k)) - 1

        def degrees(v):
            return oriented_degrees_py(list(v), solid, k)

        def succ_of(vals):
            out = np.zeros(len(vals), dtype=object)
            for i, v in enumerate(vals):
                for nt in range(4):
                    c = ((v << 2) | nt) & mask
                    if min(c, revcomp_py(c, k)) in solid:
                        out[i] = c
            return out

        def rc(vals):
            return np.array([revcomp_py(v, k) for v in vals], dtype=object)
    m = len(internal)
    oi, ii = degrees(oriented[:m])
    heads, tails = oriented[m:m + nu], oriented[m + nu:]
    check(bool(np.all(np.asarray(oi) == 1) and np.all(np.asarray(ii) == 1)),
          f"11 {name}: an internal k-mer has in- or out-degree other than 1")
    stops = check_ends(name, heads, tails, degrees, succ_of, rc) \
        + check_ends(name, rc(tails), rc(heads), degrees, succ_of, rc)
    keep = lens >= 2 * k + 1
    check(contig_seqs == [x for x, y in zip(seqs, keep) if y]
          and contig_means.tobytes() == mean[keep].tobytes(),
          f"11 {name}: contigs are not the long unitigs")
    t_check = time.time() - t_check
    cpu_s = None
    if name != "stress":
        t1 = time.time()
        ref = build_unitig_graph(graph.solid_limbs, graph.solid_counts,
                                 graph._adjacency, k, device="cpu")
        cpu_s = time.time() - t1
        check(same_unitig_graph(ref, ug),
              f"11 {name}: the unitig graph differs from the CPU build")
        texts = []
        for g in (ug, ref):
            path = os.path.join(tmp, "u.gfa")
            g.write_gfa(path)
            with open(path, "rb") as f:
                texts.append(f.read())
            os.remove(path)
        check(texts[0] == texts[1], f"11 {name}: GFA text differs")
    log(f"phase 11 {name} unitigs: {n} nodes -> {nu} unitigs (longest "
        f"{int(lens.max())} bases), {len(ug.link_targets)} links, "
        f"{len(contig_seqs)} contigs; unitig_graph stage "
        f"{stage['unitigs']:.3f} s, contigs {stage['contigs']:.3f} s "
        f"({wall:.3f} s wall), peak device memory {peak:.1f} MiB; "
        f"build_unitigs steps (CUDA events, ms): "
        + ", ".join(f"{key} {v:.3f}" for key, v in steps.items())
        + f" ({U._rounds(2 * n)} doubling rounds over {2 * n} oriented "
        f"nodes, each loop); numpy checks {t_check:.3f} s ({stops} ends at "
        f"a branch or tip, {len(internal)} internal k-mers of degree 1/1)"
        + ("" if cpu_s is None else
           f"; equal to the CPU build ({cpu_s:.3f} s), GFA text too")
        + f"; {card}")
    return got, ug


# ---------------------------------------------------------------------------
# phase 12: simplification and Monument assembly on banks with errors
# ---------------------------------------------------------------------------

# the bench generator with 1% substitutions (bank a: 200k x 150 bp of a 1 Mbp
# genome, ~30x; bank b: 20k x 150 bp of a 100 kbp genome, 30x), abundance-min 2
ERROR_BANKS = {
    "a": {"k": 31, "reads": dict(n_reads=200_000, genome_len=1_000_000,
                                 seed=7, err_seed=1007)},
    "b": {"k": 63, "reads": dict(n_reads=20_000, genome_len=100_000,
                                 seed=7, err_seed=1007)},
}
# JAX's Graph.simplify() and contigs(traversal="monument") on bank a, the
# table counted by the port on the CPU
# (tests/test_torch_simplify.py::test_phase12_constants_match_jax)
JAX_BANK_A = {
    "stats": [6932, 1602, 0, 12], "passes": [4, 4, 4],
    "strings": ["377 + 0 + 0 + 0", "0 + 0 + 0 + 0", "0 + 0 + 0 + 0"],
    "node_state_sha256":
        "cc79d9ac383673c774fe0c306dbf31c42700ef1307f59c20e2995929234cee38",
    "contigs": 1,
    "contigs_sha256":
        "efbc055af5359644982cc35fea9abfc5501b374ae2e4c36dfa4f0567f5ee260a",
}


def error_reads(n_reads: int, genome_len: int, seed: int, err_seed: int,
                read_len: int = 150, rate: float = 0.01) -> np.ndarray:
    """``bench_reads`` with each base replaced, with probability ``rate``,
    by one of the other three; the substitutions come from a second
    generator (``err_seed``)."""
    codes = bench_reads(n_reads, read_len, genome_len, seed)
    rng = np.random.default_rng(err_seed)
    hit = rng.random(codes.shape) < rate
    shift = rng.integers(1, 4, size=codes.shape, dtype=np.uint8)
    return np.where(hit, (codes + shift) & 3, codes).astype(np.uint8)


def simplify_record(graph, simp, stats, contigs: list) -> dict:
    """What a simplify + Monument run decided, in comparable form."""
    return {
        "stats": [stats.tips_removed, stats.bulges_removed, stats.ec_removed,
                  stats.passes],
        "passes": [simp.nb_tip_passes, simp.nb_bulge_passes,
                   simp.nb_ec_passes],
        "strings": [simp.tip_removal, simp.bubble_removal, simp.ec_removal],
        "node_state_sha256": hashlib.sha256(
            graph.node_state.tobytes()).hexdigest(),
        "contigs": len(contigs),
        "contigs_sha256": hashlib.sha256(
            "\n".join(contigs).encode()).hexdigest(),
    }


class SimplifyProbe:
    """While on, times (host clock around a device sync, ms) every full
    sweep, recompaction and bulge-walker call of any Simplifications, with
    the walker's candidates and fallbacks; the class is restored on exit."""

    def __init__(self, torch):
        from gatb_core_tpu_torch.debruijn.simplifications import \
            Simplifications

        self.cls, self.torch = Simplifications, torch
        self.calls = {"_full_sweep": [], "_compact_uncached": [],
                      "_hmcp_batch": []}

    def __enter__(self):
        self.saved = {name: getattr(self.cls, name) for name in self.calls}
        for name, f in self.saved.items():
            setattr(self.cls, name, self._timed(name, f))
        return self

    def _timed(self, name, f):
        torch, log = self.torch, self.calls[name]

        def wrapper(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            # the walker: (candidates, fallbacks, ms)
            log.append((len(args[2]), int(out[1].sum()), ms)
                       if name == "_hmcp_batch" else ms)
            return out
        return wrapper

    def __exit__(self, *exc):
        for name, f in self.saved.items():
            setattr(self.cls, name, f)

    def summary(self) -> str:
        walk = self.calls["_hmcp_batch"]
        comp = self.calls["_compact_uncached"]
        return (f"full sweep {sum(self.calls['_full_sweep']):.3f} ms, "
                f"{len(comp)} compactions ({', '.join(f'{x:.1f}' for x in comp)}"
                f" ms), bulge walker per pass (candidates / fallbacks / ms): "
                + ", ".join(f"{c} / {fb} / {ms:.1f}" for c, fb, ms in walk))


def genome_shares(graph, bank: dict, k: int):
    """(share of the genome's distinct k-mers still live, share of the
    other nodes, the error k-mers, deleted)."""
    r = bank["reads"]
    genome = np.random.default_rng(r["seed"]).integers(
        0, 4, size=r["genome_len"], dtype=np.uint8)
    hi, lo, _ = window_values(genome, k)
    thi, tlo = table_hi_lo(graph.solid_limbs)
    if k <= 32:
        truth = np.unique(lo)
        in_genome = np.isin(tlo, truth)
    else:
        truth = set(zip(hi.tolist(), lo.tolist()))
        in_genome = np.fromiter((x in truth for x in zip(
            thi.tolist(), tlo.tolist())), bool, len(tlo))
    live = (graph.node_state & 1) == 0
    return (int((in_genome & live).sum()) / len(truth),
            int((~in_genome & ~live).sum()) / max(int((~in_genome).sum()), 1))


def n50(lengths) -> int:
    lens = np.sort(np.asarray(lengths, np.int64))[::-1]
    if not len(lens):
        return 0
    return int(lens[np.searchsorted(np.cumsum(lens), lens.sum() / 2)])


def phase_simplify(tally, S, name: str, tmp: str, card: str):
    """Phase 12(a)/(b): ``Graph.create`` (default flags, abundance-min 2) on
    an error bank, then ``simplify()``, ``contigs(traversal="monument")``
    and ``unitig_graph()`` on the card, each counted apart; the decisions,
    the contigs and the unitig graph against the same calls on the CPU
    (the plain versions; the CPU graph is made from the card's table, and
    its unitig graph is its simplify run's final compaction, the value the
    fresh ``unitig_graph()`` compaction gives); bank a also against the
    JAX package's constants. Returns the launch counts of the three
    parts."""
    import torch

    from gatb_core_tpu_torch.debruijn.graph import Graph
    from gatb_core_tpu_torch.ops.sortops import sweep_chunk

    bank = ERROR_BANKS[name]
    k = bank["k"]
    path = os.path.join(tmp, f"errors_{name}.fa")
    with open(path, "wb") as f:
        write_reads(f, error_reads(**bank["reads"]), 0)
    t0 = time.time()
    graph, got_create = tally.counted(
        S, f"phase 12{name} create", lambda: Graph.create(
            bank=path, kmer_size=k, abundance_min=2), path=GRAPH_KERNELS)
    create_s = time.time() - t0
    os.remove(path)
    n = graph.nb_nodes
    chunks = 1 if n <= 1 << 22 else -(-n // sweep_chunk(n))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        stats = graph.simplify()
        return stats, graph.contigs(traversal="monument")[0]

    with SimplifyProbe(torch) as probe:
        (stats, contigs), got = tally.counted(
            S, f"phase 12{name} simplify + monument", run,
            path=("rank_rows",))
    peak = torch.cuda.max_memory_allocated() / 2**20
    check(got["rank_rows"] == chunks,
          f"12{name}: rank_rows is not one launch per chunk of one sweep")
    simp = graph._simplifications
    record = simplify_record(graph, simp, stats, contigs)
    t1 = time.time()
    ug, got_ug = tally.counted(S, f"phase 12{name} unitig_graph",
                               graph.unitig_graph, path=("rank_rows",))
    ug_s = time.time() - t1
    check(got_ug["rank_rows"] == chunks,
          f"12{name}: unitig_graph is not one sweep")
    # the same calls on the CPU
    t1 = time.time()
    cpu = Graph(k, graph.solid_limbs, graph.solid_counts, device="cpu")
    cpu_stats = cpu.simplify()
    cpu_contigs = cpu.contigs(traversal="monument")[0]
    cpu_s = time.time() - t1
    csimp = cpu._simplifications
    check(record == simplify_record(cpu, csimp, cpu_stats, cpu_contigs)
          and contigs == cpu_contigs,
          f"12{name}: simplify or Monument differs from the CPU run")
    _, cpu_ug = csimp._compact(*csimp._rows(csimp._live()))
    check(same_unitig_graph(ug, cpu_ug),
          f"12{name}: the unitig graph differs from the CPU run")
    if name == "a":
        check(record == JAX_BANK_A,
              "12a: simplify or Monument differs from the JAX package's "
              f"constants: {record}")
    live_share, err_deleted = genome_shares(graph, bank, k)
    lens = [len(c) for c in contigs]
    log(f"phase 12{name} k={k}: {n} nodes ({create_s:.3f} s create), stats "
        f"{record['stats']}, passes {record['passes']}, "
        f"{int((graph.node_state & 1).sum())} deleted; simplify "
        f"{graph.info['postsolid_time.simplify']:.3f} s, monument "
        f"{graph.info['postsolid_time.contigs']:.3f} s, unitig_graph "
        f"{ug_s:.3f} s ({ug.nb_unitigs} unitigs), peak device memory "
        f"{peak:.1f} MiB; {probe.summary()}; genome k-mers live "
        f"{live_share:.6f}, error k-mers deleted {err_deleted:.6f}; "
        f"{len(contigs)} contigs, N50 {n50(lens)}, longest "
        f"{max(lens, default=0)} of a {bank['reads']['genome_len']} bp "
        f"genome; equal to the CPU run ({cpu_s:.3f} s)"
        + (" and to the JAX package's constants" if name == "a" else "")
        + f"; {card}")
    return {"create": got_create, "simplify": got, "unitig_graph": got_ug}


def phase_simplify_stress(tally, S, graph, ug11, card: str):
    """Phase 12(c): ``simplify()`` on the stress table (error-free: nothing
    may be deleted); its final compaction must equal phase 11's unitig
    graph."""
    import torch

    from gatb_core_tpu_torch.ops.sortops import sweep_chunk

    n = graph.nb_nodes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with SimplifyProbe(torch) as probe:
        stats, got = tally.counted(S, "phase 12c stress simplify",
                                   graph.simplify, path=("rank_rows",))
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    check(got["rank_rows"] == -(-n // sweep_chunk(n)),
          "12c: rank_rows is not one launch per chunk of one sweep")
    check(not (graph.node_state & 1).any() and stats.tips_removed
          == stats.bulges_removed == stats.ec_removed == 0,
          "12c: simplify deleted nodes of an error-free genome")
    simp = graph._simplifications
    _, ug = simp._compact(*simp._rows(simp._live()))
    check(same_unitig_graph(ug, ug11),
          "12c: the simplify compaction differs from phase 11's unitigs")
    log(f"phase 12c stress simplify: {n} nodes, {wall:.3f} s wall "
        f"(postsolid_time.simplify {graph.info['postsolid_time.simplify']:.3f}"
        f" s), {stats.passes} passes, nothing deleted; {probe.summary()}; "
        f"peak device memory {peak:.1f} MiB; its compaction equals phase "
        f"11's unitig graph; {card}")
    return got


def device_events(torch, prof):
    """(name, self device microseconds, calls) of every device-side event
    (kernels and copies) of a profile, longest first."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, float(us), int(e.count)))
    return sorted(rows, key=lambda r: -r[1])


def profile_main(torch, count_kmers, n_reads: int, out_dir: str) -> int:
    """The ``--profile`` mode: where the stress count's time goes, fold
    path and LSM merge chain side by side."""
    from torch.profiler import ProfilerActivity, profile

    def count(path, **kw):
        t0 = time.time()
        res = count_kmers(path, kmer_size=31, abundance_min=3,
                          superbatch_rows=1 << 25, nb_passes=1, **kw)
        return res, time.time() - t0

    os.makedirs(out_dir, exist_ok=True)
    card = card_line()
    log(f"torch {torch.__version__}; {card}")
    build_all()
    paths = {"fold": dict(), "lsm": dict(carry_accumulator=False)}
    with tempfile.TemporaryDirectory(prefix="gatb_profile_") as tmp:
        bank = os.path.join(tmp, "stress.fa")
        write_stress_bank(bank, n_reads=n_reads)
        solid = set()
        for name, kw in paths.items():
            torch.cuda.reset_peak_memory_stats()
            res, wall = count(bank, **kw)
            peak = torch.cuda.max_memory_allocated() / 2**20
            info = res.info
            stages = {k.split(".", 1)[1]: info[k] for k in sorted(info)
                      if k.startswith("fillsolid_time.")}
            log(f"{name}: count {wall:.3f} s wall, fill "
                f"{info['time_fill']:.3f} s, stopwatches {stages}, solid "
                f"{info['kmers_nb_solid']}, peak device memory allocated "
                f"{peak:.1f} MiB; {card}")
            solid.add(info["kmers_nb_solid"])
        check(len(solid) == 1, "profile: the two paths disagree")
        check(n_reads != 6_000_000 or solid == {29_999_950},
              "profile: solid k-mers")
        for name, kw in paths.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, wall = count(bank, **kw)
                torch.cuda.synchronize()
            rows = device_events(torch, prof)
            dev_s = sum(r[1] for r in rows) / 1e6
            log(f"{name} under the profiler: count {wall:.3f} s wall, "
                f"device {dev_s:.3f} s, busy share {dev_s / wall:.3f}; "
                f"{card}")
            for key, us, calls in rows[:14]:
                log(f"  {us / 1e3:10.1f} ms  {calls:7d} x  {key[:90]}")
            with open(os.path.join(out_dir, f"profile_{name}.txt"),
                      "w") as f:
                for key, us, calls in rows:
                    f.write(f"{us / 1e3:.3f}\t{calls}\t{key}\n")
            del prof
    return 0


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile the stress count instead of the phases")
    ap.add_argument("--reads", type=int, default=6_000_000,
                    help="reads of the stress bank under --profile")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out"),
                    help="directory of the profile lists")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from gatb_core_tpu_torch import count_kmers
        from gatb_core_tpu_torch.ops import limb_sort as S
        from gatb_core_tpu_torch.ops import rank_search as R
    except ImportError as e:
        print(f"chip_smoke: the gatb_core_tpu_torch package is missing "
              f"({e})", file=sys.stderr)
        return 2
    if args.profile:
        return profile_main(torch, count_kmers, args.reads, args.out)

    smi = card_line()
    card = f"{torch.cuda.get_device_name(0)}, power limit " \
        f"{smi.split(',')[-1].strip()}"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    t_all = time.time()
    build_all()
    err = phase_kernels(torch, S)
    err["rank_rows"] = phase_rank_kernel(torch, S, R)
    times, err_t = phase_timing(torch, S, card)
    times["rank_rows"], err_t["rank_rows"] = phase_rank_timing(torch, S, R,
                                                               card)
    phase_fetch(torch, card)
    tally = Tally()
    with tempfile.TemporaryDirectory(prefix="gatb_smoke_") as tmp:
        reads, bench_path, truth, bench_fold = phase_bench(
            tally, tmp, S, count_kmers)
        k63_path = phase_k63(tally, tmp, S, count_kmers)
        stress_path, stress_fold, fold_got = phase_stress(
            tally, tmp, S, count_kmers, card)
        lsm_got = phase_lsm(tally, S, count_kmers, bench_path, bench_fold,
                            stress_path, stress_fold, card)
        os.remove(stress_path)
        phase_multibank(tally, tmp, S, reads)
        phase_dbgh5(tally, tmp, S, bench_path, truth)
        phase_bitonic(tally, S, torch, truth)
        graph_got, graphs = {}, {}
        graph_got["bench"], graphs["bench"] = phase_postsolid_bench(
            tally, S, bench_path, truth, card)
        graph_got["k=63"], graphs["k=63"] = phase_postsolid_k63(
            tally, S, k63_path, card)
        graph_got["stress"], err_g, graphs["stress"], pick = \
            phase_postsolid_stress(tally, S, R, stress_fold, card)
        del stress_fold
        mphf_got = {name: phase_mphf(tally, S, R, name, g, card,
                                     sample=pick if name == "stress"
                                     else None)
                    for name, g in graphs.items()}
        unitig_got, ugs = {}, {}
        for name, g in graphs.items():
            unitig_got[name], ugs[name] = phase_unitigs(tally, S, name, g,
                                                        tmp, card)
        simplify_got = {
            "stress": phase_simplify_stress(tally, S, graphs["stress"],
                                            ugs["stress"], card)}
        del graphs, ugs
        for name in ERROR_BANKS:
            simplify_got[name] = phase_simplify(tally, S, name, tmp, card)
    log(f"launches in the stress count: fold {fold_got}, LSM {lsm_got}")
    log(f"launches in the postsolid builds: {graph_got}")
    log(f"launches in the MPHF builds and queries: {mphf_got}")
    log(f"launches in the unitig builds: {unitig_got}")
    log(f"launches in phase 12: {simplify_got}")
    err_s = phase_shapes(torch, S, R, tally.shapes)
    err["rank_rows"] = max(err["rank_rows"], err_g)
    for name in err:
        err[name] = max(err[name], err_t[name], err_s[name])
    log(f"total {time.time() - t_all:.1f} s")
    kernels = [{"name": name, "route": "cuda",
                "source": KERNEL_SOURCE[name], "replaces": REPLACES[name],
                "launches": tally.launches[name],
                "max_abs_err": err[name], **times[name]}
               for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

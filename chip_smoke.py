#!/usr/bin/env python3
"""Smoke run of gatb_core_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile [--reads 6000000] [--out DIR]

With ``--profile`` it runs none of the phases below: it counts the stress
bank once on the fold path and once on the LSM chain without the profiler
(host clock, the run's stopwatches, the peak of device memory), then
once on each under ``torch.profiler``, and prints per path the wall time,
the device time summed over kernels and copies, the busy share (device
time over wall time), the torch ops, kernel launches and copies enqueued,
the extraction's and the reduce's kernels' device time and the kernels by
device time; the full lists go to ``DIR/profile_<path>.txt`` (default
``chiprun_out``). It needs only ``count_kmers`` and the CUDA sources, so
the same script also profiles an older checkout of the package.

    python3 chip_smoke.py --mesh-sizing [--reads 6000000]

With ``--mesh-sizing`` it counts the stress bank through
count_kmers_distributed at one rank over NCCL, with phase 14a's
``distinct_ratio_hint=0.05`` and with the default 0.3, and prints each
run's wall time, peak device memory, final capacities and replays.

Builds the CUDA kernels of the port from this checkout (nvcc), holds each
against its plain PyTorch version, then counts k-mers through the port's
public entry points on synthetic banks and checks every result against a
numpy ground truth computed here:

  1. kernels: rank_rows (ops/rank_search) bit for bit against its plain
     version for 1, 2, 3, 4, 5 and 8 limbs, tables of 0, 1, 2^10, 2^20 and
     777,777 live rows under an all-ones padded tail, queries present,
     absent, below the first row, above the last live row, equal to the
     padding row and duplicated, no query at all, and a table whose storage
     is off 16-byte alignment; n_table at every leaf-block and level
     boundary of its B+ index (B - 1 .. B^3 + 1 rows, B rows a node), one
     index over several query batches, the index's plain walk on the card,
     a tall index (2^20 rows of 1 limb, 3 levels); its time at the four
     shapes of gatb_core_tpu_torch/tools/rank_sweep.py (8 x 2^20 queries
     on 2^20 rows of 2 and 4 limbs; the stress sweep step, 2^24 candidates
     of 2^21 sorted nodes on a 30M-row k=31 table; 2^24 random queries on
     that table; the candidate sweep of a 523,394-row k=63 table) with the
     index built, its build and the one-shot call, beside its plain
     version and torch.searchsorted on int64 keys (1-2 limbs; the found
     rows' ranks held against its lower bound); at the first
     shape the co-sort of table and queries through sort_u32_limbs (the
     JAX package's formulation), and the time of neighbor_candidates for
     2^20 nodes;
     neighbor_masks (ops/neighbor_ops) bit for bit against its plain version
     at k = 11, 16, 17, 31, 32, 33, 63, 65, 95, 111 and 127 (W 1-8: the
     index's walk and the binary search), the table's index held and a
     transient one, a padded table, fewer live rows, one and none, one node
     and none, storage off 16-byte alignment; its time at the two shapes of
     rank_sweep.py (71,000 query nodes and the 2^21-node sweep step on the
     30M-row k=31 table) beside the chain it replaces
     (neighbor_candidates, rank_rows, the pack), rank_rows alone on the
     same candidates and its bound;
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
     planes x 2^25 rows beside torch.sort;
     extract_planes (ops/kmer_ops) bit for bit against its plain version
     at k = 15, 16, 31, 32, 63 and 95, L = 150 and 151, dense and masked
     validity, one pass and each of three, reads shorter than k, and at
     the stress superbatch (147,456 reads x 256, 2^25 rows); run_reduce
     (ops/sortops) against count_sorted_planes[_multi]_plain for 1 to 9
     planes, no weights, one and three weight rows up to 2^30 (the counts
     wrap), capacities above and below the run count, 12,293 and 2^20
     rows with a 5000-row run across its 4096-row blocks, no valid row and
     one row, each call one launch; their times at the stress superbatch
     (1 and 3 passes) and at the fold's (2 x 2^26 rows, weighted) and the
     LSM chain's (2 x 2^25) reduce beside the plain versions and, for the
     reduce, torch.unique_consecutive; solid_select (ops/solid_select)
     against its plain version for 1 to 5 planes, 0 to 2^20 rows on and
     off its 8192-row tile, with the histogram and without, a finite
     range, histo_max past its shared bins, each call one launch; its
     time at the human count's (2 x 109.5M rows) and the k 63 count's (4 x
     95.5M) pass ends with their skew, its histogram launch alone, beside
     its plain version and the numpy chain it replaces (host clock);
  2. bench bank: 200k x 150 bp reads of a 1 Mbp genome (seed 7, the
     generator of bench.make_dataset), k=31, abundance-min 3;
  3. multi-limb: 20k reads of the same generator, k=63 (W=4);
  4. stress bank: 6M x 150 bp reads of a 30 Mbp genome (seed 11, the
     generator of tools_dev/stress_r3.py:gen, ~0.9 GB of FASTA in a
     temporary directory), k=31, abundance-min 3: 29,999,950 solid k-mers;
  5. main-path shapes: every kernel bit for bit against its plain version
     at each argument shape the counted phases launched it with (run last;
     the extraction on random reads, the reduce on sorted rows a tenth
     invalid);
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
 13. the stacked merges, the linear counter and Leon: (a) 64 sorted
     distinct-key tables of 2^18 rows from ``count_batch`` over 64 chunks
     of the bench bank's k-mers (k=31), and 16 of 2^16 at k=63, through
     ``merge_stacked_tree`` (two merge launches a level),
     ``merge_stacked_tree_capped`` at the distinct count rounded up (no
     overflow) and at half of it (overflow) and ``merge_stacked`` (one
     sort): equal to one another, to numpy's unique of the k-mers and to
     the same calls with the kernels' plain versions on the card; at k=31
     their CUDA-event times beside ``torch.sort`` of the rows as int64
     keys; (b) a ``LinearCounter`` of 200,000 x 121 bits fed the bench
     bank's 999,959 distinct k-mers once, within 1% of that count;
     ``estimate_distinct_kmers`` of the whole bank (logged: it scales by
     the file size, headers included) and of its first 20,000 reads,
     equal on the card and on the CPU; (c) Leon's device stage
     (``leon_ref_bloom``: the count at abundance-min 2 and the neighbor
     Bloom) on the bench bank, its bytes equal to ``_bloom_build`` on the
     CPU, with stage time and peak device memory; (d) Leon on a cut (2,000
     x 150 bp FASTQ reads of a 10 kbp genome, 1% substitutions): the
     ``tools.leon`` CLI as a process on the card (``-c -gtbl``, then
     ``-d``) round trips, its file equals ``LeonCompressor`` on the CPU
     byte for byte, ``open_bank`` of it reads the input, and the
     reference container's contents (``leon_ref_contents``, lossless and
     lossy) decode in memory to the reads, headers and qualities (lossy:
     the smoothing over a Bloom built on the CPU); the host coder's ms per
     read each way for both formats;
 14. the mesh paths (gatb_core_tpu_torch/parallel): (a) a world of one
     rank over NCCL in this process: count_kmers_distributed of the stress
     bank (the superbatch exchange; before phase 6 removes the bank), its
     table equal to phase 4's, then Graph(mesh=) build_postsolid and
     unitig_graph on the stress table, equal to phases 9c and 11; (b) two
     ranks spawned on the one card over gloo (every collective staged
     through the host, so no figure of it is a multi-card figure) after
     the kernels are built: the bench bank in 2 passes with send windows
     that overflow (superbatch replays required), equal to phase 2's
     table; the k=63 bank, equal to phase 3's; error bank a through
     Graph.create(mesh=), stage by stage beside the same stage on one
     device of the card, its unitigs equal and its simplify + Monument
     record equal to JAX_BANK_A; the port's dry run (dryrun_rank). Every
     rank must return the same result, and each rank must launch the sort
     kernels in its counts and rank_rows in each sharded graph stage; the
     ranks' launches join the kernels line.
 15. the tools (run right after phase 9): (a) ``Graph.create`` on the
     bench bank (k=31, abundance-min 3, ``build_branching=False``), then
     ``tools.dbgcheck.check_graph`` and ``tools.dbgtopology.topology_matrix``
     on it:
     every figure against numpy (node count, out-degree sum, branching
     count, the three checksums as Python-integer sums of the uint64
     values, both abundances; the in/out-degree histogram) and against the
     same calls on a graph made on the CPU from the card's table; (b) both
     CLIs as processes on the card on the bench bank, their printed blocks
     (bar ``time``) equal to (a)'s; (c) the table's k-mer values written
     through ``BagFile`` as 64-bit records and ``tools.kmer_checksum`` as a
     process: count and checksum equal to (a)'s; (d) ``Graph(31, table,
     storage=FileStorage(...))`` with ``build_postsolid()`` (default flags),
     ``save_solid`` and ``save_config`` on the card: every blob read back
     equal to the arrays in memory and every stage's state bit set; the
     same build on the CPU into a second FileStorage: every ``.data`` file
     byte-equal, every property equal bar the time-valued xml dump;
     (e) ``system.info``: the card's name as nvidia-smi prints it; then
     ``check_graph`` on phase 9c's stress graph (its adjacency held, so no
     kernel launch) under torch.profiler (wall, device time and its share):
     checksumBranching equal to ``checksum_branching()``, nbSuccessors to
     the out-degree sum, abundance to the counts' sum. The processes and
     the CPU build run beside (a)-(e); each step's time is logged.
 16. the examples (after phase 14): every script of examples_torch/ (the
     mirrors of examples/) with ``--device cuda`` on seeded stand-ins for
     the reference's test/db (``_runner.fixture_db``), its printed lines
     (``_runner.normalise``) equal to the same script's run with
     ``--device cpu`` in a process pool beside the card's runs; the mesh
     scripts as processes of 8 gloo ranks on the one card (collectives
     staged through the host, so no multi-card figure). The scripts that
     need h5py (``NEEDS_H5PY``) are named and not run where it is
     missing. Each in-process script's card wall time and launches are
     logged; every one of the sort kernels and rank_rows must launch in
     the phase.

Phases 2-4 and 6-16 each run with the kernels' launch counters set to 0
just before and read just after; every kernel of the phase's path must
have launched in each (the three limb-sort kernels, extract_planes and
run_reduce in the counts of phases 2-4, 6, 7, 13b and 14a and in each
rank's bench count of 14b, solid_select in the single-bank counts of
phases 2-4, 6, 7 and 13b;
bitonic_u64 and the two merge kernels in phase 8; rank_rows, neighbor_masks
and the three limb-sort kernels in each part of phase 9 and in each
``Graph.create`` of phase 12, neighbor_masks exactly once per sweep chunk
in 9c; rank_rows in each part of phases 10 and 11, the MPHF's fallback
search and the unitig candidate ranks; the two merge kernels, exactly
twice log2(tables) times, in each stacked tree of phase 13, tile_sort in
``merge_stacked`` and the three limb-sort kernels in its counts and Leon's
device stage; rank_rows and the three limb-sort kernels in phase 15's
``Graph.create``, neighbor_masks in its ``check_graph``; the sort kernels and
rank_rows over the whole of phase 16). The rank index of a
graph's table is built once, in its postsolid build (phases 9 and 12's create), and
walked again by phases 10-12 without a build. In phase 12 ``simplify()`` with
``contigs(traversal="monument")`` must launch rank_rows exactly once per
chunk of one full sweep, and ``unitig_graph()`` of the simplified graph
(a fresh Simplifications, as in the JAX package) once more per chunk. The stress counts also log the peak of device memory allocated
during the count. h5py is not installed beside the card, so the MPHF's
``.h5`` datasets, ``Graph.load`` and ``dbginfo`` are held by the CPU tests
only; phase 15d persists a graph built on the card through the file
backend instead.
Exits non-zero on any failure (and at once without a CUDA device). The
line before the last is the card's name and power limit as nvidia-smi
reports them; the last line is the JSON result.
"""

from __future__ import annotations

import contextlib
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
    "neighbor_masks": "gatb_core_tpu_torch/ops/csrc/rank_search.cu",
    "extract_planes": "gatb_core_tpu_torch/ops/csrc/kmer_extract.cu",
    "run_reduce": "gatb_core_tpu_torch/ops/csrc/run_reduce.cu",
    "solid_select": "gatb_core_tpu_torch/ops/csrc/solid_select.cu",
}
# rank_rows, neighbor_masks, extract_planes, run_reduce and solid_select
# have no Pallas original: they replace the jnp sort-join, the jnp
# neighbour candidates with the sort-join, the jnp extraction (with the
# pass filter and the sentinel encoding), the jnp distinct reduce and the
# host's numpy processor chain (histogram -> solidity -> collect)
REPLACES = {
    "tile_sort": "gatb_core_tpu/ops/pallas_sort.py:150",
    "merge_partition": "gatb_core_tpu/ops/pallas_sort.py:204",
    "merge_tiles": "gatb_core_tpu/ops/pallas_sort.py:181",
    "bitonic_u64": "gatb_core_tpu/ops/pallas_sort.py:45",
    "rank_rows": "gatb_core_tpu/ops/sortops.py:839",
    "neighbor_masks": "gatb_core_tpu/ops/neighbor_ops.py:83 + "
                      "gatb_core_tpu/ops/sortops.py:839",
    "extract_planes": "gatb_core_tpu/ops/kmer_ops.py:141",
    "run_reduce": "gatb_core_tpu/ops/sortops.py:559",
    "solid_select": "gatb_core_tpu/kmer/count_processor.py:137 + "
                    "gatb_core_tpu/kmer/histogram.py:31",
}
LIMB_KERNELS = ("tile_sort", "merge_partition", "merge_tiles",
                "bitonic_u64")
# wall seconds of single-device stages, logged beside phase 14's mesh runs
SINGLE_S: dict = {}
SORT_KERNELS = ("tile_sort", "merge_partition", "merge_tiles")
GRAPH_KERNELS = SORT_KERNELS + ("rank_rows",)
# a single-device build with its branching stage: the adjacency sweep too
BUILD_KERNELS = GRAPH_KERNELS + ("neighbor_masks",)
# a count: the extraction, the sort kernels and the distinct reduce
COUNT_KERNELS = SORT_KERNELS + ("extract_planes", "run_reduce")
# a single-bank count with the default processor chain: and the select
SELECT_COUNT_KERNELS = COUNT_KERNELS + ("solid_select",)
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
    """nvcc (one per CUDA source under ops/csrc) and g++ (native FASTA
    batcher), all started together."""
    import glob
    from concurrent.futures import ThreadPoolExecutor

    from gatb_core_tpu_torch import native
    from gatb_core_tpu_torch.ops import _build

    stems = sorted(os.path.basename(p)[:-3] for p in
                   glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")))
    t0 = time.time()
    with ThreadPoolExecutor(len(stems) + 1) as pool:
        jobs = [pool.submit(_build.load_cuda, stem) for stem in stems]
        native_job = pool.submit(native.available)
        for job in jobs:
            job.result()
        native_ok = native_job.result()
    log(f"build: {time.time() - t0:.2f} s wall ("
        + ", ".join(f"nvcc {stem}.cu "
                    f"{_build.build_seconds.get(stem, 0):.2f} s"
                    for stem in stems)
        + f", g++ fastx.cpp {_build.build_seconds.get('fastx', 0):.2f} s)"
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


# ---------------------------------------------------------------------------
# the count's extraction and distinct reduce (extract_planes, run_reduce)
# ---------------------------------------------------------------------------

# the stress count's superbatch: 144 batches of 1024 reads padded to 256
# bases (CountConfig.batch_len), k=31, 2^25 rows; 150 bp reads
STRESS_READS, STRESS_L, STRESS_LEN = 144 * 1024, 256, 150


def packed_batch(torch, r: int, L: int, k: int, gen, dense: bool,
                 short: bool = True):
    """r random reads packed on the card: (words (r, ceil(L/16)) int32,
    vmask (r, ceil(L/32)) int32 with 2% of the bases invalid, or None,
    lengths (r,) int32: up to L, a fifth under k with ``short``)."""
    from gatb_core_tpu_torch.ops.kmer_ops import pack_valid

    words = torch.randint(-2**31, 2**31 - 1, (r, (L + 15) // 16),
                          dtype=torch.int32, device="cuda", generator=gen)
    lengths = torch.randint(max(0, L - 40), L + 1, (r,), dtype=torch.int32,
                            device="cuda", generator=gen)
    if short:
        lengths[1::5] = torch.randint(0, k, (len(lengths[1::5]),),
                                      dtype=torch.int32, device="cuda",
                                      generator=gen)
    vmask = None
    if not dense:
        bits = torch.rand((r, L), device="cuda", generator=gen) > 0.02
        vmask = pack_valid(bits).to(torch.int32)
    return words, vmask, lengths


def extract_err(K, words, vmask, lengths, k, L, cap, nb_passes, pass_i,
                m=10):
    """max |kernel - plain| over the four outputs of one extract_planes
    call; the call must be one launch."""
    before = K.launches["extract_planes"]
    got = K.extract_planes(words, vmask, lengths, k, L, cap, m=m,
                           nb_passes=nb_passes, pass_i=pass_i)
    check(K.launches["extract_planes"] == before + 1,
          "extract_planes: not one launch a call")
    ref = K.extract_planes_plain(words, vmask, lengths, k, L, cap, m=m,
                                 nb_passes=nb_passes, pass_i=pass_i)
    check(int(got[2]) == int(got[1].sum()), "extract_planes: n_keep")
    return max(max_abs_err(a, b) for a, b in zip(got, ref))


def run_planes(torch, P: int, n: int, n_valid: int, gen, dup=0.55):
    """(P, n) int32 planes sorted as unsigned rows, about ``dup`` of the
    valid rows equal to the row before, one run of 5000 rows across the
    reduce's 4096-row blocks where n_valid allows, every plane used (plane
    j holds the row's value >> 3 (P - 1 - j), the high bit of plane 0 set
    on the upper half), all-ones past n_valid; and inv."""
    planes = torch.full((P, n), -1, dtype=torch.int32, device="cuda")
    if n_valid:
        inc = (torch.rand((n_valid,), device="cuda", generator=gen)
               >= dup).long()
        if n_valid > 10000:
            inc[1000:6000] = 0
        v = torch.cumsum(inc, 0)
        for j in range(P):
            planes[j, :n_valid] = (v >> (3 * (P - 1 - j))).to(torch.int32)
        planes[0, :n_valid] |= torch.where(
            v >= int(v[-1]) // 2, -2**31, 0).to(torch.int32)
    return planes, torch.arange(n, device="cuda") >= n_valid


def reduce_err(T, planes, inv, weights, cap_out: int) -> int:
    """max |kernel - plain| over one distinct reduce (weights None, (N,)
    or (B, N)); the call must be one run_reduce launch."""
    before = T.launches["run_reduce"]
    if weights is not None and weights.dim() == 2:
        got = T.count_sorted_planes_multi(planes, inv, weights, cap_out)
        ref = T.count_sorted_planes_multi_plain(planes, inv, weights,
                                                cap_out)
    else:
        got = T.count_sorted_planes(planes, inv, weights, cap_out)
        ref = T.count_sorted_planes_plain(planes, inv, weights, cap_out)
    check(T.launches["run_reduce"] == before + 1,
          "run_reduce: not one launch a call")
    check(all(a.shape == b.shape and a.dtype == b.dtype
              for a, b in zip(got, ref)), "run_reduce: output shapes")
    return max(max_abs_err(a, b) for a, b in zip(got, ref))


def reduce_weights(torch, b: int, n: int, gen):
    """None (b = 0), (n,) or (b, n) int32 weights up to 2^30 (the counts
    wrap mod 2^32 in both versions)."""
    if b == 0:
        return None
    w = torch.randint(1, 2**30, (b, n), dtype=torch.int32, device="cuda",
                      generator=gen)
    return w[0] if b == 1 else w


MAX_I32 = 2**31 - 1
# the select at the main path's pass ends: (label, W, live rows, capacity,
# share of the rows seen once, the solid rows' coverage) of the human
# count (109.5M distinct k-mers, 23.2M solid) and the k 63 bank's (95.5M,
# 8.1M solid), the benchmark's bank cells
SELECT_SHAPES = (("chr14q_k31", 2, 109_500_000, 1 << 27, 0.788, 30),
                 ("ecoli_k63", 4, 95_500_000, 1 << 27, 0.915, 75))


def select_table(torch, w: int, n: int, cap: int, ones: float, cover: int,
                 gen):
    """A pass's distinct table on the card: (W, cap) random planes and
    (cap,) counts, a share ``ones`` of the n live rows seen once, the
    others Poisson(cover) and at least 2, the edges (0, 254, 255,
    histo_max and past it, the int32 maximum) among them, 0 past
    n. The select reads no order, so the rows are left unsorted."""
    planes = torch.randint(-2**31, MAX_I32, (w, cap), dtype=torch.int32,
                           device="cuda", generator=gen)
    rate = torch.full((n,), float(cover), device="cuda")
    solid = torch.poisson(rate, generator=gen).clamp_(min=2)
    once = torch.rand(n, device="cuda", generator=gen) < ones
    counts = torch.zeros((cap,), dtype=torch.int32, device="cuda")
    counts[:n] = torch.where(once, torch.ones_like(solid), solid).to(
        torch.int32)
    edges = torch.tensor([0, 254, 255, 10000, 10001, MAX_I32],
                         dtype=torch.int32, device="cuda")
    at = torch.arange(len(edges), device="cuda") * max(n // len(edges), 1)
    counts[at[at < n]] = edges[:int((at < n).sum())]
    return planes, counts


def select_err(SS, planes, counts, n: int, lo: int, hi: int,
               histo_max: int = 10000, with_bins: bool = True) -> int:
    """max |kernel - plain| over solid_select's bins, rows and counts (1
    where their shapes differ); the call must be one launch."""
    import torch

    bins = torch.zeros((histo_max + 1,), dtype=torch.int64,
                       device=counts.device) if with_bins else None
    ref_bins = bins.clone() if with_bins else None
    before = SS.launches["solid_select"]
    got = SS.solid_select(planes, counts, n, lo, hi, bins, histo_max)
    check(SS.launches["solid_select"] == before + (n > 0),
          "solid_select: not one launch a call")
    ref = SS.solid_select_plain(planes, counts, n, lo, hi, ref_bins,
                                histo_max)
    e = 0
    for a, b in list(zip(got, ref)) + ([(bins, ref_bins)] if with_bins
                                       else []):
        if a.shape != b.shape or a.dtype != b.dtype:
            e = max(e, 1)
        elif a.numel():
            e = max(e, max_abs_err(a, b))
    return e


def phase_count_kernels(torch) -> dict:
    """extract_planes, run_reduce and solid_select against their plain
    versions on the card, bit for bit. Returns max |err| per kernel."""
    from gatb_core_tpu_torch.ops import kmer_ops as K
    from gatb_core_tpu_torch.ops import solid_select as SS
    from gatb_core_tpu_torch.ops import sortops as T

    gen = torch.Generator(device="cuda")
    gen.manual_seed(515)
    err = {"extract_planes": 0, "run_reduce": 0, "solid_select": 0}
    n_checks = 0
    # extraction: k at and off the limb boundaries, dense and masked, one
    # and three passes (every pass), reads shorter than k, L off a multiple
    # of 16; and the stress superbatch
    for k in (15, 16, 31, 32, 63, 95):
        for L in (150, 151):
            for dense in (True, False):
                words, vmask, lengths = packed_batch(torch, 4096, L, k, gen,
                                                     dense)
                cap = 1 << (4096 * (L - k + 1) - 1).bit_length()
                for nb_passes, pass_i in ((1, 0), (3, 0), (3, 1), (3, 2)):
                    err["extract_planes"] = max(
                        err["extract_planes"],
                        extract_err(K, words, vmask, lengths, k, L, cap,
                                    nb_passes, pass_i))
                    n_checks += 1
    words, vmask, lengths = packed_batch(torch, STRESS_READS, STRESS_L, 31,
                                         gen, True)
    err["extract_planes"] = max(err["extract_planes"], extract_err(
        K, words, None, lengths, 31, STRESS_L, 1 << 25, 1, 0))
    del words, vmask, lengths
    # reduce: 1 to 9 planes, no weights, one and three weight rows, the
    # capacity above and below the run count, rows off the block size, no
    # valid row, one row
    for P in range(1, 10):
        for n in (3 * 4096 + 5, 1 << 20):
            planes, inv = run_planes(torch, P, n, n - 7, gen)
            for b in (0, 1, 3):
                w = reduce_weights(torch, b, n, gen)
                for cap_out in (n, n // 3):
                    err["run_reduce"] = max(err["run_reduce"], reduce_err(
                        T, planes, inv, w, cap_out))
                    n_checks += 1
    for P, n, n_valid in ((2, 4096, 0), (3, 5000, 0), (2, 1, 1), (9, 1, 0)):
        planes, inv = run_planes(torch, P, n, n_valid, gen)
        for b in (0, 1, 3):
            err["run_reduce"] = max(err["run_reduce"], reduce_err(
                T, planes, inv, reduce_weights(torch, b, n, gen), n))
            n_checks += 1
    # select: 1 to 5 planes, no row, one, a tile and one row past it, rows
    # off the tile; the histogram or not, a finite range, histo_max past
    # the kernel's shared bins and of one bin
    for w in range(1, 6):
        for n in (0, 1, 8192, 8193, 3 * 8192 + 5, 1 << 20):
            cap = max(16, 1 << max(n - 1, 0).bit_length())
            planes, counts = select_table(torch, w, n, cap, 0.8, 30, gen)
            for lo, hi, histo_max, with_bins in (
                    (2, MAX_I32, 10000, True), (1, 1, 10000, False),
                    (255, 300, 20000, True), (3, MAX_I32, 1, True)):
                err["solid_select"] = max(err["solid_select"], select_err(
                    SS, planes, counts, n, lo, hi, histo_max, with_bins))
                n_checks += 1
    torch.cuda.synchronize()
    log(f"phase 1 count kernels: {n_checks} inputs, max |kernel - plain| "
        f"{err}")
    check(all(v == 0 for v in err.values()),
          "a count kernel disagrees with its plain version")
    return err


def phase_count_timing(torch, card: str):
    """extract_planes at the stress superbatch (147,456 reads x 256, k=31,
    dense, 150 bp, 2^25 rows) and run_reduce at the fold's reduce (2
    planes x 2^26 rows, weighted, cap_out 2^25, ~30M runs) and at the LSM
    chain's (2 x 2^25, unweighted), each beside its plain version; the
    library call for the reduce is torch.unique_consecutive of the valid
    rows (dim=1, return_counts; unweighted); no PyTorch call extracts
    k-mers. Bounds: the bytes read once and written once (extraction: the
    words and lengths, 4 W + 1 bytes a row; reduce: 4 P + 4 B + 1 bytes a
    row, 4 P + 4 B a run). Returns ({name: {ms, plain_ms, library_ms,
    bound_ms, bound_by}}, {name: max |kernel - plain|})."""
    from gatb_core_tpu_torch.ops import kmer_ops as K
    from gatb_core_tpu_torch.ops import sortops as T

    gen = torch.Generator(device="cuda")
    gen.manual_seed(77)
    times, errs = {}, {}
    words, _, lengths = packed_batch(torch, STRESS_READS, STRESS_L, 31, gen,
                                     True, short=False)
    lengths.fill_(STRESS_LEN)
    cap = 1 << 25
    for nb_passes in (1, 3):
        ms, got = time_ms(torch, lambda y: K.extract_planes(
            y, None, lengths, 31, STRESS_L, cap, nb_passes=nb_passes),
            words, fresh=False)
        plain_ms, ref = time_ms(torch, lambda y: K.extract_planes_plain(
            y, None, lengths, 31, STRESS_L, cap, nb_passes=nb_passes),
            words, fresh=False)
        e = max(max_abs_err(a, b) for a, b in zip(got, ref))
        b_ms, b_by = bound(words.numel() * 4 + lengths.numel() * 4
                           + cap * (2 * 4 + 1), 0)
        log(f"time extract_planes, {nb_passes} pass(es): {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library none, bound {b_ms:.4f} ms by "
            f"{b_by} ({STRESS_READS} reads x {STRESS_L}, k=31, dense, "
            f"{STRESS_LEN} bp, 2^25 rows; kept {int(got[2])}; {card}); "
            f"max |kernel - plain| {e}")
        errs["extract_planes"] = max(errs.get("extract_planes", 0), e)
        if nb_passes == 1:
            times["extract_planes"] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": b_ms, "bound_by": b_by}
        del got, ref
    del words, lengths
    for label, n, weighted, cap_out in (("fold", 1 << 26, True, 1 << 25),
                                        ("LSM", 1 << 25, False, 1 << 25)):
        n_valid = n - n // 10
        planes, inv = run_planes(torch, 2, n, n_valid, gen, dup=0.5)
        w = reduce_weights(torch, int(weighted), n, gen)
        ms, got = time_ms(torch, lambda y: T.count_sorted_planes(
            y, inv, w, cap_out), planes, fresh=False)
        plain_ms, ref = time_ms(torch, lambda y: T.count_sorted_planes_plain(
            y, inv, w, cap_out), planes, fresh=False)
        live = planes[:, :n_valid].contiguous()
        lib_ms, (uq, cnt) = time_ms(torch, lambda y: torch.unique_consecutive(
            y, dim=1, return_counts=True), live, fresh=False)
        e = max(max_abs_err(a, b) for a, b in zip(got, ref))
        runs = int(got[2])
        if not weighted:
            e = max(e, int(uq.shape[1] != runs),
                    max_abs_err(cnt.to(torch.int32), got[1][:runs]))
        b_ms, b_by = bound(n * (2 * 4 + 4 * weighted + 1)
                           + runs * (2 * 4 + 4), 0)
        log(f"time run_reduce, {label}: {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, library (torch.unique_consecutive, unweighted) "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} (2 planes x "
            f"{n} rows, {n_valid} valid, {runs} runs, "
            f"{'weighted' if weighted else 'unweighted'}, cap_out {cap_out}; "
            f"{card}); max |kernel - plain| {e}")
        errs["run_reduce"] = max(errs.get("run_reduce", 0), e)
        if label == "fold":
            times["run_reduce"] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by}
        del planes, inv, w, got, ref, live, uq, cnt
    torch.cuda.empty_cache()
    check(all(v == 0 for v in errs.values()),
          "timing: a count kernel disagrees with its plain version")
    return times, errs


def phase_select_timing(torch, card: str):
    """solid_select at the main path's pass ends (``SELECT_SHAPES``): the
    kernel with the histogram at abundance-min 2 (n_solid read between
    its launches, as the count does), its first launch alone (the
    histogram), its plain version, and the numpy chain it replaces
    (``CountProcessorHistogram`` -> ``CountProcessorSolidity`` ->
    ``CountProcessorCollect`` over the table copied to the host, one run
    on the host clock; its result held against the kernel's). Bound: the
    bytes read once and written once, 4 W + 4 a live row and 4 W + 4 a
    solid row. Returns ({"solid_select": the human shape's times}, {name:
    max |kernel - plain|})."""
    from gatb_core_tpu_torch.kmer.count_processor import (
        CountProcessorChain, CountProcessorCollect, CountProcessorHistogram,
        CountProcessorSolidity)
    from gatb_core_tpu_torch.ops import solid_select as SS

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2020)
    times, err = {}, 0
    for label, w, n, cap, ones, cover in SELECT_SHAPES:
        planes, counts = select_table(torch, w, n, cap, ones, cover, gen)
        bins = torch.zeros((10001,), dtype=torch.int64, device="cuda")
        ms, got = time_ms(torch, lambda y: SS.solid_select(
            planes, y, n, 2, MAX_I32, bins, 10000), counts, fresh=False)
        hist_ms, _ = time_ms(torch, lambda y: SS.solid_histogram(
            y, n, bins, 10000), counts, fresh=False)
        plain_ms, _ = time_ms(torch, lambda y: SS.solid_select_plain(
            planes, y, n, 2, MAX_I32, bins, 10000), counts, fresh=False)
        e = select_err(SS, planes, counts, n, 2, MAX_I32)
        n_solid = got[0].shape[0]
        kmers = planes[:, :n].T.contiguous().cpu().numpy().view(np.uint32)
        c = counts[:n].cpu().numpy()
        t0 = time.perf_counter()
        hist, collect = CountProcessorHistogram(10000), CountProcessorCollect()
        CountProcessorChain(hist, CountProcessorSolidity("sum", (2, MAX_I32)),
                            collect).process_table(0, kmers, c[:, None], c)
        rows, _, sums = collect.result(w)
        chain_ms = (time.perf_counter() - t0) * 1e3
        bins.zero_()
        got = SS.solid_select(planes, counts, n, 2, MAX_I32, bins, 10000)
        same = (np.array_equal(rows, got[0].cpu().numpy().view(np.uint32))
                and np.array_equal(sums, got[1].cpu().numpy())
                and np.array_equal(hist.histogram.bins,
                                   bins.cpu().numpy().astype(np.uint64)))
        e = max(e, int(not same))
        b_ms, b_by = bound(n * (4 * w + 4) + n_solid * (4 * w + 4), 0)
        log(f"time solid_select, {label}: {ms:.4f} ms, histogram alone "
            f"{hist_ms:.4f} ms, plain {plain_ms:.4f} ms, the numpy chain "
            f"it replaces {chain_ms:.1f} ms (host), bound {b_ms:.4f} ms by "
            f"{b_by} ({w} planes x {n} rows of {cap}, {n_solid} solid; "
            f"{card}); max |kernel - plain| {e}")
        err = max(err, e)
        if not times:
            times["solid_select"] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": b_ms, "bound_by": b_by, "chain_ms": chain_ms}
        del planes, counts, bins, got, kmers, c, rows, sums, hist, collect
    torch.cuda.empty_cache()
    check(err == 0, "timing: solid_select disagrees with its plain version "
          "or the numpy chain")
    return times, {"solid_select": err}


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


def rank_err(R, table, queries, live: int, index=None) -> int:
    """max |kernel - plain| over rank and found of one rank_rows call (with
    the table's ``index`` where given, else a transient one)."""
    rank, found = R.rank_rows(table, queries, live, index=index)
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
    # n_table at every leaf-block and level boundary of the index (B rows a
    # node) under a padded tail; one index over several query batches,
    # against the plain binary search and the plain walk of the same index
    for w in (1, 2, 3, 4, 5, 8):
        b = R.node_rows(w)
        for n in (b - 1, b, b + 1, b * b - 1, b * b, b * b + 1, b ** 3 - 1,
                  b ** 3 + 1):
            table, live = sorted_table(torch, S, w, n, n + 7, gen)
            index = R.RankIndex(table, live)
            for q in (1, 1000, (1 << 16) + 5):
                queries = torch.cat([rank_queries(torch, table, live, q, gen),
                                     table[:live]])
                err = max(err, rank_err(R, table, queries, live, index),
                          rank_err(R, table, queries, live))
                walk = R.rank_rows_indexed_plain(index, queries)
                ref = R.rank_rows_plain(table, queries, live)
                err = max(err, max_abs_err(walk[0], ref[0]),
                          max_abs_err(walk[1], ref[1]))
                n_checks += 3
    # a tall index: 2^20 rows of 1 limb, 3 levels above the leaf blocks
    table, live = sorted_table(torch, S, 1, 1 << 20, 1 << 20, gen)
    index = R.RankIndex(table, live)
    check(len(index.lengths) == 3,
          f"rank_rows: 2^20 rows of 1 limb index into "
          f"{len(index.lengths)} levels, not 3")
    err = max(err, rank_err(R, table, rank_queries(torch, table, live,
                                                   1 << 20, gen), live,
                            index))
    n_checks += 1
    # storage off 16-byte alignment: the wrapper hands the kernel a copy
    for w in (2, 4):
        table, live = sorted_table(torch, S, w, 1 << 12, 1 << 12, gen)
        flat = torch.empty(table.numel() + 1, dtype=torch.int32,
                           device="cuda")
        shifted = flat[1:].view_as(table)
        shifted.copy_(table)
        queries = rank_queries(torch, table, live, 1 << 12, gen)
        err = max(err, rank_err(R, shifted, queries, live),
                  rank_err(R, shifted, queries, live,
                           R.RankIndex(shifted, live)))
        n_checks += 2
    R.reset_launches()
    torch.cuda.synchronize()
    log(f"phase 1 rank_rows: {n_checks} inputs, max |kernel - plain| {err}")
    check(err == 0, "rank_rows disagrees with its plain version")
    return err


NEIGHBOR_KS = (11, 16, 17, 31, 32, 33, 63, 65, 95, 111, 127)


def mask_table(torch, k: int, n: int, cap: int, seed: int):
    """The sorted distinct canonical k-mers of a random genome of n + k - 1
    bases (n rows, less the few repeats) under an all-ones padded tail of
    at least cap rows: ((rows, W) int32, live)."""
    from gatb_core_tpu_torch.tools.rank_sweep import genome_rows

    if n == 0:
        return torch.full((max(cap, 1), (k + 15) // 16), -1,
                          dtype=torch.int32, device="cuda"), 0
    rows = genome_rows(torch, k, n + k - 1, seed)
    live, w = rows.shape
    table = torch.full((max(cap, live), w), -1, dtype=torch.int32,
                       device="cuda")
    table[:live] = rows
    return table, live


def mask_nodes(torch, table, live: int, n: int, k: int, gen):
    """n nodes in random order: 6 in 7 drawn from the live rows, the rest
    random k-mers (limb 0 holds only the k-mer's bits)."""
    w = table.shape[1]
    out = torch.randint(-2**31, 2**31 - 1, (n, w), dtype=torch.int32,
                        device="cuda", generator=gen)
    bits = 2 * k - 32 * (w - 1)
    if bits < 32:
        out[:, 0] &= (1 << bits) - 1
    if live and n:
        pick = torch.randint(0, live, (n,), device="cuda", generator=gen)
        keep = torch.arange(n, device="cuda") % 7 != 0
        out = torch.where(keep[:, None], table[pick], out)
    return out.contiguous()


def masks_err(N, table, nodes, live: int, k: int, index=None) -> int:
    """max |kernel - plain| of one neighbor_masks call (through the
    table's ``index`` where given, else a transient one; the plain
    version walks the same index, or searches without one)."""
    got = N.neighbor_masks(nodes, table, live, k, index=index)
    want = N.neighbor_masks_plain(nodes, table, live, k, index)
    if nodes.shape[0] == 0:
        return int(got.shape != want.shape or got.dtype != want.dtype)
    return max_abs_err(got, want)


def phase_masks_kernel(torch) -> int:
    """neighbor_masks against neighbor_masks_plain on the card, bit for
    bit, at every width."""
    from gatb_core_tpu_torch.ops import neighbor_ops as N
    from gatb_core_tpu_torch.ops import rank_search as R

    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    err, n_checks = 0, 0
    for k in NEIGHBOR_KS:
        table, live = mask_table(torch, k, 50_000, 50_013, seed=k)
        nodes = torch.cat([mask_nodes(torch, table, live, 20_000, k, gen),
                           torch.full((1, table.shape[1]), -1,
                                      dtype=torch.int32, device="cuda")])
        for n in (live, live - 3, 1, 0):
            index = R.RankIndex(table, n)
            for q in (nodes, nodes[:1].contiguous(), nodes[:0]):
                err = max(err, masks_err(N, table, q, n, k, index),
                          masks_err(N, table, q, n, k))
                n_checks += 2
        # storage off 16-byte alignment: the wrapper hands the kernel copies
        shifted = []
        for x in (nodes, table):
            flat = torch.empty(x.numel() + 1, dtype=torch.int32,
                               device="cuda")
            shifted.append(flat[1:].view_as(x))
            shifted[-1].copy_(x)
        err = max(err, max_abs_err(
            N.neighbor_masks(shifted[0], shifted[1], live, k),
            N.neighbor_masks_plain(nodes, table, live, k)))
        n_checks += 1
    N.reset_launches()
    torch.cuda.synchronize()
    log(f"phase 1 neighbor_masks: {n_checks} inputs at k {NEIGHBOR_KS}, "
        f"max |kernel - plain| {err}")
    check(err == 0, "neighbor_masks disagrees with its plain version")
    return err


def phase_masks_timing(torch, card: str):
    """neighbor_masks at the two mask shapes of rank_sweep.py (CUDA
    events, median after warm-up; the host clock with a synchronise
    beside): 71,000 query nodes and the 2^21-node sweep step on the
    30M-row k=31 table, through its index, beside the chain it replaces
    (neighbor_candidates, rank_rows, the pack) and rank_rows alone on the
    same 8 N candidates, each result held against the chain's and the
    plain version's. The bound counts a node's row read, 8 table rows
    read and one byte written per node. Returns ({ms, plain_ms,
    library_ms, bound_ms, bound_by} of the query shape and every shape
    under ``shapes``, max |kernel - chain|: 0, or a raise)."""
    from gatb_core_tpu_torch.ops import neighbor_ops as N
    from gatb_core_tpu_torch.ops import rank_search as R
    from gatb_core_tpu_torch.tools import rank_sweep as RS

    res = {}
    for name, table, nodes in RS.mask_shapes(torch):
        try:
            r = RS.measure_masks(torch, R, N, table, nodes, 31)
        except RuntimeError as e:
            raise Failure(f"timing: {e}")
        m, w = nodes.shape
        r["bound_ms"], r["bound_by"] = bound(m * w * 4 + 8 * m * w * 4 + m,
                                             0)
        log(f"time neighbor_masks ({name}): {r['ms']:.4f} ms through the "
            f"index ({r['wall_ms']:.4f} ms on the host's clock), the chain "
            f"it replaces {r['chain_ms']:.4f} ms ({r['chain_wall_ms']:.4f}), "
            f"rank_rows alone on the {8 * m} candidates "
            f"{r['rank_rows_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']} ({m} nodes of {w} limbs on {r['n_table']} "
            f"rows, {r['nonzero']} masks not 0); {card}")
        res[name] = r
        del table, nodes
    torch.cuda.empty_cache()
    times = {"ms": res["q"]["ms"], "plain_ms": res["q"]["chain_ms"],
             "library_ms": None, "bound_ms": res["q"]["bound_ms"],
             "bound_by": res["q"]["bound_by"], "shapes": res}
    return times, 0


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
    """rank_rows at the four shapes of gatb_core_tpu_torch/tools/
    rank_sweep.py (CUDA events, median after warm-up): (a) 8 x 2^20
    random-order queries, half present, on 2^20 random rows of 2 and of 4
    limbs; (b) the stress sweep step, the candidates of 2^21 sorted nodes
    (2^24 queries) of the canonical 31-mers of a random 30 Mbp genome (the
    main path's shape); (c) 2^24 random-order queries, half present, on the
    same table (node_index traffic); (d) the candidate sweep of a k=63
    table of 523,394 rows. For each: the kernel with the table's index
    built (``ms``), the index build (``index_ms``), the one-shot call that
    builds a transient index (``one_shot_ms``), the plain version, and
    torch.searchsorted on the rows joined into int64 keys at 2 limbs (the
    join made before the clock; the lower bound only), every result held
    against the plain version's and the found rows' ranks against that
    lower bound. At (a) also the co-sort through
    sort_u32_limbs (the JAX formulation) and neighbor_candidates of the
    table. The bound counts the queries read once, the live table read
    once and 5 bytes written per query. Returns ({ms, plain_ms,
    library_ms, bound_ms, bound_by, index_ms} of shape (b) and every shape
    under ``shapes``, max |kernel - plain|)."""
    from gatb_core_tpu_torch.ops.neighbor_ops import neighbor_candidates
    from gatb_core_tpu_torch.tools import rank_sweep as RS

    res, err = {}, 0
    for name, table, queries in RS.shapes(torch, neighbor_candidates):
        try:
            r = RS.measure(torch, R, table, queries)
        except RuntimeError as e:
            raise Failure(f"timing: {e}")
        n, w = table.shape
        q = queries.shape[0]
        r["bound_ms"], r["bound_by"] = bound(q * w * 4 + n * w * 4 + q * 5,
                                             q * (n.bit_length() + 1))
        extra = ""
        err = max(err, r["library_err"] or 0)
        if name.startswith("a"):
            live = n
            co_ms, co = time_ms(
                torch, lambda y: rank_cosort(torch, S, table, y, live),
                queries, fresh=False)
            ref = R.rank_rows_plain(table, queries, live)
            err = max(err, max_abs_err(co[0], ref[0]),
                      max_abs_err(co[1], ref[1]))
            nc_ms, _ = time_ms(
                torch, lambda y: neighbor_candidates(y, 16 * w - 1), table,
                fresh=False)
            r["cosort_ms"], r["neighbor_candidates_ms"] = co_ms, nc_ms
            extra = (f", co-sort through sort_u32_limbs {co_ms:.4f} ms, "
                     f"neighbor_candidates of {n} nodes {nc_ms:.4f} ms")
            del co, ref
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        log(f"time rank_rows ({name}): {r['ms']:.4f} ms with the index "
            f"built ({r['levels']} levels, {r['index_mib']:.2f} MiB), index "
            f"build {r['index_ms']:.4f} ms, one-shot {r['one_shot_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library (torch.searchsorted of "
            f"int64 keys) {lib}, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({q} queries of {w} limbs on {n} rows, "
            f"{r['found']} found){extra}; {card}")
        res[name] = r
        del table, queries
    torch.cuda.empty_cache()
    check(err == 0, "timing: rank_rows disagrees with its plain version, "
          "the co-sort or torch.searchsorted")
    times = {key: res["b"][key] for key in ("ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by",
                                            "index_ms", "one_shot_ms")}
    times["shapes"] = res
    return times, err


def phase_shapes(torch, S, R, shapes: dict) -> dict:
    """Every kernel against its plain version at each argument shape the
    count phases launched it with, on random and on heavy-duplicate
    inputs. Returns max |kernel - plain| per kernel."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    err = {name: 0 for name in REPLACES}
    n_checks = 0
    # rank_rows: a sorted table of the launch's live rows under its padded
    # tail, and its index; queries half present, half random
    tables = {}
    for w, cap, n_table, q in sorted(shapes["rank_rows"]):
        if (w, cap, n_table) not in tables:
            tables.clear()              # one table alive at a time
            table, live = sorted_table(torch, S, w, n_table, cap, gen)
            tables[(w, cap, n_table)] = (table, live,
                                         R.RankIndex(table, live))
        table, live, index = tables[(w, cap, n_table)]
        queries = rank_queries(torch, table, live, q, gen)
        err["rank_rows"] = max(err["rank_rows"],
                               rank_err(R, table, queries, live, index))
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
    # extract_planes: random reads of the launch's shape, the last pass
    _, K, T, N, SS = wrapper_modules()
    for k, L, r, nw, nv, cap, m, nb_passes in sorted(
            shapes["extract_planes"]):
        words, vmask, lengths = packed_batch(torch, r, L, k, gen, nv == 0)
        words = torch.cat([words, torch.randint(
            -2**31, 2**31 - 1, (r, nw - words.shape[1]), dtype=torch.int32,
            device="cuda", generator=gen)], dim=1)
        if vmask is not None and nv > vmask.shape[1]:
            vmask = torch.cat([vmask, torch.full(
                (r, nv - vmask.shape[1]), -1, dtype=torch.int32,
                device="cuda")], dim=1)
        err["extract_planes"] = max(err["extract_planes"], extract_err(
            K, words, vmask, lengths, k, L, cap, nb_passes, nb_passes - 1,
            m or 10))
        n_checks += 1
        del words, vmask, lengths
    # run_reduce: sorted rows of the launch's shape, a tenth invalid
    for P, n, b, cap_out in sorted(shapes["run_reduce"]):
        planes, inv = run_planes(torch, P, n, n - n // 10, gen)
        err["run_reduce"] = max(err["run_reduce"], reduce_err(
            T, planes, inv, reduce_weights(torch, b, n, gen), cap_out))
        n_checks += 1
        del planes, inv
    # solid_select: a skewed table of the launch's shape
    for w, n, cap, histo_max in sorted(shapes["solid_select"]):
        planes, counts = select_table(torch, w, n, cap, 0.8, 30, gen)
        err["solid_select"] = max(err["solid_select"], select_err(
            SS, planes, counts, n, 2, MAX_I32, histo_max))
        n_checks += 1
        del planes, counts
    # neighbor_masks: a genome's k-mers of the launch's live rows under its
    # padded tail, and its index; nodes 6 in 7 present
    for w, k, cap, n_table, n in sorted(shapes["neighbor_masks"]):
        if (w, k, cap, n_table) not in tables:
            tables.clear()
            table, live = mask_table(torch, k, n_table, cap, seed=n_table)
            tables[(w, k, cap, n_table)] = (table, live,
                                            R.RankIndex(table, live))
        table, live, index = tables[(w, k, cap, n_table)]
        nodes = mask_nodes(torch, table, live, n, k, gen)
        err["neighbor_masks"] = max(err["neighbor_masks"],
                                    masks_err(N, table, nodes, live, k, index))
        n_checks += 1
        del nodes
    tables.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 5 main-path shapes: {n_checks} checks over "
        f"{ {k: len(v) for k, v in shapes.items()} } shapes, "
        f"max |kernel - plain| {err}")
    check(all(v == 0 for v in err.values()),
          "main-path shapes: a kernel disagrees with its plain version")
    return err


def wrapper_modules():
    """The modules whose wrappers count kernel launches, bar limb_sort:
    the rank search, the extraction, the distinct reduce, the neighbour
    masks and the solid select."""
    from gatb_core_tpu_torch.ops import kmer_ops as K
    from gatb_core_tpu_torch.ops import neighbor_ops as N
    from gatb_core_tpu_torch.ops import rank_search as R
    from gatb_core_tpu_torch.ops import solid_select as SS
    from gatb_core_tpu_torch.ops import sortops as T

    return R, K, T, N, SS


def launch_counts(S) -> tuple:
    """(launches, launch shapes) of every wrapper since its last reset."""
    mods = (S,) + wrapper_modules()
    got, shapes = {}, {}
    for mod in mods:
        got.update(mod.launches)
        shapes.update({k: set(v) for k, v in mod.launch_shapes.items()})
    return got, shapes


def reset_counts(S) -> None:
    for mod in (S,) + wrapper_modules():
        mod.reset_launches()


def counted(S, name: str, fn, path=SORT_KERNELS):
    """Run fn with the launch counters (the limb-sort wrappers', the rank
    search's, the extraction's and the reduce's) and the rank index's
    build counter at 0; require every kernel of its path to have launched.
    Returns fn's result, the counts and the launch shapes."""
    from gatb_core_tpu_torch.ops import rank_search as R

    reset_counts(S)
    out = fn()
    got, shapes = launch_counts(S)
    got.update(R.builds)
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
        path, kmer_size=31, abundance_min=3, superbatch_rows=1 << 22), path=SELECT_COUNT_KERNELS)
    wall = time.time() - t0
    SINGLE_S["bench count"] = wall
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
        path, kmer_size=63, abundance_min=1), path=SELECT_COUNT_KERNELS)
    wall = time.time() - t0
    SINGLE_S["k=63 count"] = wall
    rows, cnts = truth_k63(reads)
    log(f"phase 3 k=63: count {wall:.3f} s, distinct "
        f"{res.info['kmers_nb_distinct']} (numpy {len(rows)})")
    check(res.solid_kmers.shape[1] == 4, "k=63: four limbs")
    check(np.array_equal(res.solid_kmers, rows)
          and np.array_equal(res.solid_counts, cnts),
          "k=63: table differs from the numpy ground truth")
    return path, res


def stress_count(tally, S, count_kmers, path: str, name: str, card: str,
                 **kw):
    """One count of the stress bank: the known exact result, a sorted
    table, and the run's stopwatches in the log."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res, got = tally.counted(S, name, lambda: count_kmers(
        path, kmer_size=31, abundance_min=3, superbatch_rows=1 << 25,
        nb_passes=1, **kw), path=SELECT_COUNT_KERNELS)
    wall = time.time() - t0
    SINGLE_S[name] = wall
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
                superbatch_rows=1 << 22, carry_accumulator=False, **kw), path=SELECT_COUNT_KERNELS)
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
                paths, kmer_size=31, abundance_min=3, solidity_kind=kind), path=COUNT_KERNELS)
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
        build_branching=False, superbatch_rows=1 << 22), path=SELECT_COUNT_KERNELS)
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


def rank_candidates_err(graph) -> int:
    """max |kernel - plain| of rank_rows over the 8 neighbour candidates
    of every node of a graph's (canonical, so skewed) table, through the
    graph's index."""
    from gatb_core_tpu_torch.ops import rank_search as R
    from gatb_core_tpu_torch.ops.neighbor_ops import neighbor_candidates

    table, n = graph._padded_table(), graph.nb_nodes
    q = R.as_rows(neighbor_candidates(table, graph._k)
                  .reshape(-1, table.shape[1]))
    return rank_err(R, table, q, n, graph._set.index)


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
        build_branching=True, superbatch_rows=1 << 22), path=BUILD_KERNELS)
    wall = time.time() - t0
    check(got["rank_index"] == 1, "9a: the table's index not built once")
    check(rank_candidates_err(graph) == 0,
          "9a: rank_rows disagrees with its plain version on the table's "
          "candidates")
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
        build_branching=True), path=BUILD_KERNELS)
    wall = time.time() - t0
    check(got["rank_index"] == 1, "9b: the table's index not built once")
    check(rank_candidates_err(graph) == 0,
          "9b: rank_rows disagrees with its plain version on the table's "
          "candidates")
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
    step (one neighbor_masks launch) beside the chain it replaces."""
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
    index = graph._set.index
    rank_ms, (_, solid) = time_ms(
        torch, lambda q: R.rank_rows(table, q, n, index=index), rows, warm=1,
        reps=3, fresh=False)
    hit = in_bloom & ~solid
    dedup_ms, _ = time_ms(torch, lambda q: _dedup_rows(q, hit, len(q) // 8),
                          rows, warm=1, reps=3, fresh=False)
    adj_ms, _ = time_ms(
        torch, lambda t: _adjacency_kernel(t, table, 31, n, index), nodes,
        warm=1, reps=3, fresh=False)
    weights = 1 << torch.arange(8, dtype=torch.int32, device="cuda")
    chain_ms, _ = time_ms(
        torch, lambda t: (R.rank_rows(table, as_rows(neighbor_candidates(
            t, 31).reshape(-1, 2)), n, index=index)[1].reshape(-1, 8)
            .to(torch.int32) * weights).sum(dim=1).to(torch.uint8), nodes,
        warm=1, reps=3, fresh=False)
    log(f"phase 9c breakdown: Bloom build over {n} nodes ({b.size_bits} "
        f"bits, {b.n_hash} hashes, kind {b.kind}) {build_ms:.3f} ms; one "
        f"sweep step of {len(nodes)} nodes: neighbor_candidates "
        f"{cand_ms:.3f} ms, Bloom probe of {len(flat)} candidates "
        f"{probe_ms:.3f} ms, rank_rows {rank_ms:.3f} ms, dedup of "
        f"{int(hit.sum())} hits (sort + reduce) {dedup_ms:.3f} ms; one "
        f"adjacency step (neighbor_masks) {adj_ms:.3f} ms, the chain it "
        f"replaces (candidates + rank_rows + pack) {chain_ms:.3f} ms; "
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
                               path=BUILD_KERNELS)
    wall = time.time() - t0
    chunks = -(-29_999_950 // sweep_chunk(29_999_950))
    check(got["rank_rows"] == chunks,
          "9c: rank_rows is not one launch per debloom sweep chunk")
    check(got["neighbor_masks"] == chunks,
          "9c: neighbor_masks is not one launch per adjacency sweep chunk")
    check(got["rank_index"] == 1, "9c: the table's index not built once")
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
    # phase 10's MPHF build overwrites postsolid_time; phase 14a reads these
    SINGLE_S["stress postsolid stages"] = stage_times(info)
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
        err = max(err, rank_err(R, table, q, n, graph._set.index))
        chunks += 1
        del q
    log(f"phase 9c: rank_rows against its plain version on {chunks} chunks "
        f"of up to {8 * step} queries: max |kernel - plain| {err}")
    check(err == 0, "9c: rank_rows disagrees with its plain version")
    return got, err, graph, pick


# ---------------------------------------------------------------------------
# phase 15: the graph and bank tools on the card, and a graph written to disk
# ---------------------------------------------------------------------------

# time-valued properties by property file: the configuration's xml dump
# holds Graph.info, whose postsolid_time.* values are wall times
TIME_VALUED = {"configuration.json": ("xml",)}
CHECK_KEYS = ("nbSolids", "nbSuccessors", "nbBranching", "checkumNodes",
              "checksumSuccessors", "checksumBranching", "abundance",
              "abundanceBranching")


def check_block(stats: dict) -> list:
    """dbgcheck's printed lines for ``stats``, less the time line."""
    return [""] + [f"{key:<18} = {stats[key]}  " for key in CHECK_KEYS] \
        + [""]


def topology_block(n: int, mat: np.ndarray) -> list:
    """dbgtopology's printed lines."""
    return [f"nodes: {n}", "in\\out " + " ".join(f"{j:>8}" for j in
                                                 range(5))] \
        + [f"{i:>6} " + " ".join(f"{mat[i, j]:>8}" for j in range(5))
           for i in range(5)] \
        + [f"branching (in!=1 or out!=1): {int(mat.sum() - mat[1, 1])}"]


def profiled(torch, fn):
    """(fn(), wall s, device s) with fn run under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    return out, wall, sum(r[1] for r in device_events(torch, prof)) / 1e6


def storage_files(folder: str) -> dict:
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = f.read()
    return out


def check_stored_graph(graph, st) -> None:
    """Phase 15d: every blob of a graph's FileStorage read back equal to
    the graph's arrays in memory, every stage's state bit set."""
    from gatb_core_tpu_torch.convert import u32_to_numpy
    from gatb_core_tpu_torch.storage import hdf5 as H

    def records(limbs, counts):
        out = np.zeros(len(counts), H.count_dtype(1))
        out["value"] = H.limbs_to_words64(limbs)
        out["abundance"] = counts
        return out

    deb, mphf = graph._debloom, graph._mphf
    casc = st.group("debloom").group("cascading")
    t4 = H.limbs_to_words64(deb.cascade.t4)
    blobs = [
        (st.group("dsk"), "solid",
         records(graph.solid_limbs, graph.solid_counts)),
        (st.group("bloom"), "bloom", deb.bloom.to_numpy()),
        (st.group("debloom"), "cfp_all", H.limbs_to_words64(deb.cfp)),
        (st.group("debloom"), "cfp", t4), (casc, "t4", t4),
        (st.group("adjacency"), "masks", graph._adjacency),
        (st.group("branching"), "nodes",
         records(graph._branching, graph._branching_counts)),
        (st.group("mphf"), "bits", u32_to_numpy(mphf.bits)),
        (st.group("mphf"), "fallback_keys", u32_to_numpy(mphf.fallback_keys)),
        (st.group("mphf"), "abundance", graph.abundance_codes)]
    blobs += [(casc.group(f"bloom{i + 2}"), "bloom", b.to_numpy())
              for i, b in enumerate(deb.cascade.blooms)]
    blobs += [(st.group("mphf"), name, getattr(mphf, name).cpu().numpy())
              for name in ("prefix", "perm", "fallback_ranks")]
    for group, name, want in blobs:
        got = group.get_dataset(name)
        check(got is not None and got.dtype == want.dtype
              and got.shape == want.shape
              and got.tobytes() == want.tobytes(),
              f"15d: {group._id}/{name} read back differs from memory")
    for bit in ("CONFIGURATION", "SORTING_COUNT", "MPHF", "BLOOM",
                "DEBLOOM", "ADJACENCY", "BRANCHING"):
        check(st.check_state(getattr(H, f"STATE_{bit}_DONE")),
              f"15d: state bit {bit}_DONE not set")


def stored_graph(folder: str, limbs, counts, device):
    """Phase 15d: Graph(31, table) with a FileStorage, its postsolid
    stages with the default flags, then save_solid and save_config."""
    from gatb_core_tpu_torch.debruijn.graph import Graph
    from gatb_core_tpu_torch.storage import hdf5 as H
    from gatb_core_tpu_torch.storage.filedir import FileStorage

    t0 = time.time()
    st = FileStorage(folder, "w")
    g = Graph(31, limbs, counts, storage=st, device=device)
    g.build_postsolid()
    H.save_solid(st, g.solid_limbs, g.solid_counts, 31)
    H.save_config(st, g.info)
    return g, st, time.time() - t0


def phase_tools(tally, S, torch, bench_path: str, truth, stress, tmp: str,
                card: str):
    """Phase 15: dbgcheck and dbgtopology in-process on the bench graph
    against numpy and a CPU graph, both CLIs and kmer_checksum as
    processes on the card, the graph's stages through FileStorage on the
    card and the CPU, system.info; then check_graph on the stress graph.
    The processes and the CPU build (a thread) run while this thread
    checks the card's results; each step's time is logged from the
    phase's start."""
    from concurrent.futures import ThreadPoolExecutor

    from gatb_core_tpu_torch.collections.containers import BagCache, \
        BagFile
    from gatb_core_tpu_torch.debruijn.graph import Graph
    from gatb_core_tpu_torch.system.info import SystemInfo, library_info
    from gatb_core_tpu_torch.tools.dbgcheck import check_graph, largeint_hex
    from gatb_core_tpu_torch.tools.dbgtopology import topology_matrix

    t_phase = time.time()
    secs, at = {}, {}
    procs = {}

    def start(name, *args):
        procs[name] = (time.time(), subprocess.Popen(
            [sys.executable, "-m", f"gatb_core_tpu_torch.tools.{name}",
             *args], cwd=tmp, env=dict(os.environ, PYTHONPATH=HERE),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def finish(name) -> list:
        t0, proc = procs[name]
        out, _ = proc.communicate(timeout=600)
        secs[f"{name} process"] = time.time() - t0
        check(proc.returncode == 0, f"15: {name} failed: {out[-2000:]}")
        return out.splitlines()

    def done(step, t0):
        secs[step] = time.time() - t0
        at[step] = time.time() - t_phase

    pool = ThreadPoolExecutor(1)
    try:
        # (b) both CLIs as processes on the card: they take seconds to
        # reach it, so they start first
        args = ["-in", bench_path, "-kmer-size", "31", "-abundance-min", "3"]
        start("dbgcheck", *args)
        start("dbgtopology", *args)
        # (a) in-process on the card
        t0 = time.time()
        graph, got_c = tally.counted(
            S, "phase 15a Graph.create", lambda: Graph.create(
                bank=bench_path, kmer_size=31, abundance_min=3,
                build_branching=False), path=GRAPH_KERNELS)
        done("create", t0)
        t0 = time.time()
        stats, got_k = tally.counted(
            S, "phase 15a check_graph", lambda: check_graph(graph),
            path=("neighbor_masks",))
        torch.cuda.synchronize()
        done("check_graph", t0)
        t0 = time.time()
        mat = topology_matrix(graph)
        done("topology_matrix", t0)
        # (d) the same stages built on the CPU from the card's table, in a
        # thread while this one checks the card's
        cpu_job = pool.submit(stored_graph, os.path.join(tmp, "g_cpu"),
                              graph.solid_limbs, graph.solid_counts, "cpu")
        # (c) the table's k-mer values as BagFile records, kmer_checksum
        t0 = time.time()
        values = limbs_to_u64(graph.solid_limbs)
        bag_path = os.path.join(tmp, "bench_kmers.bin")
        with BagFile(bag_path) as bag:
            cache = BagCache(bag)
            for v in values.view(np.int64).tolist():
                cache.insert(v)
            cache.flush()
        done("BagFile write", t0)
        start("kmer_checksum", bag_path)
        # (a) against numpy
        t0 = time.time()
        vals, cnts = truth
        solid = cnts >= 3
        nodes, counts = vals[solid], cnts[solid].astype(np.int64)
        cands = neighbors_u64(nodes, 31)
        member = member_u64(nodes, cands.ravel()).reshape(-1, 8)
        masks = masks_of(member)
        br = branching_of(masks)
        want = {
            "nbSolids": len(nodes),
            "nbSuccessors": int(member[:, :4].sum()),
            "nbBranching": int(br.sum()),
            "checkumNodes": largeint_hex(sum(nodes.tolist()), 1),
            "checksumSuccessors": largeint_hex(
                sum(cands[:, :4][member[:, :4]].tolist()), 1),
            "checksumBranching": largeint_hex(sum(nodes[br].tolist()), 1),
            "abundance": int(counts.sum()),
            "abundanceBranching": int(counts[br].sum())}
        check({k: stats[k] for k in CHECK_KEYS} == want,
              f"15a: check_graph {stats} differs from numpy {want}")
        want_mat = np.zeros((5, 5), np.int64)
        np.add.at(want_mat, (popcount4(masks >> 4).astype(np.int64),
                             popcount4(masks & 0x0F).astype(np.int64)), 1)
        check(np.array_equal(mat, want_mat),
              "15a: topology_matrix differs from numpy")
        done("numpy truth", t0)
        # (d) on the card, every blob read back
        card_g, st, secs["FileStorage build on the card"] = stored_graph(
            os.path.join(tmp, "g"), graph.solid_limbs, graph.solid_counts,
            "cuda")
        t0 = time.time()
        check_stored_graph(card_g, st)
        done("read back", t0)
        # (e) system info
        info, lib = SystemInfo.version_info(), library_info()
        check(info["devices"] and info["devices"][0]
              == torch.cuda.get_device_name(0)
              == card_line().split(",")[0].strip()
              and info["cuda"] == torch.version.cuda
              and lib["torch"] == torch.__version__,
              f"15e: system info {info} differs from nvidia-smi")
        # (d) against the CPU's build, then (a)'s two calls on the CPU graph
        cpu_g, st_cpu, secs["FileStorage build on the CPU"] = \
            cpu_job.result()
        at["FileStorage build on the CPU"] = time.time() - t_phase
        files, files_cpu = storage_files(st.folder), \
            storage_files(st_cpu.folder)
        check(sorted(files) == sorted(files_cpu),
              "15d: the card's and the CPU's storage trees differ")
        data = [n for n in files if n.endswith(".data")]
        check(all(files[n] == files_cpu[n] for n in data),
              "15d: a .data file differs between the card and the CPU")
        for n in files:
            if n.endswith(".json"):
                a, b = json.loads(files[n]), json.loads(files_cpu[n])
                skip = TIME_VALUED.get(n, ())
                check(sorted(a) == sorted(b) and all(
                    a[k] == b[k] for k in a if k not in skip),
                    f"15d: properties of {n} differ")
        t0 = time.time()
        stats_cpu = check_graph(cpu_g)
        check({k: stats_cpu[k] for k in CHECK_KEYS}
              == {k: stats[k] for k in CHECK_KEYS}
              and np.array_equal(topology_matrix(cpu_g), mat),
              "15a: check_graph or topology_matrix differ on the CPU")
        done("check_graph on the CPU", t0)
        # (b), (c): the processes' printed blocks
        out = [line for line in finish("dbgcheck")
               if not line.startswith("time ")]
        check(out[-len(CHECK_KEYS) - 2:] == check_block(stats),
              f"15b: dbgcheck printed {out[-12:]}")
        out = finish("dbgtopology")
        check(out[-8:] == topology_block(graph.nb_nodes, mat),
              f"15b: dbgtopology printed {out[-8:]}")
        out = finish("kmer_checksum")
        check(out[-1] == f"FOUND {stats['nbSolids']} WITH CHECKSUM "
              f"{stats['checkumNodes'] or '0'}",
              f"15c: kmer_checksum printed {out[-1:]}")
        at["processes"] = time.time() - t_phase
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
        pool.shutdown(wait=True)
    os.remove(bag_path)
    # the stress graph (phase 9c) holds its adjacency: no launch; its
    # device-time share under torch.profiler, the card to itself again
    t0 = time.time()
    (got_s, s_wall, s_dev), got_sk = tally.counted(
        S, "phase 15 stress check_graph", lambda: profiled(
            torch, lambda: check_graph(stress)), path=())
    s_all = time.time() - t0
    adj = stress._adjacency
    check(got_sk["rank_rows"] == 0 and got_sk["neighbor_masks"] == 0,
          "15: check_graph on the stress graph launched a kernel")
    check(got_s["checksumBranching"] == stress.checksum_branching()
          and got_s["nbSuccessors"] == int(popcount4(adj & 0x0F).sum(
              dtype=np.int64))
          and got_s["abundance"] == int(stress.solid_counts.sum(
              dtype=np.int64)),
          f"15: check_graph on the stress graph: {got_s}")
    log(f"phase 15 tools: bench graph {graph.nb_nodes} nodes; check_graph "
        f"{ {k: stats[k] for k in CHECK_KEYS} } equal to numpy, to a CPU "
        f"graph and to the dbgcheck process; topology equal likewise; "
        f"kmer_checksum process equal; FileStorage: {len(data)} .data "
        f"files of the card's build byte-equal to the CPU's, every blob "
        f"read back equal, every stage's bit set; step walls "
        + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
        + "; done at (s from the phase's start) "
        + ", ".join(f"{k} {v:.1f}" for k, v in at.items())
        + f"; stress check_graph ({stress.nb_nodes} nodes, adjacency held, "
        f"no launch) {s_wall:.3f} s wall under the profiler, device "
        f"{s_dev:.4f} s (share {s_dev / s_wall:.3f}), {s_all:.1f} s with "
        f"the profiler's start and read-out; phase "
        f"{time.time() - t_phase:.1f} s; {card}")
    return {"create": got_c, "check_graph": got_k, "stress": got_sk}


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
    # the BooPHF's one query builds its fallback keys' index; node_index
    # walks the graph's
    check(got["rank_index"] == int(m.fallback_keys.shape[0] > 0),
          f"10 {name}: rank index builds")
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
    index = graph._set.index
    rank_ms, (b, _) = time_ms(
        torch, lambda y: R.rank_rows(table, y, n, index=index), q, warm=1,
        reps=5, fresh=False)
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
    check(got["rank_index"] == 0,
          f"11 {name}: the sweep did not walk the graph's index")
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
            bank=path, kmer_size=k, abundance_min=2), path=BUILD_KERNELS)
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
    check(got_create["rank_index"] == 1 and got["rank_index"] == 0,
          f"12{name}: the table's index not built once")
    simp = graph._simplifications
    record = simplify_record(graph, simp, stats, contigs)
    t1 = time.time()
    ug, got_ug = tally.counted(S, f"phase 12{name} unitig_graph",
                               graph.unitig_graph, path=("rank_rows",))
    ug_s = time.time() - t1
    check(got_ug["rank_rows"] == chunks and got_ug["rank_index"] == 0,
          f"12{name}: unitig_graph is not one sweep of the graph's index")
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
    check(got["rank_rows"] == -(-n // sweep_chunk(n))
          and got["rank_index"] == 0,
          "12c: rank_rows is not one launch per chunk of one sweep of the "
          "graph's index")
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


# ---------------------------------------------------------------------------
# phase 13: the stacked merges, the linear counter and Leon
# ---------------------------------------------------------------------------


def bank_kmers_on_card(torch, reads: np.ndarray, k: int, rows: int):
    """The first ``rows`` canonical k-mers of ``reads`` (read by read, as
    extraction lays them out) as (rows, W) int32 limbs on the card."""
    from gatb_core_tpu_torch.ops.kmer_ops import extract_kmers

    out, have, step = [], 0, 20_000
    for i in range(0, len(reads), step):
        codes = torch.from_numpy(reads[i:i + step]).cuda()
        kb = extract_kmers(codes, torch.ones_like(codes, dtype=torch.bool),
                           torch.full((len(codes),), codes.shape[1],
                                      dtype=torch.int32, device="cuda"),
                           k, with_minimizers=False)
        out.append(kb.kmers.reshape(-1, kb.kmers.shape[-1]).to(torch.int32))
        have += out[-1].shape[0]
        if have >= rows:
            break
    check(have >= rows, "phase 13a: too few k-mers in the bank")
    return torch.cat(out)[:rows].contiguous()


class plain_merges:
    """Within the block, ops.sortops sorts and merges with the kernels'
    plain versions (on the card's tensors)."""

    def __enter__(self):
        from gatb_core_tpu_torch.ops import limb_sort as S
        from gatb_core_tpu_torch.ops import sortops as T

        self.saved = (T.merge_sorted_runs, T.sort_u32_limbs)
        T.merge_sorted_runs = lambda x, run: S.merge_sorted_runs_plain(x,
                                                                       run)
        T.sort_u32_limbs = S.sort_u32_limbs_plain
        return self

    def __exit__(self, *exc):
        from gatb_core_tpu_torch.ops import sortops as T

        T.merge_sorted_runs, T.sort_u32_limbs = self.saved


def same_count_table(a, b) -> bool:
    return (a.kmers.shape == b.kmers.shape
            and bool((a.kmers == b.kmers).all())
            and bool((a.counts == b.counts).all()) and int(a.n) == int(b.n))


def stacked_case(tally, S, torch, reads, k: int, nb: int, cap: int,
                 card: str, timed: bool):
    """``nb`` tables of capacity ``cap`` from ``count_batch`` over chunks
    of the bank's k-mers through the three stacked merges: equal to one
    another, to numpy's unique of the k-mers and to the plain path on the
    card; the capped tree at the distinct count rounded up (no overflow)
    and below it (overflow). Returns the tree's launches."""
    from gatb_core_tpu_torch.ops import sortops as T

    w = (2 * k + 31) // 32
    rows = bank_kmers_on_card(torch, reads, k, nb * cap)
    ks, cs = [], []
    for i in range(nb):
        t = T.count_batch(rows[i * cap:(i + 1) * cap],
                          torch.ones(cap, dtype=torch.bool, device="cuda"),
                          spare_bits=(2 * k) % 32 != 0)
        check(t.capacity == cap, "phase 13a: count_batch capacity")
        ks.append(t.kmers)
        cs.append(t.counts)
    kmers, counts = torch.stack(ks), torch.stack(cs)
    del ks, cs
    host = rows.cpu().numpy().view(np.uint32)
    del rows
    if w == 2:
        uniq, cnt = np.unique((host[:, 0].astype(np.uint64) << np.uint64(32))
                              | host[:, 1], return_counts=True)
        uniq = np.stack([(uniq >> np.uint64(32)).astype(np.uint32),
                         uniq.astype(np.uint32)], axis=1)
    else:
        uniq, cnt = np.unique(host, axis=0, return_counts=True)
    distinct = len(uniq)
    name = f"phase 13a stacked merges k={k}"
    tree, got = tally.counted(S, f"{name} tree", lambda: T.merge_stacked_tree(
        kmers, counts), path=("merge_partition", "merge_tiles"))
    levels = nb.bit_length() - 1
    check(got["merge_partition"] == got["merge_tiles"] == levels
          and got["tile_sort"] == 0,
          f"{name}: the tree is not two merge launches a level")
    check(int(tree.n) == distinct and tree.capacity == nb * cap
          and np.array_equal(tree.kmers[:distinct].cpu().numpy()
                             .view(np.uint32), uniq)
          and np.array_equal(tree.counts[:distinct].cpu().numpy(), cnt),
          f"{name}: the tree differs from numpy's unique")
    cap_ok = T._next_pow2(distinct)
    (capped, ov), got_c = tally.counted(
        S, f"{name} capped", lambda: T.merge_stacked_tree_capped(
            kmers, counts, cap_ok), path=("merge_partition", "merge_tiles"))
    check(got_c["merge_tiles"] == levels and not bool(ov)
          and capped.capacity == min(cap_ok, nb * cap)
          and int(capped.n) == distinct
          and bool((capped.kmers[:distinct] == tree.kmers[:distinct]).all())
          and bool((capped.counts[:distinct]
                    == tree.counts[:distinct]).all()),
          f"{name}: the capped tree differs from the tree")
    low, ov_low = T.merge_stacked_tree_capped(kmers, counts, distinct // 2)
    check(bool(ov_low), f"{name}: the capped tree missed its overflow")
    flat, got_s = tally.counted(S, f"{name} merge_stacked",
                                lambda: T.merge_stacked(kmers, counts))
    check(got_s["tile_sort"] == 1 and same_count_table(flat, tree),
          f"{name}: merge_stacked differs from the tree")
    with plain_merges():
        p_tree = T.merge_stacked_tree(kmers, counts)
        p_capped, p_ov = T.merge_stacked_tree_capped(kmers, counts, cap_ok)
        p_low, p_ov_low = T.merge_stacked_tree_capped(kmers, counts,
                                                      distinct // 2)
        p_flat = T.merge_stacked(kmers, counts)
    check(same_count_table(p_tree, tree) and same_count_table(p_capped,
                                                               capped)
          and same_count_table(p_low, low) and same_count_table(p_flat, flat)
          and bool(p_ov) is bool(ov) and bool(p_ov_low) is bool(ov_low),
          f"{name}: the kernel path differs from the plain path")
    msg = (f"{name}: {nb} x {cap} rows, {distinct} distinct, equal to "
           f"numpy, to one another and to the plain path; overflow at cap "
           f"{distinct // 2}")
    if timed:
        top = torch.iinfo(torch.int64).min
        keys = (((kmers[..., 0].long() & 0xFFFFFFFF) << 32)
                | (kmers[..., 1].long() & 0xFFFFFFFF)).reshape(-1) ^ top
        ms = {}
        for label, fn in (
                ("tree", lambda _: T.merge_stacked_tree(kmers, counts)),
                ("capped", lambda _: T.merge_stacked_tree_capped(
                    kmers, counts, cap_ok)),
                ("merge_stacked", lambda _: T.merge_stacked(kmers, counts)),
                ("torch.sort of the int64 keys",
                 lambda q: torch.sort(q).values)):
            ms[label], _ = time_ms(torch, fn, keys, warm=1, reps=5,
                                   fresh=False)
        msg += "; CUDA events: " + ", ".join(
            f"{label} {v:.4f} ms" for label, v in ms.items()) + f" ({card})"
        del keys
    log(msg)
    del kmers, counts, tree, capped, low, flat, p_tree, p_capped, p_low, \
        p_flat
    torch.cuda.empty_cache()
    return got


def phase_linear_counter(tally, S, torch, reads, bench_path: str, tmp: str,
                         card: str):
    """A LinearCounter of 200,000 x 121 bits fed each distinct k-mer of the
    bench bank once (within 1% of the exact count), estimate_distinct_kmers
    of the whole bank on the card (logged), and on the first 20,000 reads
    equal on the card and on the CPU."""
    from gatb_core_tpu_torch import count_kmers
    from gatb_core_tpu_torch.kmer.linear_counter import (
        LinearCounter, estimate_distinct_kmers)

    res, _ = tally.counted(S, "phase 13b count", lambda: count_kmers(
        bench_path, kmer_size=31, abundance_min=1), path=SELECT_COUNT_KERNELS)
    exact = len(res.solid_kmers)
    check(exact == 999_959, "phase 13b: distinct k-mers of the bench bank")
    lc = LinearCounter(200_000 * 121, device="cuda")
    lc.add(torch.from_numpy(res.solid_kmers.view(np.int32)).cuda())
    est = lc.count()
    check(abs(est - exact) <= 0.01 * exact and lc.is_accurate(),
          "phase 13b: the linear count is off by more than 1%")
    t0 = time.time()
    whole = estimate_distinct_kmers(bench_path, 31, device="cuda")
    t_whole = time.time() - t0
    head = os.path.join(tmp, "head.fa")
    with open(head, "wb") as f:
        write_reads(f, reads[:20_000], 0)
    on_card = estimate_distinct_kmers(head, 31, device="cuda")
    on_cpu = estimate_distinct_kmers(head, 31, device="cpu")
    check(isinstance(on_card, int) and on_card == on_cpu,
          "phase 13b: estimate_distinct_kmers differs on card and CPU")
    log(f"phase 13b linear counter: {est} for {exact} distinct "
        f"({(est - exact) / exact:+.4%}); estimate_distinct_kmers of the "
        f"bench bank {whole} ({whole / exact:.4f} of the exact count, the "
        f"file-size scaling counts header bytes) in {t_whole:.3f} s; first "
        f"20,000 reads {on_card} on card and CPU ({card})")
    os.remove(head)


def phase_leon_device(tally, S, torch, bench_path: str, card: str):
    """Leon's device stage at full size: the solid count (k=31,
    abundance-min 2) and the neighbor Bloom of the bench bank through
    leon_ref_bloom on the card; the Bloom's bytes equal _bloom_build on
    the CPU over the same solid table."""
    from gatb_core_tpu_torch import count_kmers
    from gatb_core_tpu_torch.collections.bloom import _bloom_build
    from gatb_core_tpu_torch.compression.leon_ref import leon_ref_bloom

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    (bloom, size_bits, n_hash), _ = tally.counted(
        S, "phase 13c leon device stage",
        lambda: leon_ref_bloom(bench_path, 31, 2, device="cuda"))
    t_stage = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    solid = count_kmers(bench_path, kmer_size=31, abundance_min=2) \
        .solid_kmers
    words = _bloom_build(torch.from_numpy(solid.view(np.int32)), None,
                         size_bits, n_hash, 0, "neighbor", 31)
    check(words.numpy().view(np.uint8).tobytes() == bloom.tobytes(),
          "phase 13c: the neighbor Bloom differs from the CPU build")
    log(f"phase 13c leon device stage: {len(solid)} solid k-mers, Bloom of "
        f"{size_bits} bits and {n_hash} hashes equal to the CPU build; "
        f"stage {t_stage:.3f} s, peak device memory {peak:.1f} MiB "
        f"({card})")


def cut_fastq(path: str, n_reads=2000, read_len=150, genome_len=10_000,
              seed=13) -> None:
    """Leon's cut: reads of a 10 kbp genome at ~30x with 1% substitutions,
    a few N, qualities phred 0-40, headers 'r<i> pos:<p>'."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - read_len, n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)]
    hit = rng.random(reads.shape) < 0.01
    reads = np.where(hit, (reads + rng.integers(1, 4, reads.shape,
                                                dtype=np.uint8)) & 3, reads)
    reads = np.where(rng.random(reads.shape) < 0.001, 4, reads)
    quals = rng.integers(33, 74, reads.shape, dtype=np.uint8)
    nts = np.frombuffer(b"ACTGN", np.uint8)
    with open(path, "w") as f:
        for i in range(n_reads):
            f.write(f"@r{i} pos:{starts[i]}\n{nts[reads[i]].tobytes().decode()}"
                    f"\n+\n{quals[i].tobytes().decode()}\n")


def decode_ref_blocks(c: dict, nb_reads: int):
    """The DNA and header blocks of leon_ref_contents decoded in memory."""
    from gatb_core_tpu_torch.compression import leon_ref as L

    k = c["kmer_size"]
    bloom = L.NeighborBloom(c["bloom_bytes"], c["bloom_size"],
                            c["bloom_nb_hash"], k)
    dec, model = L.RangeDecoder(c["anchors_dict"]), L.Order0Model(5)
    anchors = []
    for _ in range(c["nb_anchors"]):
        v = 0
        for _ in range(k):
            v = (v << 2) | dec.next_byte(model)
        anchors.append(v)
    reads, headers = [], []
    for i, (db, hb) in enumerate(zip(c["dna_blocks"], c["header_blocks"])):
        n = c["dna_sizes"][2 * i + 1]
        reads += L._DnaDecoder(k, bloom, anchors).decode_block(db, n)
        headers += L._HeaderDecoder(c["first_header"]).decode_block(hb, n)
    check(len(reads) == nb_reads, "phase 13d: decoded read count")
    return reads, headers, bloom


def phase_leon_cut(tally, S, tmp: str, card: str):
    """Leon end to end on a cut, both formats: the CLI as a process on the
    card (GTBL1 -c, then -d) against the input and against the compressor
    on the CPU, open_bank of the .leon file, and the reference container's
    contents (lossless and lossy) decoded in memory. The host coder runs
    in this process while the CLI runs in its own. Returns the host
    coder's ms per read by direction and format."""
    src = os.path.join(tmp, "cut.fq")
    cut_fastq(src)
    procs = []

    def cli(*args):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gatb_core_tpu_torch.tools.leon",
             "-file", *args], cwd=tmp, env=dict(os.environ, PYTHONPATH=HERE),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        return procs[-1]

    try:
        return leon_cut_checks(tally, S, src, cli, card)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


def leon_cut_checks(tally, S, src: str, cli, card: str):
    import zlib

    from gatb_core_tpu_torch.bank.fasta import BankLeon, open_bank
    from gatb_core_tpu_torch.compression import leon_ref as L
    from gatb_core_tpu_torch.compression.leon import LeonCompressor

    orig = [(s.comment, s.data, s.quality) for s in open_bank(src)]
    n = len(orig)

    def finish(proc, what):
        out, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0,
              f"phase 13d: leon {what} failed: {out[-2000:]}")

    ms = {}
    proc = cli(src, "-c", "-gtbl")
    t0 = time.time()
    LeonCompressor(kmer_size=31, abundance_min=2, device="cpu").compress(
        src, src + ".cpu.leon")
    ms["GTBL1 compress (count on the CPU)"] = (time.time() - t0) * 1e3 / n
    t0 = time.time()
    full, _ = tally.counted(S, "phase 13d leon_ref_contents", lambda:
                            L.leon_ref_contents(src, 31, 2, lossless=True,
                                                device="cuda"))
    ms["reference compress, lossless"] = (time.time() - t0) * 1e3 / n
    t0 = time.time()
    lossy = L.leon_ref_contents(src, 31, 2, device="cuda")
    ms["reference compress, lossy"] = (time.time() - t0) * 1e3 / n
    finish(proc, "-c -gtbl")
    with open(src + ".leon", "rb") as f, open(src + ".cpu.leon", "rb") as g:
        check(f.read() == g.read(),
              "phase 13d: the card's GTBL1 file differs from the CPU's")
    proc = cli(src + ".leon", "-d")
    t0 = time.time()
    bank = open_bank(src + ".leon")
    got = [(s.comment, s.data, s.quality) for s in bank]
    ms["GTBL1 decompress"] = (time.time() - t0) * 1e3 / n
    check(isinstance(bank, BankLeon) and got == orig,
          "phase 13d: open_bank of the .leon file differs from the input")
    t0 = time.time()
    reads, headers, _ = decode_ref_blocks(full, n)
    ms["reference decompress (DNA, headers)"] = (time.time() - t0) * 1e3 / n
    check(reads == [d for _, d, _ in orig]
          and headers == [c for c, _, _ in orig],
          "phase 13d: the reference blocks decode to other reads")
    quals = "".join(zlib.decompress(b).decode() for b in full["qual_blocks"])
    check(quals.splitlines() == [q for _, _, q in orig],
          "phase 13d: lossless qualities differ from the input")
    cpu_bloom, size_bits, n_hash = L.leon_ref_bloom(src, 31, 2, device="cpu")
    bloom = L.NeighborBloom(cpu_bloom.tobytes(), size_bits, n_hash, 31)
    smooth = [L._smooth_quals(d, q, bloom, 31) for _, d, q in orig]
    lossy_q = "".join(zlib.decompress(b).decode()
                      for b in lossy["qual_blocks"]).splitlines()
    check(lossy["bloom_bytes"] == full["bloom_bytes"] == cpu_bloom.tobytes()
          and lossy["dna_blocks"] == full["dna_blocks"]
          and lossy["header_blocks"] == full["header_blocks"]
          and lossy_q == smooth and lossy_q != [q for _, _, q in orig],
          "phase 13d: lossy qualities differ from the smoothing on the CPU")
    finish(proc, "-d")
    check([(s.comment, s.data, s.quality)
           for s in open_bank(src + ".d")] == orig,
          "phase 13d: leon -d output differs from the input")
    log(f"phase 13d leon on a cut ({n} x 150 bp FASTQ, {full['nb_anchors']} "
        f"anchors): the CLI on the card round trips, its GTBL1 file equals "
        f"the CPU's, open_bank and the reference blocks decode to the input;"
        f" host coder ms per read: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" ({card})")
    return ms


def phase_leon_and_merges(tally, S, torch, reads, bench_path: str, tmp: str,
                          card: str):
    t0 = time.time()
    stacked_case(tally, S, torch, reads, 31, 64, 1 << 18, card, timed=True)
    stacked_case(tally, S, torch, reads, 63, 16, 1 << 16, card, timed=False)
    phase_linear_counter(tally, S, torch, reads, bench_path, tmp, card)
    phase_leon_device(tally, S, torch, bench_path, card)
    phase_leon_cut(tally, S, tmp, card)
    log(f"phase 13: {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: the mesh paths (parallel/*): (a) one rank over NCCL at full
# size, in this process; (b) two ranks on the one card over gloo, spawned
# ---------------------------------------------------------------------------

MESH_RANK_KERNELS = ("tile_sort", "merge_partition", "merge_tiles",
                     "rank_rows", "extract_planes", "run_reduce")


def table_sha(res) -> str:
    """sha256 of a count's solid table, counts and histogram."""
    h = hashlib.sha256(np.ascontiguousarray(res.solid_kmers).tobytes())
    h.update(np.ascontiguousarray(res.solid_counts).tobytes())
    h.update(np.asarray(res.histogram.bins).tobytes())
    return h.hexdigest()


def mesh_world1(tmp: str):
    """A world of one rank over NCCL on the card, in this process."""
    from gatb_core_tpu_torch.parallel.mesh import (init_process_group,
                                                   make_mesh)

    init_process_group(0, 1, os.path.join(tmp, "nccl_rendezvous"), "nccl",
                       300)
    return make_mesh(1, "cuda")


def phase_mesh_count(tally, S, mesh, stress_path: str, stress_fold,
                     card: str):
    """Phase 14a, count: count_kmers_distributed of the stress bank at
    one rank over NCCL; its table equals the fold phase's. At
    ``distinct_ratio_hint=0.05`` the local table and the accumulator
    overflow and grow at full size (replays); the default 0.3 sizes the
    accumulator at 2^29 rows, which does not fit the card's 80 GB beside
    its merge (``--mesh-sizing`` runs both sizings)."""
    import torch

    from gatb_core_tpu_torch.parallel import superbatch
    from gatb_core_tpu_torch.parallel.exchange import \
        count_kmers_distributed

    before = superbatch.retries["superbatch"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res, got = tally.counted(
        S, "phase 14a stress count (mesh, 1 rank, NCCL)",
        lambda: count_kmers_distributed(
            stress_path, mesh, kmer_size=31, abundance_min=3,
            superbatch_rows=1 << 25, distinct_ratio_hint=0.05), path=COUNT_KERNELS)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    replays = superbatch.retries["superbatch"] - before
    check(res.info["kmers_nb_solid"] == 29_999_950
          and res.info["kmers_nb_valid"] == 720_000_000,
          "14a: stress count")
    check(same_table(res, stress_fold),
          "14a: the mesh count's table differs from the fold phase's")
    log(f"phase 14a stress count over a 1-rank NCCL mesh: {wall:.3f} s "
        f"wall (single device, phase 4: {SINGLE_S['phase 4 stress']:.3f} s)"
        f", {replays} superbatch replays, peak device memory {peak:.1f} "
        f"MiB; table equal to phase 4's; {card}")
    return got


def phase_mesh_graph(tally, S, mesh, graph, ug, card: str):
    """Phase 14a, graph: Graph(mesh=) build_postsolid + unitig_graph on
    the stress table at one rank over NCCL, against phases 9c and 11."""
    import torch

    from gatb_core_tpu_torch.debruijn.graph import Graph

    def build():
        g = Graph(31, graph.solid_limbs, graph.solid_counts, mesh=mesh)
        g.build_postsolid(mphf_kind="none")
        torch.cuda.synchronize()
        return g

    t0 = time.time()
    gm, got = tally.counted(S, "phase 14a stress graph (mesh)", build,
                            path=GRAPH_KERNELS)
    wall = time.time() - t0
    check(np.array_equal(gm._adjacency, graph._adjacency)
          and gm.checksum_branching() == graph.checksum_branching()
          and np.array_equal(gm.branching_nodes(), graph.branching_nodes())
          and np.array_equal(gm._debloom.cfp, graph._debloom.cfp),
          "14a: mesh adjacency, branching or cFP differ from phase 9c")
    t1 = time.time()
    ugm, got_u = tally.counted(S, "phase 14a stress unitigs (mesh)",
                               gm.unitig_graph, path=("rank_rows",))
    u_s = time.time() - t1
    check(same_unitig_graph(ugm, ug),
          "14a: mesh unitig graph differs from phase 11's")
    mesh_t = stage_times(gm.info)
    one_t = SINGLE_S["stress postsolid stages"]
    log(f"phase 14a stress graph over a 1-rank NCCL mesh: postsolid "
        f"{wall:.3f} s wall, stages {mesh_t} (single device, phase 9c: "
        f"{one_t}); unitig_graph {u_s:.3f} s (phase 11: "
        f"{graph.info['postsolid_time.unitigs']:.3f} s); adjacency, "
        f"branching, cFP and unitigs equal to phases 9c and 11; {card}")
    return {"graph": got, "unitigs": got_u}


def _rank_counts(mesh, fn):
    """Run fn with this rank's launch counters at 0; (result, seconds,
    launch counts, launch shapes)."""
    import torch

    from gatb_core_tpu_torch.ops import limb_sort as S

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    reset_counts(S)
    sync()
    t0 = time.time()
    out = fn()
    sync()
    secs = time.time() - t0
    got, shapes = launch_counts(S)
    return out, secs, {k: v for k, v in got.items()
                       if k in MESH_RANK_KERNELS}, \
        {k: v for k, v in shapes.items() if k in MESH_RANK_KERNELS}


def mesh_rank_count(mesh, path: str, k: int, kw: dict) -> dict:
    """A rank of phase 14b: count_kmers_distributed of a bank."""
    from gatb_core_tpu_torch.parallel import superbatch
    from gatb_core_tpu_torch.parallel.exchange import \
        count_kmers_distributed

    before = superbatch.retries["superbatch"]
    res, secs, launches, shapes = _rank_counts(
        mesh, lambda: count_kmers_distributed(path, mesh, kmer_size=k, **kw))
    return {"sha": table_sha(res), "info": res.info, "seconds": secs,
            "replays": superbatch.retries["superbatch"] - before,
            "launches": {"count": launches}, "shapes": shapes}


def mesh_rank_graph(mesh, path: str) -> dict:
    """A rank of phase 14b: Graph.create(mesh=) on error bank a, each
    sharded stage apart (create: count, MPHF and the sharded debloom;
    branching: the sharded adjacency; unitig_graph; simplify), then
    Monument; each stage also on one device of this rank's card, timed
    beside it, the unitig graph and the simplify record compared."""
    from gatb_core_tpu_torch.debruijn.graph import Graph
    from gatb_core_tpu_torch.parallel import postsolid

    stages, launches, one_s = {}, {}, {}
    shapes = {name: set() for name in MESH_RANK_KERNELS}

    def stage(name, fn, one_fn):
        out, stages[name], launches[name], got = _rank_counts(mesh, fn)
        for key in shapes:
            shapes[key] |= got[key]
        one, one_s[name], _, _ = _rank_counts(mesh, one_fn)
        return out, one

    before = postsolid.retries["postsolid"]
    kw = dict(bank=path, kmer_size=31, abundance_min=2,
              build_branching=False)
    g, one = stage("create", lambda: Graph.create(mesh=mesh, **kw),
                   lambda: Graph.create(device=mesh.device, **kw))
    stage("branching", g.branching_nodes, one.branching_nodes)
    ug, one_ug = stage("unitig_graph", g.unitig_graph, one.unitig_graph)
    stats, one_stats = stage("simplify", g.simplify, one.simplify)
    # Monument reuses simplify's sweep and compaction: no rank_rows
    contigs = g.contigs(traversal="monument")[0]
    record = simplify_record(g, g._simplifications, stats, contigs)
    return {"nodes": g.nb_nodes,
            "equal_one_device": same_unitig_graph(ug, one_ug) and record
            == simplify_record(one, one._simplifications, one_stats,
                               one.contigs(traversal="monument")[0]),
            "record": record, "seconds": (stages, one_s),
            "launches": launches, "shapes": shapes,
            "replays": postsolid.retries["postsolid"] - before}


def mesh_rank_dryrun(mesh) -> dict:
    """A rank of phase 14b: the port's dry run body on this mesh."""
    from gatb_core_tpu_torch.parallel.dryrun import dryrun_rank

    (line, replays), secs, launches, shapes = _rank_counts(
        mesh, lambda: dryrun_rank(mesh))
    return {"line": line, "replays": replays, "seconds": secs,
            "launches": {"dryrun": launches}, "shapes": shapes}


def phase_mesh_ranks(tally, tmp: str, bench_path: str, bench_fold,
                     k63_path: str, k63_res, card: str):
    """Phase 14b: two ranks on the one card over gloo (staged through the
    host), spawned after the kernels were built: the bench bank in 2
    passes with send windows that overflow, the k=63 bank, error bank a
    through Graph(mesh=), and the dry run. Every rank's result must be
    the same and equal to the single-device phases; every rank must
    launch rank_rows in each sharded stage; the counts must replay
    superbatches. Returns the launch counts summed over the ranks and the
    union of their launch shapes."""
    from gatb_core_tpu_torch.parallel.mesh import RankPool

    path_a = os.path.join(tmp, "errors_a_mesh.fa")
    with open(path_a, "wb") as f:
        write_reads(f, error_reads(**ERROR_BANKS["a"]["reads"]), 0)
    total = {name: 0 for name in MESH_RANK_KERNELS}
    shapes = {name: set() for name in MESH_RANK_KERNELS}
    t0 = time.time()
    with RankPool(2, device="cuda", backend="gloo", timeout=300) as pool:
        spawn_s = time.time() - t0

        def run(name, fn, *args, need=("tile_sort",)):
            """Run fn on both ranks; each rank must have launched the
            kernels ``need`` names in each of its stages."""
            outs = pool.run(fn, *args)
            for rank, out in enumerate(outs):
                for key in shapes:
                    shapes[key] |= out["shapes"][key]
                for stage, got in out["launches"].items():
                    log(f"phase 14b {name}, {stage}: rank {rank} launches "
                        f"{got}")
                    check(all(got[key] > 0 for key in need),
                          f"14b {name}, {stage}: rank {rank} launched no "
                          f"{'/'.join(need)}")
                    for key in total:
                        total[key] += got[key]
            plain = [{k: v for k, v in o.items()
                      if k not in ("seconds", "launches", "shapes")}
                     for o in outs]
            check(all(p == plain[0] for p in plain),
                  f"14b {name}: the ranks' results differ")
            return outs[0], [o["seconds"] for o in outs]

        bench, bench_s = run("bench count", mesh_rank_count, bench_path, 31,
                             dict(abundance_min=3, nb_passes=2,
                                  capacity_factor=0.1),
                             need=("tile_sort", "extract_planes",
                                   "run_reduce"))
        check(bench["sha"] == table_sha(bench_fold)
              and bench["info"]["kmers_nb_distinct"] == 999_959,
              "14b: the bench count differs from phase 2's")
        check(bench["replays"] > 0, "14b: no superbatch was replayed")
        k63, k63_s = run("k=63 count", mesh_rank_count, k63_path, 63,
                         dict(abundance_min=1))
        check(k63["sha"] == table_sha(k63_res),
              "14b: the k=63 count differs from phase 3's")
        # every stage of the graph is sharded: each sweeps with rank_rows
        ga, ga_s = run("error bank a", mesh_rank_graph, path_a,
                       need=("rank_rows",))
        check(ga["record"] == JAX_BANK_A and ga["equal_one_device"],
              f"14b: error bank a differs from phase 12a: {ga['record']}")
        dry, dry_s = run("dryrun", mesh_rank_dryrun,
                         need=("tile_sort", "rank_rows"))
        check(dry["replays"] > 0, "14b: the dry run replayed nothing")
    os.remove(path_a)
    log(f"phase 14b: 2 ranks on one card over gloo (staged through the "
        f"host; not a multi-card figure): spawn {spawn_s:.1f} s; bench "
        f"count, 2 passes, {bench['replays']} superbatch replays: "
        f"{max(bench_s):.3f} s (single device, 1 pass, phase 2: "
        f"{SINGLE_S['bench count']:.3f} s); k=63 count {max(k63_s):.3f} s "
        f"(phase 3: {SINGLE_S['k=63 count']:.3f} s); error bank a "
        f"({ga['nodes']} nodes), each stage's s on rank 0 / rank 1 "
        f"(beside it on one device of the same card): "
        + ", ".join(f"{key} " + "/".join(f"{m[key]:.3f}" for m, _ in ga_s)
                    + " (" + "/".join(f"{o[key]:.3f}" for _, o in ga_s)
                    + ")" for key in ga_s[0][0])
        + f"; unitigs and simplify record equal to one device and to "
        f"JAX_BANK_A; dry run {max(dry_s):.3f} s: "
        f"{dry['line']}; {card}")
    return total, shapes


# ---------------------------------------------------------------------------
# phase 16: the examples_torch/ mirrors of examples/ on the card
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(HERE, "examples_torch")
# mirrors that write or read an HDF5 file, which needs h5py (not installed
# beside the card); they run here too wherever ``import h5py`` works
NEEDS_H5PY = {
    "storage1_hdf5.py": "Graph.create(output=...h5) and Graph.load",
    "storage3_streams.py": "byte streams in an HDF5 Storage",
    "leon1_interop.py": "the reference .leon container is an HDF5 file",
    "tools1_cli_tour.py": "dbgh5 writes a .h5 that the other tools load",
}
# the kernels each in-process mirror must launch: the sort kernels in
# every count, rank_rows too in every graph build; the rest are host code
# or torch ops alone (k-mer extraction, the minimizer census, the linear
# counter)
EXAMPLE_PATHS = {
    **{name: SORT_KERNELS for name in (
        "kmer2_count.py", "kmer3_count_processor.py", "kmer5_histogram.py",
        "kmer9_multibank.py", "proto2_histo2d.py", "storage4_kff.py",
        "leon1_interop.py", "leon2_roundtrip.py")},
    **{name: GRAPH_KERNELS for name in (
        "debruijn1_graph.py", "debruijn2_unitigs.py", "debruijn3_queries.py",
        "debruijn4_simplify.py", "debruijn5_gfa.py", "debruijn6_monument.py",
        "debruijn7_membership.py", "debruijn8_branching.py",
        "debruijn9_iterative_extensions.py", "debruijn10_node_state.py",
        "debruijn11_frontline.py", "traversal1_contigs.py",
        "proto1_microsnp.py", "storage1_hdf5.py", "tools1_cli_tour.py")},
}


# the mesh mirrors: the function each of their ranks runs, the kernels
# each rank must launch in it, and those their ranks together must launch
# (multichip1's exchange sorts fewer rows a rank than one tile holds: no
# merge level)
MESH_EXAMPLES = {
    "multichip1_exchange.py": ("count", ("tile_sort",), ("tile_sort",)),
    "multichip2_distributed_count.py": ("count", ("tile_sort",),
                                        SORT_KERNELS),
    "multichip3_postsolid.py": ("compare", ("tile_sort", "rank_rows"),
                                GRAPH_KERNELS),
}


def mesh_example_rank(mesh, fn, *args) -> dict:
    """A rank of a phase 16 mesh mirror: the mirror's own rank function
    with this rank's launch counters at 0."""
    line, secs, launches, shapes = _rank_counts(mesh,
                                                lambda: fn(mesh, *args))
    return {"line": line, "seconds": secs, "launches": launches,
            "shapes": shapes}


def mesh_example(tally, ranks, name: str):
    """Run the mesh mirror ``name`` (imported: its rank function on its
    own inputs) on the 8 ranks of ``ranks``, as its ``main`` does; every
    rank must return the same line and launch the kernels its entry of
    ``MESH_EXAMPLES`` names. Adds the ranks' launches and shapes to the
    tally; returns what ``main`` prints and the launches summed over the
    ranks."""
    import importlib

    fn_name, need, path = MESH_EXAMPLES[name]
    mod = importlib.import_module(name[:-3])
    outs = ranks.run(mesh_example_rank, getattr(mod, fn_name),
                     *mod.inputs())
    got = {key: 0 for key in MESH_RANK_KERNELS}
    for rank, out in enumerate(outs):
        check(all(out["launches"][key] > 0 for key in need),
              f"16 {name}: rank {rank} launched no {'/'.join(need)}: "
              f"{out['launches']}")
        for key in got:
            got[key] += out["launches"][key]
            tally.shapes[key] |= out["shapes"][key]
    check(all(out["line"] == outs[0]["line"] for out in outs),
          f"16 {name}: the ranks' lines differ")
    check(all(got[key] > 0 for key in path),
          f"16 {name}: a kernel of the path was not launched: {got}")
    for key in got:
        tally.launches[key] += got[key]
    return outs[0]["line"] + "\n", got


def example_on_cpu(path: str, db: str):
    """One mirror with ``--device cpu`` (a worker of phase 16's process
    pool, on 2 torch threads beside the card's runs): its output and wall
    seconds."""
    import torch

    torch.set_num_threads(2)
    sys.path.insert(0, EXAMPLES)
    from _runner import run_example

    t0 = time.time()
    out = run_example(path, db, argv=["--device", "cpu"])
    return out, time.time() - t0


def phase_examples(tally, S, torch, tmp: str, card: str) -> dict:
    """Phase 16: every mirror of examples_torch/ on the card (--device
    cuda) on a seeded stand-in for the reference's test/db, its printed
    lines (normalised) equal to the same mirror's run on the CPU; the CPU
    runs go in process pools beside the card's. In-process mirrors are
    counted one by one (their launches of the sort kernels and rank_rows;
    ``EXAMPLE_PATHS``); the mesh mirrors' rank functions run on one pool
    of 8 gloo ranks on the one card (collectives staged through the host;
    not a multi-card figure), each rank counted (``MESH_EXAMPLES``). Every
    kernel of the list must launch in the phase. Returns the phase's
    launches."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from gatb_core_tpu_torch.parallel.mesh import RankPool

    sys.path.insert(0, EXAMPLES)
    from _runner import fixture_db, normalise, run_example

    t_phase = time.time()
    try:
        import h5py  # noqa: F401
        skip = {}
    except ImportError:
        skip = NEEDS_H5PY
    for name, why in skip.items():
        log(f"phase 16 {name}: not run on the card: needs h5py ({why})")
    db = fixture_db(os.path.join(tmp, "examples_db"), seed=1)
    names = sorted(f for f in os.listdir(EXAMPLES)
                   if f.endswith(".py") and not f.startswith("_")
                   and f not in skip)
    check(len(names) + len(skip) == 44, "16: the mirror list is not 44")
    # on the card the mesh mirrors share one pool of 8 ranks; on the CPU
    # they run one at a time (each spawns 8 ranks, which the host's cores
    # start and stage), the other CPU runs in a pool of 2 beside them; the
    # card does not wait for the CPU runs
    inproc = [n for n in names if n not in MESH_EXAMPLES]
    mesh = [n for n in names if n in MESH_EXAMPLES]
    pool = ProcessPoolExecutor(2, mp_context=mp.get_context("spawn"))
    mesh_pool = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    total = {k: 0 for k in GRAPH_KERNELS}
    walls, outs = {}, {}

    def on_card(name):
        t0 = time.time()
        out = run_example(os.path.join(EXAMPLES, name), db,
                          argv=["--device", "cuda"])
        torch.cuda.synchronize()
        return out, time.time() - t0

    try:
        cpu = {n: (mesh_pool if n in mesh else pool).submit(
            example_on_cpu, os.path.join(EXAMPLES, n), db) for n in names}
        for name in inproc:
            (outs[name], walls[name]), got = tally.counted(
                S, f"phase 16 {name}", lambda: on_card(name),
                path=EXAMPLE_PATHS.get(name, ()))
            for k in total:
                total[k] += got[k]
            log(f"phase 16 {name}: card {walls[name]:.3f} s; launches "
                f"{ {k: got[k] for k in GRAPH_KERNELS} }; "
                f"{outs[name].strip().splitlines()[-1][:100]}")
        t0 = time.time()
        with RankPool(8, device="cuda", backend="gloo", timeout=300) as ranks:
            spawn_s = time.time() - t0
            for name in mesh:
                t0 = time.time()
                outs[name], got = mesh_example(tally, ranks, name)
                walls[name] = time.time() - t0
                for k in total:
                    total[k] += got[k]
                log(f"phase 16 {name}: card {walls[name]:.3f} s (8 gloo "
                    f"ranks on one card, staged through the host; not a "
                    f"multi-card figure); launches summed over the ranks "
                    f"{got}; {outs[name].strip()[:100]}")
        t_card = time.time() - t_phase
        for name in names:
            out_cpu, cpu_s = cpu[name].result(timeout=900)
            check(outs[name].strip()
                  and normalise(outs[name]) == normalise(out_cpu),
                  f"16 {name}: the card printed {outs[name]!r}, the CPU "
                  f"{out_cpu!r}")
            log(f"phase 16 {name}: CPU {cpu_s:.3f} s, equal to the card's")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        mesh_pool.shutdown(wait=True, cancel_futures=True)
    slowest = sorted(inproc, key=walls.get, reverse=True)[:5]
    log(f"phase 16 examples: {len(names)} mirrors on the card equal to "
        f"their CPU runs, {len(skip)} not run (h5py); card walls: the "
        f"in-process mirrors {sum(walls[n] for n in inproc):.1f} s in all "
        f"(slowest " + ", ".join(f"{n} {walls[n]:.3f} s" for n in slowest)
        + f"), the mesh mirrors (one pool of 8 gloo ranks on one card, "
        f"staged through the host; not a multi-card figure) spawn "
        f"{spawn_s:.1f} s, then "
        + ", ".join(f"{walls[n]:.1f}" for n in mesh) + f" s; launches "
        f"{total}; the "
        f"card's runs done at {t_card:.1f} s, phase "
        f"{time.time() - t_phase:.1f} s; {card}")
    check(all(total[k] > 0 for k in GRAPH_KERNELS),
          f"16: a kernel was launched by no mirror: {total}")
    return total


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


# device kernels of the extraction and of the distinct reduce, by name:
# the hand kernels, and the torch ops that did the same work before them
# (the funnel shifts, revcomp, compare and where of the extraction; the
# reduce's cumsums and index_copy_) cannot be told apart from other torch
# ops, so a tree without the kernels reads "not measured"
COUNT_KERNEL_NAMES = {"extract_planes": ("extract_planes_kernel",),
                      "run_reduce": ("run_partials_kernel", "run_scan_kernel",
                                     "run_scatter_kernel")}


def enqueued(torch, prof):
    """(top-level torch ops, device kernels, device copies and fills) of a
    profile: aten ops called from outside any other aten op (what a
    dispatch mode sees), and the device events by kind."""
    ops = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU \
                or not e.name.startswith("aten::"):
            continue
        parent = e.cpu_parent
        if parent is None or not parent.name.startswith("aten::"):
            ops += 1
    kernels = copies = 0
    for key, _, calls in device_events(torch, prof):
        if key.startswith(("Memcpy", "Memset")):
            copies += calls
        else:
            kernels += calls
    return ops, kernels, copies


def profile_main(torch, count_kmers, n_reads: int, out_dir: str) -> int:
    """The ``--profile`` mode: where the stress count's time goes, fold
    path and LSM merge chain side by side. It needs only the package's
    ``count_kmers`` and its CUDA sources, so it also profiles a checkout
    that predates the extraction and reduce kernels."""
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
            ops, kernels, copies = enqueued(torch, prof)
            stages = {}
            for stage, names in COUNT_KERNEL_NAMES.items():
                hit = [r for r in rows if any(x in r[0] for x in names)]
                stages[stage] = "not measured" if not hit else (
                    f"{sum(r[1] for r in hit) / 1e3:.3f} ms in "
                    f"{sum(r[2] for r in hit)} launches")
            log(f"{name} under the profiler: count {wall:.3f} s wall, "
                f"device {dev_s:.3f} s, busy share {dev_s / wall:.3f}; "
                f"enqueued {ops} torch ops, {kernels} kernel launches, "
                f"{copies} copies and fills; extraction {stages['extract_planes']}"
                f", reduce {stages['run_reduce']}; {card}")
            for key, us, calls in rows[:14]:
                log(f"  {us / 1e3:10.1f} ms  {calls:7d} x  {key[:90]}")
            with open(os.path.join(out_dir, f"profile_{name}.txt"),
                      "w") as f:
                for key, us, calls in rows:
                    f.write(f"{us / 1e3:.3f}\t{calls}\t{key}\n")
            del prof
    return 0


def mesh_sizing_main(torch, n_reads: int) -> int:
    """The ``--mesh-sizing`` mode: count_kmers_distributed of the stress
    bank at one rank over NCCL with phase 14a's ``distinct_ratio_hint``
    (0.05) and with the default (0.3): wall time, peak device memory, the
    final capacities and the replays of each; the tables must agree."""
    from gatb_core_tpu_torch.parallel import superbatch
    from gatb_core_tpu_torch.parallel.exchange import \
        count_kmers_distributed

    card = card_line()
    log(f"torch {torch.__version__}; {card}")
    build_all()
    with tempfile.TemporaryDirectory(prefix="gatb_sizing_") as tmp:
        mesh = mesh_world1(tmp)
        try:
            bank = os.path.join(tmp, "stress.fa")
            write_stress_bank(bank, n_reads=n_reads)
            shas = set()
            for hint in (0.05, 0.3):
                before = superbatch.retries["superbatch"]
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                try:
                    res = count_kmers_distributed(
                        bank, mesh, kmer_size=31, abundance_min=3,
                        superbatch_rows=1 << 25, distinct_ratio_hint=hint)
                except torch.cuda.OutOfMemoryError as e:
                    log(f"distinct_ratio_hint={hint}: out of device memory "
                        f"after {time.time() - t0:.3f} s, capacities "
                        f"{superbatch.capacities}, peak "
                        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} "
                        f"MiB ({str(e).splitlines()[0]}); {card}")
                    continue
                wall = time.time() - t0
                shas.add(table_sha(res))
                log(f"distinct_ratio_hint={hint}: count {wall:.3f} s wall, "
                    f"solid {res.info['kmers_nb_solid']}, distinct "
                    f"{res.info['kmers_nb_distinct']}, replays "
                    f"{superbatch.retries['superbatch'] - before}, final "
                    f"capacities {superbatch.capacities}, peak device "
                    f"memory allocated "
                    f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
                    f"{card}")
                del res
            check(len(shas) == 1, "mesh sizing: the tables differ")
        finally:
            torch.distributed.destroy_process_group()
    return 0


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile the stress count instead of the phases")
    ap.add_argument("--mesh-sizing", action="store_true",
                    help="count the stress bank over a 1-rank mesh at two "
                    "accumulator sizings instead of the phases")
    ap.add_argument("--reads", type=int, default=6_000_000,
                    help="reads of the stress bank under --profile and "
                    "--mesh-sizing")
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
    if args.mesh_sizing:
        return mesh_sizing_main(torch, args.reads)

    smi = card_line()
    card = f"{torch.cuda.get_device_name(0)}, power limit " \
        f"{smi.split(',')[-1].strip()}"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    t_all = time.time()
    build_all()
    err = phase_kernels(torch, S)
    err["rank_rows"] = phase_rank_kernel(torch, S, R)
    err["neighbor_masks"] = phase_masks_kernel(torch)
    err.update(phase_count_kernels(torch))
    times, err_t = phase_timing(torch, S, card)
    times["rank_rows"], err_t["rank_rows"] = phase_rank_timing(torch, S, R,
                                                               card)
    times["neighbor_masks"], err_t["neighbor_masks"] = phase_masks_timing(
        torch, card)
    count_times, count_errs = phase_count_timing(torch, card)
    times.update(count_times)
    err_t.update(count_errs)
    count_times, count_errs = phase_select_timing(torch, card)
    times.update(count_times)
    err_t.update(count_errs)
    tally = Tally()
    with tempfile.TemporaryDirectory(prefix="gatb_smoke_") as tmp, \
            contextlib.ExitStack() as stack:
        reads, bench_path, truth, bench_fold = phase_bench(
            tally, tmp, S, count_kmers)
        k63_path, k63_res = phase_k63(tally, tmp, S, count_kmers)
        stress_path, stress_fold, fold_got = phase_stress(
            tally, tmp, S, count_kmers, card)
        lsm_got = phase_lsm(tally, S, count_kmers, bench_path, bench_fold,
                            stress_path, stress_fold, card)
        t0 = time.time()
        mesh = mesh_world1(tmp)
        stack.callback(torch.distributed.destroy_process_group)
        mesh_got = {"count": phase_mesh_count(tally, S, mesh, stress_path,
                                              stress_fold, card)}
        mesh_s = time.time() - t0
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
        tools_got = phase_tools(tally, S, torch, bench_path, truth,
                                graphs["stress"], tmp, card)
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
        t0 = time.time()
        mesh_got.update(phase_mesh_graph(tally, S, mesh, graphs["stress"],
                                         ugs["stress"], card))
        mesh_s += time.time() - t0
        del graphs, ugs
        for name in ERROR_BANKS:
            simplify_got[name] = phase_simplify(tally, S, name, tmp, card)
        phase_leon_and_merges(tally, S, torch, reads, bench_path, tmp, card)
        torch.cuda.empty_cache()      # room for the ranks' own caches
        t0 = time.time()
        mesh_got["ranks"], rank_shapes = phase_mesh_ranks(
            tally, tmp, bench_path, bench_fold, k63_path, k63_res, card)
        for key, n in mesh_got["ranks"].items():
            tally.launches[key] += n
            tally.shapes[key] |= rank_shapes[key]
        log(f"phase 14: {mesh_s + time.time() - t0:.1f} s")
        examples_got = phase_examples(tally, S, torch, tmp, card)
    log(f"launches in the stress count: fold {fold_got}, LSM {lsm_got}")
    log(f"launches in the postsolid builds: {graph_got}")
    log(f"launches in the MPHF builds and queries: {mphf_got}")
    log(f"launches in the unitig builds: {unitig_got}")
    log(f"launches in phase 12: {simplify_got}")
    log(f"launches in phase 14: {mesh_got}")
    log(f"launches in phase 15: {tools_got}")
    log(f"launches in phase 16: {examples_got}")
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

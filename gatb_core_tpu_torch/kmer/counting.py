"""SortingCount: the DSK-equivalent k-mer counting pipeline on one CUDA device.

Port of gatb_core_tpu/kmer/counting.py: the fold path (the default,
``CountConfig.carry_accumulator=True``), the LSM merge chain
(``carry_accumulator=False``, or a table budget below one read batch), the
packed and streamed table fetch, the multi-pass device bank cache and
multibank counting. Reference: gatb-core
SortingCountAlgorithm (kmer/impl/SortingCountAlgorithm.cpp), where reads
are split into superkmers spilled to per-partition files, then each
partition is radix-binned, sorted and 453-way-merged
(PartitionsCommand.cpp). Here:

  host input pipeline:  bank -> packed (B, L) read batches (native C++
                        batcher, or the Python builder)
  device, per superbatch (_superbatch_count_fold): canonical multi-limb
                        k-mer extraction (ops/kmer_ops.py), one sort of the
                        raw rows and one merge level against the
                        device-resident accumulator (the CUDA kernels of
                        ops/limb_sort.py), then the distinct reduce
                        (ops/sortops.py)
  device, LSM chain (_superbatch_count): extraction, one sort and a
                        distinct reduce per superbatch into its own table;
                        the per-pass tables merge by size class
                        (_merge_smallest_pair), at most _MAX_LIVE_LSM live
  device, pass end:     the default CountProcessor chain (histogram ->
                        solidity -> collect) as one kernel
                        (ops/solid_select.py): the histogram's bins and
                        the solid rows, which alone are copied to the host
  host end of run:      with a caller's processor, custom solidity or an
                        auto cutoff over several passes, the whole table
                        is fetched (streamed in chunks on the fold path)
                        and the numpy chain runs over it

Every tensor lives on ``CountConfig.device`` (default ``"cuda"``). A CPU
device runs the kernels' plain PyTorch twins; that is for tests, and
nothing moves to the CPU when a CUDA device is missing.

Every sort pads its rows to a power of two with all-ones sentinels (the
sort kernels need one), where the JAX package's default path sorts the
exact row count: table capacities and the ``ub`` bounds of the LSM chain
can differ from the JAX package's along the way; live rows, counts, ``n``,
the final tables and ``info`` are equal.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..bank.fasta import open_bank
from ..convert import kmers_to_numpy
from ..misc import time_info
from ..misc.algorithm import Algorithm
from ..ops.bitpack import ascii_to_codes_np
from ..ops.kmer_ops import (extract_kmers, extract_planes, kmers_to_py,
                            nb_limbs, pack_valid, pack_words)
from ..ops.limb_sort import merge_sorted_runs, sort_u32_limbs
from ..ops.solid_select import solid_histogram, solid_select
from ..ops.sortops import (SENTINEL, CountTable, _next_pow2, count_batch,
                           count_planes,
                           count_planes_multibank, count_sorted,
                           count_sorted_planes, merge_tables_planes,
                           merge_tables_planes_multi, pallas_sort_rows)
from .histogram import Histogram

MAX_INT32 = 2**31 - 1
I32 = torch.int32
I64 = torch.int64


class _RePlan(Exception):
    """Raised mid-count when the live distinct tables exceed the soft
    device-memory budget; execute() restarts with doubled passes."""


@dataclass
class CountConfig:
    """Counting parameters (defaults match gatb-core CLI defaults,
    SortingCountAlgorithm.cpp:202-235)."""

    kmer_size: int = 31
    minimizer_size: int = 10
    abundance_min: int | str = 2        # int or "auto"
    abundance_max: int = MAX_INT32
    abundance_min_threshold: int = 2    # floor used when abundance_min="auto"
    histo_max: int = 10000
    solidity_kind: str = "sum"
    # device batching
    batch_reads: int = 1024
    batch_len: int = 256
    # superbatch sizing: G read batches are stacked into one device step
    # (one big sort)
    superbatch_rows: int = 1 << 22
    # DSK pass loop (SortingCountAlgorithm.cpp:678, pass filter :806):
    # pass p keeps kmers with minimizer % nb_passes == p; results are
    # pass-invariant
    nb_passes: int = 1
    # progress bar (ProgressTimerAndSystem equivalent) when > 0
    verbose: int = 0
    # ship 2-bit packed words + validity bitmasks to the device, packed by
    # the native batcher in C++ or pack_batch_np on the Python parser
    packed_transfer: bool = True
    # fused count+fold accumulator (DEFAULT): every superbatch extracts
    # and sorts its raw rows and folds them into the device-resident
    # accumulated table with ONE merge level
    # (_superbatch_count_fold). False selects the LSM chain: one distinct
    # table per superbatch, merged by size class (kept for A/B and for
    # shapes the fold cannot take)
    carry_accumulator: bool = True
    # streamed final fetch (fold path): the per-pass table is packed and
    # fetched in chunks of this many rows on a background thread, so the
    # device-to-host copies overlap the CountProcessor sweep
    fetch_chunk_rows: int = 1 << 23
    # soft device-memory budget for the accumulated per-pass distinct
    # tables; past it execute() re-plans with twice the passes
    table_budget_bytes: int = 6 << 30
    # multi-pass device-resident bank cache budget (bytes): pass 0's
    # staged packed read tensors are kept on the device and re-dispatched
    # by later passes (every pass streams the same reads; the filter is
    # on the device), saving a re-parse and re-upload per extra pass.
    # 0 disables; the cache is dropped whole beyond the budget.
    bank_cache_bytes: int = 2 << 30
    # initial distinct/total ratio guess sizing the first superbatch's
    # table capacity; later superbatches learn the measured ratio and the
    # overflow flags guard exactness
    distinct_ratio_hint: float = 0.25
    # device every tensor of the count lives on
    device: str = "cuda"

    @property
    def auto_cutoff(self) -> bool:
        return self.abundance_min == "auto"


@dataclass
class CountResult:
    """Output of SortingCount: the solid count table + stats.

    solid_kmers: (N, W) uint32 limb array, ascending integer order
    solid_counts: (N,) int32 abundances
    histogram: full abundance histogram over *distinct* kmers
    info: reference-style properties (kmers_nb_valid, kmers_nb_solid, ...)
    """

    solid_kmers: np.ndarray
    solid_counts: np.ndarray
    histogram: Histogram
    info: dict
    config: CountConfig

    @property
    def nb_solid(self) -> int:
        return len(self.solid_counts)

    def as_dict(self) -> dict[int, int]:
        """Python-int view {kmer_value: count} (small tables / tests only)."""
        return dict(zip(kmers_to_py(self.solid_kmers),
                        self.solid_counts.tolist()))


def _vmask_dense(vmask: np.ndarray, lengths: np.ndarray) -> bool:
    """True iff a packed validity bitmask is exactly the all-in-length
    pattern (no N bases): MSB-first words, expected word j of a read of
    length len = 0xFFFFFFFF << (32 - clip(len - 32j, 0, 32)). Dense
    batches upload None instead of the masks."""
    nv = vmask.shape[1]
    j32 = (np.arange(nv, dtype=np.int64) * 32)[None, :]
    rem = np.clip(lengths[:, None].astype(np.int64) - j32, 0, 32)
    exp = ((np.uint64(0xFFFFFFFF) << (32 - rem).astype(np.uint64))
           & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.array_equal(vmask, exp)


def _prefetch(gen, depth: int = 4):
    """Run a generator on a background thread with a bounded queue.

    Overlaps host-side batch production (FASTA parse + encode) with device
    work; exceptions propagate to the consumer. If the consumer stops
    early, the producer is signalled via a cancellation event and joined,
    so open banks/parsers are released promptly. Each of the producer's
    ``next()`` is a ``count.parse`` span under the consumer's open span,
    each wait of the consumer a ``count.parse_wait`` span."""
    import queue as queue_mod

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    cancel = threading.Event()
    DONE = object()
    parent = time_info.current()

    def run():
        try:
            it = iter(gen)
            while True:
                with time_info.span("count.parse", parent=parent):
                    item = next(it, DONE)
                if item is DONE:
                    break
                while not cancel.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue_mod.Full:
                        continue
                if cancel.is_set():
                    return
            q.put(DONE)
        except BaseException as e:  # propagate into the consuming thread
            if not cancel.is_set():
                q.put(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            with time_info.span("count.parse_wait"):
                item = q.get()
            if item is DONE:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancel.set()
        while True:  # drain so a blocked producer can observe the cancel
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break
        t.join(timeout=5.0)


class _BatchBuilder:
    """Packs variable-length reads into fixed-shape (B, L) batches.

    Reads longer than the length budget are split into overlapping pieces
    with k-1 overlap (window-exact: the set of kmer windows is preserved,
    like the reference's streaming superkmer split over arbitrary-length
    sequences, Sequence2SuperKmer.hpp:139-155).
    """

    def __init__(self, k: int, batch_reads: int, batch_len: int):
        self.k = k
        self.B = batch_reads
        self.L = max(batch_len, 2 * k)
        self.reset()

    def reset(self):
        self.codes = np.zeros((self.B, self.L), np.uint8)
        self.valid = np.zeros((self.B, self.L), bool)
        self.lengths = np.zeros(self.B, np.int32)
        self.row = 0

    def add(self, data: str):
        buf = np.frombuffer(data.encode("ascii"), dtype=np.uint8)
        k, L = self.k, self.L
        pos = 0
        n = len(buf)
        while pos == 0 or pos + k - 1 < n:
            piece = buf[pos:pos + L]
            codes, valid = ascii_to_codes_np(piece)
            m = len(piece)
            self.codes[self.row, :m] = codes
            self.valid[self.row, :m] = valid
            self.lengths[self.row] = m
            self.row += 1
            if self.row == self.B:
                yield self.flush()
            if pos + L >= n:
                break
            pos += L - (k - 1)

    def flush(self):
        out = (self.codes, self.valid, self.lengths, self.row)
        self.reset()
        return out


def _native_fastx_paths(bank) -> list[str] | None:
    """Plain FASTA/FASTQ(.gz) file list of a bank if the native C++ parser
    can serve it (and is buildable), else None."""
    from ..bank.fasta import BankFasta

    if os.environ.get("GATB_TORCH_NO_NATIVE"):
        return None
    if not isinstance(bank, BankFasta):
        return None
    from ..native import available

    return list(bank.paths) if available() else None


def _extract_superbatch(codes, valid, lengths, pass_i, *, k: int, m: int,
                        nb_passes: int, packed: bool, L: int | None,
                        bank_ids=None):
    """Extraction of one superbatch straight into the planes of the sort:
    (w, next_pow2(rows)) int32, all-ones sentinels on invalid windows, on
    windows the pass filter drops and on the padding (a canonical k-mer is
    never all-ones, ops/sortops._encode_invalid). One ``extract_planes``
    over all the superbatch's reads: a single kernel launch on the card,
    its plain version in steps on the CPU.

    codes/valid: (G, B, L) bytes/bools (packed here with pack_words /
    pack_valid), or with packed=True the packed words / validity bitmasks
    with L the unpacked length (valid may then be None: dense mode);
    lengths: (G, B); bank_ids: optional (G, B) bank of each read. Returns
    (planes, keep (cap,) bool rows that count, n_keep () int32, n_valid ()
    int64 valid windows before the pass filter, n_inside () int64, bank
    plane (cap,) int32 or None)."""
    G, B = lengths.shape
    dev = lengths.device
    if packed:
        words = codes.reshape(G * B, -1)
        vmask = None if valid is None else valid.reshape(G * B, -1)
    else:
        L = codes.shape[2]
        words = pack_words(codes.reshape(G * B, L))
        vmask = pack_valid(valid.reshape(G * B, L))
    P = L - k + 1
    rows = G * B * P
    cap = _next_pow2(max(rows, 256))
    planes, keep, n_keep, n_valid = extract_planes(
        words, vmask, lengths.reshape(-1), k, L, cap, m=m,
        nb_passes=nb_passes, pass_i=pass_i)
    bank = None
    if bank_ids is not None:
        bank = torch.zeros((cap,), dtype=I32, device=dev)
        bank[:rows] = bank_ids.reshape(-1, 1).expand(-1, P).reshape(-1).to(
            I32)
    n_inside = torch.clamp(lengths.to(I64) - (k - 1), min=0).sum()
    return planes, keep, n_keep, n_valid, n_inside, bank


def _batch_count_step(codes, valid, lengths, pass_i, *, k: int, m: int,
                      nb_passes: int, spare: bool):
    """One read batch: extraction + pass filter + sort/reduce count +
    stats scalars. codes/valid: (B, L); lengths: (B,). Returns
    (table.kmers (C, W), table.counts, n_valid, n_inside)."""
    kb = extract_kmers(codes, valid, lengths, k, m)
    pv = kb.valid
    if nb_passes > 1:
        # reference pass filter: minimizer % nbPass == pass
        # (SortingCountAlgorithm.cpp:806)
        pv = pv & (kb.minimizer % nb_passes == pass_i)
    table = count_batch(kb.kmers, pv, spare_bits=spare)
    n_valid = kb.valid.sum()
    n_inside = torch.clamp(lengths.to(I64) - (k - 1), min=0).sum()
    return table.kmers, table.counts, n_valid, n_inside


def _superbatch_count(codes, valid, lengths, pass_i, *, k: int, m: int,
                      nb_passes: int, spare: bool,
                      cap_out: int | None = None,
                      packed: bool = False, L: int | None = None):
    """One whole superbatch (G stacked read batches) of the LSM chain:
    extraction + pass filter + ONE plane sort (rows padded to a power of
    two with sentinels, which the sort kernels need) + the distinct
    reduce into a table of its own.

    This mirrors the reference's per-partition sort granularity
    (PartitionsCommand.cpp:1474-1505) rather than its read-batch
    granularity: a few large sorts dedup ~coverage-x duplicates in one
    reduce each.

    codes/valid: (G, B, L) bytes, or with packed=True the packed words /
    validity bitmasks ((G, B, ceil(L/16)) / (G, B, ceil(L/32)) uint32
    patterns, pack_words layout) with L the unpacked length; lengths:
    (G, B). Returns (planes (w, cap), counts, n, overflow, n_valid,
    n_inside); overflow is n > cap_out, and the caller then re-runs with
    cap_out=None (capacity = the padded row count, always exact).
    """
    planes, keep, _, n_valid, n_inside, _ = _extract_superbatch(
        codes, valid, lengths, pass_i, k=k, m=m, nb_passes=nb_passes,
        packed=packed, L=L)
    out_p, counts, n, overflow = count_planes(planes, keep, spare_bits=spare,
                                              cap_out=cap_out)
    return out_p, counts, n, overflow, n_valid, n_inside


def _superbatch_count_fold(codes, valid, lengths, pass_i, acc_planes,
                           acc_counts, acc_n, reset, *, k: int, m: int,
                           nb_passes: int, packed: bool,
                           L: int | None, cap_acc: int,
                           cap_out: int | None = None):
    """Fused count+fold superbatch step: extraction + raw sort + ONE
    merge level against the device-resident accumulated table + a single
    distinct reduce.

    codes/valid: (G, B, L) bytes/bools, or with packed=True the packed
    words / validity bitmasks ((G, B, ceil(L/16)) / (G, B, ceil(L/32))
    uint32 patterns) with L the unpacked length, valid may then be None
    (dense mode); lengths: (G, B). acc_planes (W, cap_acc) int32,
    acc_counts (cap_acc,) int32 and acc_n are the accumulator; ``reset``
    (a host bool) treats it as empty. acc_planes and acc_counts are
    updated IN PLACE and returned (the JAX version donates them).

    The raw rows are padded to a power of two with all-ones sentinels
    (a canonical k-mer is never all-ones, ops/sortops._encode_invalid),
    sorted by the limb-sort kernels, and either merged directly (raw mode,
    ``cap_out=None``: they must fit cap_acc) or first reduced to their own
    distinct table at capacity ``cap_out`` (compact mode). The two sorted
    runs, accumulator and new rows, merge in one out-of-place level (a new
    tensor beside the two runs) with the counts riding as the least
    significant key plane (summed per run
    downstream, so their order inside an equal-k-mer run is irrelevant).

    Transactional: if either capacity overflows, the accumulator is left
    as it came in, or empty after a reset (the host replays this
    superbatch with grown capacities).

    Returns (acc_planes', acc_counts', acc_n', flags (2,) int32
    [out_ovf, acc_ovf], n_local, n_valid, n_inside), all on the device.
    """
    w = nb_limbs(k)
    G, B = lengths.shape
    dev = lengths.device
    rows = G * B * ((L if packed else codes.shape[2]) - k + 1)
    if cap_out is None and rows > cap_acc:
        raise ValueError(f"fold(raw): superbatch rows {rows} > cap_acc "
                         f"{cap_acc}")
    sraw, _, nv, n_valid, n_inside, _ = _extract_superbatch(
        codes, valid, lengths, pass_i, k=k, m=m, nb_passes=nb_passes,
        packed=packed, L=L)
    sraw = sort_u32_limbs(sraw)
    if cap_out is not None:
        # compact-first: reduce the raw rows to their distinct table
        sidx = torch.arange(sraw.shape[1], device=dev)
        raw_p, raw_c, n_loc, ovf_out = count_sorted_planes(
            sraw, sidx >= nv, cap_out=cap_out)
        n_new = torch.clamp(n_loc, max=cap_out)
        run = max(cap_acc, cap_out)
    else:
        raw_p, raw_c = sraw, None
        n_loc = n_new = nv
        ovf_out = torch.zeros((), dtype=torch.bool, device=dev)
        run = cap_acc
    if reset:
        acc_planes.fill_(SENTINEL)
        acc_counts.zero_()
        acc_n = 0
    acc_n_eff = torch.as_tensor(acc_n, dtype=I32, device=dev)
    # the two sorted runs side by side, counts as the last plane
    cat = torch.full((w + 1, 2 * run), SENTINEL, dtype=I32, device=dev)
    cat[w].zero_()
    cat[:w, :cap_acc] = acc_planes
    cat[w, :cap_acc] = acc_counts
    nr = raw_p.shape[1]
    cat[:w, run:run + nr] = raw_p
    if raw_c is None:
        cat[w, run:run + nr] = (torch.arange(nr, device=dev) < nv).to(I32)
    else:
        cat[w, run:run + nr] = raw_c
    cat = merge_sorted_runs(cat, run)
    inv = torch.arange(2 * run, device=dev) >= (acc_n_eff + n_new)
    out_p, out_c, n2, ovf_acc = count_sorted_planes(
        cat[:w], inv, weights=cat[w], cap_out=cap_acc)
    ovf = ovf_out | ovf_acc
    acc_planes.copy_(torch.where(ovf, acc_planes, out_p))
    acc_counts.copy_(torch.where(ovf, acc_counts, out_c))
    keep_n = torch.where(ovf, acc_n_eff, n2)
    flags = torch.stack([ovf_out, ovf_acc]).to(I32)
    return acc_planes, acc_counts, keep_n, flags, n_loc, n_valid, n_inside


def _empty_table(w: int, cap: int, device):
    """An empty (cap,) distinct table: sentinel planes, zero counts, n=0."""
    return (torch.full((w, cap), SENTINEL, dtype=I32, device=device),
            torch.zeros((cap,), dtype=I32, device=device),
            torch.zeros((), dtype=I32, device=device))


_SYNC_UB_ROWS = 1 << 24


def _merge_smallest_pair(lst) -> None:
    """Merge the two smallest device tables of `lst` in place (one
    merge level + reduce, ops/sortops.merge_tables_planes): the
    rolling-merge step that bounds device memory during a pass.

    Entries are (planes, counts, n, ub): n may be a DEVICE scalar (no host
    sync on the merge path: reading it would serialise the chain of
    merges behind the host); ub is a host-known upper bound that sizes
    merge capacities. ua+ub gives high-overlap merges NO dedup credit, so
    a pass's chained merges would grow caps toward the pass's TOTAL rows;
    once the bound crosses _SYNC_UB_ROWS the exact n is read (one wait,
    negligible at that scale) and becomes the bound. Rows past n are
    all-ones sentinels (the compaction pads with them), so chained merges
    mask them without trimming."""
    # LAZY bound refresh: entries whose soft bound crossed the sync
    # threshold read their exact n NOW; the work that produced them was
    # typically queued superbatches ago, so the read no longer stalls the
    # pipeline
    for i, t in enumerate(lst):
        if t[3] >= _SYNC_UB_ROWS:
            with time_info.span("count.merge_wait"):
                lst[i] = (t[0], t[1], t[2], int(t[2]))
    lst.sort(key=lambda t: t[3])
    (pa, ca, na, ua), (pb, cb, nb, ub) = lst[0], lst[1]
    cap_out = _next_pow2(max(ua + ub, 256))
    planes, counts, n, _ = merge_tables_planes(pa, ca, na, pb, cb, nb,
                                               cap_out=cap_out)
    del lst[:2]
    lst.append((planes, counts, n, ua + ub))


def _merge_table_list(tables, w: int):
    """Merge a list of (planes, counts, n, ub) distinct tables into final
    host (kmers (N, W), counts (N,)) arrays: sync-free merges (device n
    scalars, ub-sized capacities), ONE n read, one packed table fetch."""
    tables = [t for t in tables if t[3] > 0]
    if not tables:
        return np.zeros((0, w), np.uint32), np.zeros((0,), np.int32)
    while len(tables) > 1:
        _merge_smallest_pair(tables)
    planes, counts, n, _ = tables[0]
    return _fetch_table(planes, counts, int(n), w)


def _pack_counts(c: torch.Tensor, valid: torch.Tensor, max_exc: int):
    """Counts of one table slice for the host fetch: (c8 uint8 clamped at
    254 and 0 on dead rows, n_exc, exc_pos (max_exc,) ascending slice
    positions of the counts >= 255 padded with MAX_INT32, exc_val their
    int32 values). No host sync: the exception rows are compacted with a
    prefix sum and a scatter into a list with one dump slot."""
    dev = c.device
    rows = c.shape[0]
    idx = torch.arange(rows, dtype=I32, device=dev)
    c8 = torch.where(valid, torch.clamp(c, max=254),
                     torch.zeros_like(c)).to(torch.uint8)
    is_exc = (c >= 255) & valid
    pos = torch.cumsum(is_exc, dim=0) - 1
    n_exc = is_exc.sum().to(I32)
    dest = torch.where(is_exc & (pos < max_exc), pos,
                       torch.full_like(pos, max_exc))
    exc_pos = torch.full((max_exc + 1,), MAX_INT32, dtype=I32, device=dev)
    exc_pos.index_copy_(0, dest, idx)
    exc_pos = exc_pos[:max_exc]
    exc_val = c[torch.clamp(exc_pos, max=rows - 1).long()]
    return c8, n_exc, exc_pos, exc_val


def _pack_table(planes: torch.Tensor, counts: torch.Tensor, n,
                cap_out: int | None = None, max_exc: int = 4096):
    """Pack a distinct table for the host fetch: the first cap_out rows as
    ONE row-major (cap_out, W) tensor (what the host table is; capacities
    can exceed pow2(n) on the sync-free merge path), counts clamped to
    uint8, and the rare counts >= 255 as an exception list: 9/12 of the
    int32 bytes for W=2. Returns (rows, c8, n_exc, exc_pos, exc_val)."""
    cap = counts.shape[0]
    if cap_out is None or cap_out > cap:
        cap_out = cap
    valid = torch.arange(cap_out, device=counts.device) < n
    return (planes[:, :cap_out].T.contiguous(),) + _pack_counts(
        counts[:cap_out], valid, max_exc)


def _pack_table_chunk(planes: torch.Tensor, counts: torch.Tensor,
                      start: int, n, chunk: int, max_exc: int = 4096):
    """Chunked variant of _pack_table: rows [start, start+chunk) of a
    device distinct table; chunk-aligned starts never run past the
    capacity because it is a power-of-two multiple of the power-of-two
    chunk."""
    valid = (torch.arange(chunk, device=counts.device) + start) < n
    return (planes[:, start:start + chunk].T.contiguous(),) + _pack_counts(
        counts[start:start + chunk], valid, max_exc)


def _host_copies(tensors, stream=None):
    """Device tensors -> host tensors (pinned, copied asynchronously on
    ``stream``) plus the event that marks the copies done; CPU tensors
    come back as they are, with no event."""
    if not tensors[0].is_cuda:
        return list(tensors), None
    with torch.cuda.stream(stream):
        out = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                            pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        ev = torch.cuda.Event()
        ev.record()
    return out, ev


def _unpack_host(rows_h, c8, n_exc, exc_pos, exc_val, rows: int):
    """Host side of the packed format -> (kmers (rows, W) uint32, counts
    (rows,) int32), or None when the exception list overflowed."""
    ne = int(n_exc)
    if ne > exc_pos.shape[0]:
        return None
    cnt = c8.numpy().astype(np.int32)
    if ne:
        cnt[exc_pos.numpy()[:ne]] = exc_val.numpy()[:ne]
    return rows_h.numpy().view(np.uint32)[:rows], cnt[:rows]


def _fetch_table(planes, counts, n: int, w: int, max_exc: int = 4096):
    """ONE host fetch of a device distinct table -> (kmers (n, W) uint32,
    counts (n,) int32). Counts ride as uint8 + an exception list; if the
    exception capacity overflows (pathological distribution) the counts
    are fetched again exactly, as int32."""
    if n == 0:
        return np.zeros((0, w), np.uint32), np.zeros((0,), np.int32)
    packed = _pack_table(planes, counts, n,
                         cap_out=_next_pow2(max(n, 256)), max_exc=max_exc)
    host, ev = _host_copies(packed, torch.cuda.current_stream(planes.device)
                            if planes.is_cuda else None)
    if ev is not None:
        ev.synchronize()
    got = _unpack_host(*host, rows=n)
    if got is None:
        return _fetch_table_whole(planes, counts, n, w)
    return got


def _fetch_table_whole(planes, counts, n: int, w: int):
    """The plain fetch: planes and int32 counts copied whole with
    ``.cpu()`` -> (kmers (n, W) uint32, counts (n,) int32)."""
    if n == 0:
        return np.zeros((0, w), np.uint32), np.zeros((0,), np.int32)
    return (kmers_to_numpy(planes[:, :n]),
            counts[:n].cpu().numpy().astype(np.int32))


class _StreamedTable:
    """Per-pass distinct table streamed from device to host in chunks.

    A background thread packs each chunk on a side stream, copies it into
    pinned host memory without blocking and records an event behind the
    copies; it hands a chunk to the consumer (the CountProcessor sweep)
    only after that event, so the sweep works on earlier chunks while
    later ones are in flight and never reads one that still is. Chunks are
    cached on the host, so a repeated iteration (the auto-cutoff double
    sweep) fetches nothing again, and the device references are dropped
    once the fetch completes."""

    def __init__(self, planes, counts, n: int, w: int,
                 chunk_rows: int = 1 << 23, max_exc: int = 4096):
        self.n = int(n)
        self.w = w
        self._chunks: list = []
        self._err: BaseException | None = None
        self._done = self.n == 0
        self._cond = threading.Condition()
        if self._done:
            return
        cap = counts.shape[0]
        chunk = min(_next_pow2(max(chunk_rows, 256)), cap)
        starts = list(range(0, self.n, chunk))
        stream = None
        if planes.is_cuda:
            # the side stream starts behind the work that made the table
            stream = torch.cuda.Stream(planes.device)
            stream.wait_stream(torch.cuda.current_stream(planes.device))

        def pull(planes=planes, counts=counts):
            try:
                for s in starts:
                    rows = min(self.n - s, chunk)
                    with torch.cuda.stream(stream):
                        pk = _pack_table_chunk(planes, counts, s, self.n,
                                               chunk, max_exc)
                    host, ev = _host_copies(pk, stream)
                    if ev is not None:
                        ev.synchronize()
                    got = _unpack_host(*host, rows=rows)
                    if got is None:
                        # pathological count distribution: exact fetch
                        with torch.cuda.stream(stream):
                            exact = [counts[s:s + rows]]
                        (c_h,), ev = _host_copies(exact, stream)
                        if ev is not None:
                            ev.synchronize()
                        got = (host[0].numpy().view(np.uint32)[:rows],
                               c_h.numpy().astype(np.int32))
                    with self._cond:
                        self._chunks.append(got)
                        self._cond.notify_all()
            except BaseException as e:
                with self._cond:
                    self._err = e
                    self._cond.notify_all()
            finally:
                planes = counts = None
                with self._cond:
                    self._done = True
                    self._cond.notify_all()

        self._thread = threading.Thread(target=pull, daemon=True)
        self._thread.start()

    def iter(self):
        i = 0
        while True:
            with self._cond:
                if self._missing(i):
                    with time_info.span("count.fetch_wait"):
                        self._cond.wait_for(lambda: not self._missing(i))
                if self._err is not None:
                    raise self._err
                if i < len(self._chunks):
                    chunk = self._chunks[i]
                else:
                    return
            yield chunk
            i += 1

    def _missing(self, i: int) -> bool:
        """Chunk ``i`` is still to come (under ``_cond``)."""
        return i >= len(self._chunks) and not self._done \
            and self._err is None

    def materialize(self):
        """Concatenated (kmers, counts) host arrays."""
        ks, cs = [], []
        for uk, uc in self.iter():
            ks.append(uk)
            cs.append(uc)
        if not ks:
            return (np.zeros((0, self.w), np.uint32),
                    np.zeros((0,), np.int32))
        return np.concatenate(ks), np.concatenate(cs)


class _MaterialTable:
    """Already-fetched (kmers (N, W) uint32, counts (N,) int32) host table
    with the same .iter() surface as _StreamedTable (LSM path)."""

    def __init__(self, kmers: np.ndarray, counts: np.ndarray):
        self._kmers, self._counts = kmers, counts
        self.n = len(counts)
        self.w = kmers.shape[1] if kmers.ndim == 2 else 0

    def iter(self):
        if self.n:
            yield self._kmers, self._counts

    def materialize(self):
        return self._kmers, self._counts


def _empty_host_table(w: int) -> _MaterialTable:
    return _MaterialTable(np.zeros((0, w), np.uint32),
                          np.zeros((0,), np.int32))


# the solidity kinds that, on one bank, are each lo <= count <= hi
_DEVICE_KINDS = ("sum", "min", "max", "all", "one")


class _DeviceChain:
    """The default processor vector (histogram -> solidity -> collect) on
    the device, for a kind of ``_DEVICE_KINDS``: at each pass end the
    pass's table adds into the histogram's device bins and its solid rows
    are compacted (``ops.solid_select``) and copied to pinned host memory
    without blocking; ``result`` waits for the copies and brings the bins
    over once. An auto cutoff (one pass only) is computed from the pass's
    histogram before its select."""

    def __init__(self, cfg: CountConfig, device):
        self.cfg = cfg
        self.histogram = Histogram(cfg.histo_max)
        self.bins = torch.zeros((cfg.histo_max + 1,), dtype=I64,
                                device=device)
        self.cutoff = None if cfg.auto_cutoff else int(cfg.abundance_min)
        self.copies: list = []      # ((rows, counts) on the host, event)

    def _fetch_bins(self) -> None:
        self.histogram.bins = self.bins.cpu().numpy().astype(np.uint64)

    def end_pass(self, planes, counts, n: int) -> None:
        cfg = self.cfg
        bins = self.bins
        if self.cutoff is None:
            solid_histogram(counts, n, bins, cfg.histo_max)
            self._fetch_bins()
            self.cutoff = self.histogram.compute_threshold(
                cfg.abundance_min_threshold)
            bins = None
        rows, cnt = solid_select(planes, counts, n, self.cutoff,
                                 cfg.abundance_max, bins, cfg.histo_max)
        self.copies.append(_host_copies([rows, cnt]))

    def result(self, w: int):
        """(solid k-mers (N, W) uint32, their counts (N,) int32), sorted
        across the passes; sets the histogram's bins and cutoff."""
        with time_info.span("count.fetch_wait"):
            for _, ev in self.copies:
                if ev is not None:
                    ev.synchronize()
        self._fetch_bins()
        if self.cutoff is None:     # auto, and no pass saw a k-mer
            self.cutoff = self.histogram.compute_threshold(
                self.cfg.abundance_min_threshold)
        elif not self.cfg.auto_cutoff:
            self.histogram.cutoff = self.cutoff
        parts = [(rows.numpy().view(np.uint32), cnt.numpy())
                 for (rows, cnt), _ in self.copies]
        if not parts:
            return np.zeros((0, w), np.uint32), np.zeros((0,), np.int32)
        if len(parts) == 1:
            return parts[0]
        from .count_processor import CountProcessorCollect

        collect = CountProcessorCollect()
        for rows, cnt in parts:
            collect.process_table(0, rows, cnt[:, None], cnt)
        kmers, _, sums = collect.result(w)
        return kmers, sums


def _global_merge(kmers: np.ndarray, counts: np.ndarray, w: int,
                  device="cuda"):
    """Device sort+reduce of concatenated partial host tables -> final
    (kmers, counts) host table."""
    n = len(kmers)
    if n == 0:
        return kmers, counts
    cap = _next_pow2(max(n, 8))
    pk = np.full((cap, w), 0xFFFFFFFF, np.uint32)
    pc = np.zeros((cap,), np.int32)
    pk[:n] = kmers
    pc[:n] = counts
    inv = np.ones((cap,), bool)
    inv[:n] = False
    table = _merge_jit(_stage(pk, device), _stage(pc, device),
                       _stage(inv, device))
    m = int(table.n)
    return (np.ascontiguousarray(
        table.kmers[:m].cpu().numpy().view(np.uint32)),
        table.counts[:m].cpu().numpy())


def _merge_jit(kmers, counts, inv) -> CountTable:
    """Sort (C, W) rows with their counts and reduce them to a CountTable
    (the name is the JAX module's, where this is one jitted program). The
    counts ride as an extra least-significant key plane: their order
    within equal-k-mer runs is irrelevant (summed by count_sorted)."""
    sk, si, sc = pallas_sort_rows(kmers, inv, False, counts)
    return count_sorted(sk, si, weights=sc)


class SortingCount(Algorithm):
    """Driver for the counting pipeline (SortingCountAlgorithm equivalent),
    on the Algorithm execute()/run()/get_info() contract
    (Algorithm.hpp:8-120).

    ``processor`` plugs a custom CountProcessor (kmer/count_processor.py,
    the ICountProcessor.hpp:92-200 extension point) into the run: it
    joins the processor vector as its own sweep, receiving every pass's
    kmer-complete table with full lifecycle calls. ``run()`` records the
    ``count`` span, with the superbatches dispatched and the ``replays``
    among them (dispatched again after an overflow), the row width in
    ``limbs``, the k-mer ``windows`` counted and the ``distinct`` rows
    after the reduce as its counts."""

    span = "count"

    def __init__(self, config: CountConfig | None = None, processor=None):
        super().__init__("dsk")
        self.config = config or CountConfig()
        self.processor = processor

    def execute(self, bank) -> CountResult:
        """Optimistic pass execution: runs with cfg.nb_passes, and if the
        accumulated distinct tables blow the soft memory budget mid-run,
        restarts with doubled passes (exact either way — the pass filter
        partitions kmers)."""
        nb_passes = max(1, int(self.config.nb_passes))
        while True:
            try:
                return self._execute(bank, nb_passes)
            except _RePlan as rp:
                nb_passes *= 2
                if nb_passes > 64:
                    raise RuntimeError(
                        "counting re-plan exceeded 64 passes") from rp

    def _execute(self, bank, nb_passes: int) -> CountResult:
        cfg = self.config
        device = torch.device(cfg.device)
        bank = open_bank(bank)
        k = cfg.kmer_size
        w = nb_limbs(k)
        t0 = time.time()
        root = time_info.current()      # ``count``, where it is recorded

        builder = _BatchBuilder(k, cfg.batch_reads, cfg.batch_len)
        valid_scalars: list[int] = []
        inside_scalars: list[int] = []
        nb_seq = 0
        seq_total_size = 0
        # BankStats block (SortingCountAlgorithm.cpp:735-742)
        seq_min = [-1]
        seq_max = [0]
        seq_sumsq = [0.0]
        spare = (2 * k) % 32 != 0
        native_paths = _native_fastx_paths(bank)
        # soft budget: STORED bytes per live table row (limb planes +
        # counts); sort transients are bounded separately by
        # cfg.superbatch_rows and do not persist across superbatches
        row_bytes = 4 * w + 4
        budget_rows = max(cfg.table_budget_bytes // row_bytes, 1024)

        rows_per_batch = cfg.batch_reads * (builder.L - k + 1)
        G = max(1, int(cfg.superbatch_rows) // rows_per_batch)

        packed = bool(cfg.packed_transfer)

        def produce(count_stats: bool):
            """Host batch stream (parse + 2-bit encode [+ pack]), run on a
            producer thread so parsing overlaps device work."""
            nonlocal nb_seq, seq_total_size
            if native_paths is not None:
                # native C++ parse+encode+batch path (native/fastx.cpp),
                # batch shapes identical to _BatchBuilder; the C call
                # releases the GIL
                from ..native import NativeBatcher

                for path in native_paths:
                    nat = NativeBatcher(path, k, cfg.batch_reads, builder.L)
                    it = nat.iter_packed() if packed else iter(nat)
                    for batch in it:
                        yield batch
                    if count_stats:
                        s_n, s_t, s_mn, s_mx, s_sq = nat.stats_full()
                        nb_seq += s_n
                        seq_total_size += s_t
                        if s_n:
                            seq_min[0] = s_mn if seq_min[0] < 0 \
                                else min(seq_min[0], s_mn)
                            seq_max[0] = max(seq_max[0], s_mx)
                            seq_sumsq[0] += s_sq
            else:
                from ..ops.bitpack import pack_batch_np

                def emit(batch):
                    if not packed:
                        return batch
                    codes, val, lens, row = batch
                    words, vmask = pack_batch_np(codes, val)
                    return words, vmask, lens, row

                for seq in bank:
                    if count_stats:
                        nb_seq += 1
                        L = len(seq)
                        seq_total_size += L
                        seq_min[0] = L if seq_min[0] < 0 \
                            else min(seq_min[0], L)
                        seq_max[0] = max(seq_max[0], L)
                        seq_sumsq[0] += float(L) * L
                    for batch in builder.add(seq.data):
                        yield emit(batch)
                if builder.row:
                    yield emit(builder.flush())

        # per-pass lists of (planes, counts, n, ub) distinct tables of the
        # LSM chain, rolling-merged so device memory stays bounded: at most
        # _MAX_LIVE_LSM tables during a pass, ONE accumulated table per
        # finished pass
        tables: dict[int, list] = {}
        host_tables: dict[int, object] = {}   # pass -> fetched table
        distinct = [0]        # the passes' distinct rows
        # the default processor vector runs on the device unless the
        # caller plugs a processor, the solidity kind is custom, or an
        # auto cutoff needs every pass's histogram before any select
        chain = None
        if self.processor is None and cfg.solidity_kind in _DEVICE_KINDS \
                and not (cfg.auto_cutoff and nb_passes > 1):
            chain = _DeviceChain(cfg, device)

        def finish_pass(pass_i, table):
            """A pass's distinct table, (planes, counts, n) or None when
            the pass saw no k-mer: its solid rows selected on the device,
            or, for the host chain, an empty host table where there is no
            table (the callers fetch the others)."""
            n_pass = 0 if table is None else table[2]
            distinct[0] += n_pass
            if chain is None:
                if table is None:
                    host_tables[pass_i] = _empty_host_table(w)
                return
            root.count(solid_select=1)
            if n_pass:
                with ti.section("4.process", span="count.process"):
                    chain.end_pass(*table)
        n_resolved = [0]
        _MAX_LIVE_LSM = 10   # hard cap on live per-pass tables
        # adaptive distinct-ratio estimate: start from the caller's plan
        # hint, learn from each superbatch's measured n/rows
        dedup_ratio = {"est": float(cfg.distinct_ratio_hint)}
        from ..misc.time_info import Progress, TimeInfo

        ti = TimeInfo()
        try:
            est_n, est_total, _ = bank.estimate()
            est_batches = max(1, est_total // max(
                cfg.batch_reads * builder.L, 1) + 1)
        except Exception:
            est_batches = 1
        progress = Progress(est_batches * nb_passes,
                            "DSK: counting kmers",
                            verbose=cfg.verbose > 0)

        pending: list = []  # dispatched superbatches awaiting resolution
        # multi-pass device-resident bank cache: every DSK pass streams
        # the SAME packed reads (the pass filter is on the device), so
        # pass 0 keeps its staged device tensors and later passes dispatch
        # off them: no re-parse, no re-upload. Budget-gated: the cache is
        # dropped whole the moment it would exceed cfg.bank_cache_bytes.
        bank_cache: list | None = [] if nb_passes > 1 else None
        cache_bytes = [0]

        # ---- fused count+fold accumulator state ------------------------
        # one device step per superbatch (_superbatch_count_fold). The
        # in-flight window stays 2 deep (the overflow flags are read
        # lazily at resolve time, so device work queues ahead of the
        # host); an overflowed superbatch was NOT committed (transactional
        # fold), so it is replayed from its staged inputs on a doubled
        # accumulator, the pre-growth acc is parked, and parked accs fold
        # back in at pass end with one merge each.
        use_fold = bool(cfg.carry_accumulator)
        cap0 = _next_pow2(max(G * rows_per_batch, 256))
        if use_fold:
            while G > 1 and cap0 > budget_rows:
                G //= 2
                cap0 = _next_pow2(max(G * rows_per_batch, 256))
            if cap0 > budget_rows:
                use_fold = False  # tiny budget: LSM compacts per batch
        fold = {"p": None, "c": None, "n": None, "cap": 0,
                "parked": [], "replay": [],
                "growing": False, "n_known": 0, "used": False}
        cap_budget = max(_next_pow2(budget_rows), 1024)

        def fold_arrays(cap: int):
            fold["p"], fold["c"], fold["n"] = _empty_table(w, cap, device)
            fold["cap"] = cap
            fold["used"] = False

        def fold_park_and_grow(newcap: int):
            """Drain the window, park the committed acc, continue on a
            fresh accumulator of ``newcap`` rows (parked accs fold back
            in at pass end — proactive growth, no replays)."""
            if newcap > cap_budget:
                raise _RePlan(nb_passes)
            while pending:
                fold_resolve(pending.pop(0))
            if fold["p"] is not None and fold["used"]:
                fold["parked"].append((fold["p"], fold["c"], fold["n"]))
            fold_arrays(newcap)

        def fold_caps(rows: int):
            """(cap_out | None, capR) for a superbatch of ``rows`` raw
            rows: compact-first when the learned distinct ratio says the
            per-superbatch table is far below the raw row count."""
            capR = _next_pow2(max(rows, 256))
            est = dedup_ratio["est"]
            co = _next_pow2(max(256, min(rows, int(rows * est * 1.5))))
            return (co if co <= capR // 4 else None), capR

        def fold_dispatch(codes, valid, lengths, pass_i, count_stats,
                          g_len):
            rows = codes.shape[0] * rows_per_batch
            cap_out_d, capR = fold_caps(rows)
            if fold["p"] is None:
                # fresh pass: raw mode needs room for the raw rows;
                # compact mode sizes from the distinct estimate with 4x
                # headroom; a previous pass's grown capacity is kept
                init = capR if cap_out_d is None else \
                    min(capR, max(4 * cap_out_d, 1 << 12))
                fold_arrays(max(fold["cap"], init))
            elif cap_out_d is None and fold["cap"] < capR:
                # mode flipped to raw mid-run: the acc must hold raw rows
                fold_park_and_grow(capR)
            elif cap_out_d is not None and fold["used"] \
                    and fold["cap"] < capR \
                    and fold["n_known"] + 3 * cap_out_d > fold["cap"]:
                # proactive: the (lagged) live count plus the in-flight
                # window could overflow — grow now, without replays
                fold_park_and_grow(
                    min(capR, max(fold["cap"] * 2,
                                  _next_pow2(fold["n_known"]
                                             + 4 * cap_out_d))))
            # reset=False: every accumulator comes fresh from fold_arrays
            root.count(superbatches=1)
            with ti.section("2.sort", span="count.dispatch"):
                out = _superbatch_count_fold(
                    codes, valid, lengths, pass_i,
                    fold["p"], fold["c"], fold["n"], False,
                    k=k, m=cfg.minimizer_size, nb_passes=nb_passes,
                    packed=packed,
                    L=builder.L if packed else None,
                    cap_acc=fold["cap"], cap_out=cap_out_d)
            keep_p, keep_c, keep_n, flags, n_loc, nv, ni = out
            fold["p"], fold["c"], fold["n"] = keep_p, keep_c, keep_n
            fold["used"] = True
            pending.append((flags, n_loc, keep_n, nv, ni,
                            (codes, valid, lengths), pass_i,
                            count_stats, g_len, rows,
                            cap_out_d is not None))
            # window 2: each in-flight fold keeps its staged inputs alive
            # for a possible replay
            while len(pending) > 2:
                fold_resolve(pending.pop(0))

        def fold_resolve(item):
            (flags, n_loc, keep_n, nv, ni, staged, pass_i, count_stats,
             g_len, rows, compact) = item
            with ti.section("2.sort", span="count.resolve"):
                # ONE device->host copy for all of this superbatch's
                # scalars
                fl0, fl1, nl, kn, nvv, niv = torch.cat(
                    [flags.to(I64), torch.stack(
                        [n_loc.to(I64), keep_n.to(I64), nv, ni])]).tolist()
            if count_stats:
                valid_scalars.append(int(nvv))
                inside_scalars.append(int(niv))
            if fl0 or fl1:
                if fl0:   # cap_out too small: raise the ratio estimate
                    dedup_ratio["est"] = min(
                        1.0, max(dedup_ratio["est"] * 2, int(nl) / rows))
                fold["replay"].append((staged, pass_i, bool(fl1)))
            else:
                fold["n_known"] = max(fold["n_known"], int(kn))
                if compact:
                    dedup_ratio["est"] = max(dedup_ratio["est"],
                                             int(nl) / rows)
                elif n_resolved[0] == 0:
                    # first raw superbatch onto an empty acc: keep_n IS
                    # its distinct count — calibrate the ratio
                    dedup_ratio["est"] = max(dedup_ratio["est"],
                                             int(kn) / rows)
            n_resolved[0] += 1
            progress.inc(g_len)

        def fold_grow_and_replay():
            """Overflow seen: drain the window (collecting any further
            overflows), park the committed acc, grow the blown
            capacity, replay the uncommitted superbatches."""
            fold["growing"] = True
            try:
                while pending:
                    fold_resolve(pending.pop(0))
                while fold["replay"]:
                    replays, fold["replay"] = fold["replay"], []
                    if any(acc_ovf for _, _, acc_ovf in replays):
                        newcap = fold["cap"] * 2
                        if newcap > cap_budget:
                            raise _RePlan(nb_passes)
                        if fold["p"] is not None and fold["used"]:
                            fold["parked"].append(
                                (fold["p"], fold["c"], fold["n"]))
                        fold_arrays(newcap)
                    root.count(replays=len(replays))
                    for staged, pi, _ in replays:
                        fold_dispatch(*staged, pi, False,
                                      staged[0].shape[0])
                    while pending:
                        fold_resolve(pending.pop(0))
            finally:
                fold["growing"] = False

        def fold_end_pass(pass_i):
            while pending:
                fold_resolve(pending.pop(0))
            if fold["replay"]:
                fold_grow_and_replay()
            with ti.section("3.merge", span="count.merge"):
                for (pp, pc, pn) in fold["parked"]:
                    while True:
                        planes_m, counts_m, n_m, ovf_m = merge_tables_planes(
                            pp, pc, pn, fold["p"], fold["c"], fold["n"],
                            cap_out=fold["cap"])
                        with time_info.span("count.merge_wait"):
                            ovf_m = bool(ovf_m)
                        if not ovf_m:
                            break
                        if fold["cap"] * 2 > cap_budget:
                            raise _RePlan(nb_passes)
                        fold["cap"] *= 2
                    fold["p"], fold["c"], fold["n"] = \
                        planes_m, counts_m, n_m
                fold["parked"] = []
                table = None
                if fold["p"] is not None:
                    with time_info.span("count.merge_wait"):
                        table = (fold["p"], fold["c"], int(fold["n"]))
                    if chain is None:
                        host_tables[pass_i] = _StreamedTable(
                            *table, w, chunk_rows=cfg.fetch_chunk_rows)
            finish_pass(pass_i, table)
            # the streamed fetch still reads these tensors and the fold
            # step updates its accumulator in place, so the next pass
            # starts from fresh tensors
            fold["p"] = fold["c"] = fold["n"] = None
            fold["n_known"] = 0

        def lsm_count(codes, valid, lengths, pass_i, cap_out):
            root.count(superbatches=1)
            return _superbatch_count(
                codes, valid, lengths, pass_i, k=k, m=cfg.minimizer_size,
                nb_passes=nb_passes, spare=spare, cap_out=cap_out,
                packed=packed, L=builder.L if packed else None)

        def lsm_cap_out(rows: int) -> int:
            """Distinct-table capacity of one superbatch: coverage makes
            distinct << rows; the ratio is learned from each superbatch's
            measured n/rows (with 1.5x headroom) and the overflow flag
            guards exactness (the re-run at full capacity), the role of
            the plan's distinct-kmer estimate in the reference
            (ConfigurationAlgorithm.cpp:308)."""
            return _next_pow2(max(
                256, min(rows, int(rows * dedup_ratio["est"] * 1.5))))

        def resolve(item):
            """Sync point of one superbatch: overflow check (+ exact rerun
            at full capacity when tripped), stats, ratio update."""
            out, rows, inputs, pass_i, first_pass, g_len = item
            with ti.section("2.sort", span="count.resolve"):
                # ONE device->host copy for all of this superbatch's
                # scalars (overflow flag, n, valid/inside counts)
                ov, n, nv, ni = torch.stack(
                    [out[3].to(I64), out[2].to(I64), out[4],
                     out[5]]).tolist()
                if ov:  # overflow: rerun unbounded (always exact); the
                    # table's capacity is then the padded row count, a
                    # power of two with a sentinel tail as merges need
                    root.count(replays=1)
                    with time_info.span("count.dispatch"):
                        out = lsm_count(*inputs, pass_i, None)
                    n, nv, ni = torch.stack(
                        [out[2].to(I64), out[4], out[5]]).tolist()
                out_p, counts = out[0], out[1]
                if first_pass:
                    valid_scalars.append(int(nv))
                    inside_scalars.append(int(ni))
                n = int(n)
                dedup_ratio["est"] = max(dedup_ratio["est"], n / rows)
            lst = tables.setdefault(pass_i, [])
            # no eager trim: rows past n are sentinel, merges mask them;
            # ub = n
            lst.append((out_p, counts, n, n))
            if sum(t[3] for t in lst) > budget_rows:
                # bounds are no-dedup sums; collapse every bound to the
                # exact n before concluding the pass really blew the
                # budget (high-overlap banks would otherwise spuriously
                # cascade re-plans)
                lst[:] = [(p, c, nn, int(nn)) for (p, c, nn, _u) in lst]
                if sum(t[3] for t in lst) > budget_rows:
                    raise _RePlan(nb_passes)
            n_resolved[0] += 1
            with ti.section("3.merge", span="count.merge"):
                # LSM-style size-classed merging: only merge the two
                # smallest tables while they are in the same size class.
                # An accumulate-into-one policy re-sorts the big table
                # once per superbatch, O(N*P) rows; the binary-counter
                # tree is O(N*log P) with <= ~log2(P)+2 live tables
                while len(lst) >= 2:
                    lst.sort(key=lambda t: t[3])
                    if len(lst) <= _MAX_LIVE_LSM \
                            and lst[1][3] > 2 * lst[0][3]:
                        break
                    _merge_smallest_pair(lst)
            progress.inc(g_len)

        def end_pass(pass_i):
            """Pass boundary: drain + merge this pass down to ONE table
            and FETCH it to the host: device memory holds at most the
            active pass's tables, so the _RePlan budget bounds it."""
            while pending:
                resolve(pending.pop(0))
            table = None
            with ti.section("3.merge", span="count.merge"):
                lst = tables.get(pass_i, [])
                while len(lst) > 1:
                    _merge_smallest_pair(lst)
                if lst:
                    planes_d, counts_d, n_d, _ = lst.pop()
                    with time_info.span("count.merge_wait"):
                        table = (planes_d, counts_d, int(n_d))
                        if chain is None:
                            host_tables[pass_i] = _MaterialTable(
                                *_fetch_table(*table, w))
            finish_pass(pass_i, table)

        def dispatch_staged(codes, valid, lengths, pass_i):
            """flush_group's tail for already-staged device tensors."""
            rows = codes.shape[0] * rows_per_batch
            with ti.section("2.sort", span="count.dispatch"):
                out = lsm_count(codes, valid, lengths, pass_i,
                                lsm_cap_out(rows))
            pending.append((out, rows, (codes, valid, lengths), pass_i,
                            False, codes.shape[0]))
            while len(pending) > 3:
                resolve(pending.pop(0))

        def flush_group(group, pass_i, first_pass):
            """One superbatch: stack G batches, stage them on the device,
            count (asynchronously)."""
            nonlocal bank_cache
            g = len(group)
            if g < G:
                # pad the tail group: fold mode pads to G (every
                # superbatch has one shape); the LSM path keeps the
                # next-pow2 rule its capacity sizing expects
                gp = G if use_fold else _next_pow2(g)
                B = group[0][0].shape[0]
                c_shape = group[0][0].shape
                v_shape = group[0][1].shape
                c_dt = group[0][0].dtype
                v_dt = group[0][1].dtype
                while len(group) < gp:
                    group.append((np.zeros(c_shape, c_dt),
                                  np.zeros(v_shape, v_dt),
                                  np.zeros((B,), np.int32), 0))
            with ti.section("1.stack", span="count.stage"):
                codes = _stage(np.stack([b[0] for b in group]), device)
                # dense transfer (fold+packed): a clean bank's all-ones
                # validity masks are not sent; extraction uses the
                # in-length rule
                if use_fold and packed and all(
                        _vmask_dense(b[1], b[2]) for b in group):
                    valid = None
                else:
                    valid = _stage(np.stack([b[1] for b in group]), device)
                lengths = _stage(np.stack([b[2] for b in group]), device)
            if bank_cache is not None and pass_i == 0:
                nb = _nbytes(codes) + _nbytes(lengths) + _nbytes(valid)
                if cache_bytes[0] + nb <= cfg.bank_cache_bytes:
                    bank_cache.append((codes, valid, lengths))
                    cache_bytes[0] += nb
                else:           # budget exceeded: drop the whole cache
                    bank_cache = None
            if use_fold:
                fold_dispatch(codes, valid, lengths, pass_i, first_pass, g)
                if fold["replay"] and not fold["growing"]:
                    fold_grow_and_replay()
                return
            rows = codes.shape[0] * rows_per_batch
            with ti.section("2.sort", span="count.dispatch"):
                out = lsm_count(codes, valid, lengths, pass_i,
                                lsm_cap_out(rows))
            pending.append((out, rows, (codes, valid, lengths), pass_i,
                            first_pass, len(group)))
            # resolve the FIRST superbatch immediately (learn the distinct
            # ratio before sizing the next); after that keep up to 3 in
            # flight so host parse + transfer overlap device work
            while len(pending) > (0 if n_resolved[0] == 0 else 3):
                resolve(pending.pop(0))

        # DSK pass loop (SortingCountAlgorithm.cpp:678): pass p keeps kmers
        # with minimizer % nb_passes == p; each pass streams the whole bank
        for pass_i in range(nb_passes):
            first_pass = pass_i == 0
            if not first_pass and bank_cache is not None:
                for staged in bank_cache:      # device-resident reuse
                    if use_fold:
                        fold_dispatch(*staged, pass_i, False,
                                      staged[0].shape[0])
                        if fold["replay"] and not fold["growing"]:
                            fold_grow_and_replay()
                    else:
                        dispatch_staged(*staged, pass_i)
            else:
                group: list = []
                for batch in _prefetch(produce(first_pass), depth=4):
                    group.append(batch)
                    if len(group) == G:
                        flush_group(group, pass_i, first_pass)
                        group = []
                if group:
                    flush_group(group, pass_i, first_pass)
            if use_fold:
                fold_end_pass(pass_i)
            else:
                end_pass(pass_i)

        t_fill = time.time() - t0
        progress.finish()

        # each pass yields ONE kmer-complete table (passes partition
        # kmers by minimizer, so a pass table is the reference's notion
        # of a completed partition)
        t1 = time.time()
        kmers_nb_valid = int(sum(valid_scalars))
        kmers_nb_invalid = int(sum(inside_scalars)) - kmers_nb_valid
        t_merge = time.time() - t1

        if chain is None:
            solid_kmers, solid_counts, histogram, amin = self._host_chain(
                ti, [(p, host_tables[p]) for p in range(nb_passes)], w)
        else:
            with ti.section("4.process", span="count.process"):
                solid_kmers, solid_counts = chain.result(w)
            histogram, amin = chain.histogram, chain.cutoff
        histogram.nb_solids_after_cutoff = len(solid_counts)
        nb_distinct = distinct[0]
        root.count(limbs=w, windows=kmers_nb_valid, distinct=nb_distinct,
                   solid=len(solid_counts))

        info = {
            "kmers_nb_distinct": nb_distinct,
            "kmers_nb_solid": int(len(solid_counts)),
            "kmers_nb_weak": int(nb_distinct - len(solid_counts)),
            "kmers_nb_valid": int(kmers_nb_valid),
            "kmers_nb_invalid": int(kmers_nb_invalid),
            "sequences_number": int(nb_seq),
            "sequences_size": int(seq_total_size),
            # seq_size_* (BankStats, SortingCountAlgorithm.cpp:735-742)
            "seq_size_min": int(max(seq_min[0], 0)),
            "seq_size_max": int(seq_max[0]),
            "seq_size_mean": round(seq_total_size / nb_seq, 1)
            if nb_seq else 0.0,
            "seq_size_deviation": round(
                max(seq_sumsq[0] / nb_seq
                    - (seq_total_size / nb_seq) ** 2, 0.0) ** 0.5, 1)
            if nb_seq else 0.0,
            "kmer_size": k,
            "abundance_min": amin,
            "abundance_max": cfg.abundance_max,
            "time_fill": t_fill,
            "time_merge": t_merge,
            # passes actually RUN (>= cfg.nb_passes after optimistic
            # re-planning, counting._RePlan)
            "nb_passes_effective": int(nb_passes),
            "parser": "python" if native_paths is None else "native",
            "device": str(device),
        }
        phases = ti.get_properties("fillsolid_time")
        info.update(phases)
        info["time.fill_partitions"] = round(
            t_fill - ti.entries.get("2.sort", 0.0), 3)
        info["time.fill_solid_kmers"] = round(
            ti.entries.get("2.sort", 0.0) + t_merge, 3)
        self.info.update(info)  # Algorithm.get_info() surface
        return CountResult(solid_kmers, solid_counts, histogram, info,
                           cfg)

    def _host_chain(self, ti, parts, w: int):
        """The processor vector on the host, for what the device chain
        does not take (a caller's processor, custom solidity, an auto
        cutoff over several passes): each pass's table, fetched whole
        (``parts``: (pass, host table) pairs), swept by the numpy chain and
        then by the caller's processor. Returns (solid k-mers, solid
        counts, histogram, abundance min)."""
        cfg = self.config
        # ---- count processor vector (ICountProcessor.hpp:92-200) --------
        # Default = histogram -> solidity -> collect, expressed as the
        # plugin chain; with "auto" abundance the histogram runs as its
        # own sweep first, exactly the reference's cutoff-processor +
        # dsk-processor vector (SortingCountAlgorithm.cpp:468-510).
        from .count_processor import (
            CountProcessorChain, CountProcessorCollect,
            CountProcessorHistogram, CountProcessorSolidity)

        hist_proc = CountProcessorHistogram(cfg.histo_max,
                                            cfg.abundance_min_threshold)
        amax = cfg.abundance_max
        if cfg.auto_cutoff:
            solidity = CountProcessorSolidity(
                cfg.solidity_kind, (0, amax), auto_histogram=hist_proc)
        else:
            solidity = CountProcessorSolidity(
                cfg.solidity_kind, (int(cfg.abundance_min), amax))
        collect = CountProcessorCollect()
        if cfg.auto_cutoff:
            vector = [CountProcessorChain(hist_proc),
                      CountProcessorChain(solidity, collect)]
        else:
            vector = [CountProcessorChain(hist_proc, solidity, collect)]
        if self.processor is not None:
            vector.append(self.processor)

        with ti.section("4.process", span="count.process"):
            for proc in vector:
                proc.begin(cfg)
                clones = []
                for p, st in parts:
                    proc.begin_pass(p)
                    c = proc.clone()
                    for ci, (uniq_c, counts_c) in enumerate(st.iter()):
                        c.begin_part(p, ci, 0, "superbatch")
                        c.process_table(p, uniq_c, counts_c[:, None],
                                        counts_c)
                        c.end_part(p, ci)
                    clones.append(c)
                    proc.end_pass(p)
                proc.finish_clones(clones)
                proc.end()

        solid_kmers, _, solid_sums = collect.result(w)
        histogram = hist_proc.histogram
        amin = solidity.resolve_cutoff()
        if not cfg.auto_cutoff:
            histogram.cutoff = amin
        return solid_kmers, solid_sums.astype(np.int32), histogram, amin


def _nbytes(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _stage(a: np.ndarray, device) -> torch.Tensor:
    """Host batch array -> tensor on ``device``; uint32 words travel as
    int32 storage with the same bits."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def count_kmers(bank, processor=None, **kwargs) -> CountResult:
    """Convenience API: count kmers of a bank (URI, IBank, or list).

    ``processor``: optional custom CountProcessor joining the run's
    processor vector (see SortingCount)."""
    return SortingCount(CountConfig(**kwargs),
                        processor=processor).run(bank)


# ---------------------------------------------------------------------------
# Multi-bank counting + solidity kinds
# ---------------------------------------------------------------------------


@dataclass
class MultiBankCountResult:
    """Multi-bank counting output (reference _multibank variants,
    PartitionsCommand.cpp:1855-2100).

    kmers: (N, W) sorted distinct kmers across all banks
    counts_per_bank: (N, B) int32 per-bank abundances
    counts_sum: (N,) total abundances
    solid_mask: (N,) solidity by the configured kind
    """

    kmers: np.ndarray
    counts_per_bank: np.ndarray
    counts_sum: np.ndarray
    solid_mask: np.ndarray
    info: dict

    @property
    def solid_kmers(self) -> np.ndarray:
        return self.kmers[self.solid_mask]

    @property
    def solid_counts(self) -> np.ndarray:
        return self.counts_sum[self.solid_mask]


def solidity_check(counts: np.ndarray, kind: str, thresholds,
                   solid_vec=None) -> np.ndarray:
    """Vectorized port of the CountProcessorSolidity checks
    (kmer/impl/CountProcessorSolidity.hpp:177-311).

    counts: (N, B) per-bank abundances; thresholds: list of (min, max)
    per bank (a single pair is broadcast); solid_vec: presence pattern
    for kind='custom'.
    """
    counts = np.asarray(counts)
    n, b = counts.shape
    if isinstance(thresholds, tuple):
        thresholds = [thresholds]
    if len(thresholds) == 1:
        thresholds = thresholds * b
    lo = np.asarray([t[0] for t in thresholds])
    hi = np.asarray([t[1] for t in thresholds])
    in_range = (counts >= lo[None, :]) & (counts <= hi[None, :])
    total = counts.sum(axis=1)
    if kind == "sum":
        return (total >= thresholds[0][0]) & (total <= thresholds[0][1])
    if kind == "max":
        m = counts.max(axis=1)
        return (m >= thresholds[0][0]) & (m <= thresholds[0][1])
    if kind == "min":
        m = counts.min(axis=1)
        return (m >= thresholds[0][0]) & (m <= thresholds[0][1])
    if kind == "all":
        return in_range.all(axis=1)
    if kind == "one":
        return in_range.any(axis=1)
    if kind == "custom":
        if solid_vec is None:
            raise ValueError("custom solidity needs solid_vec")
        sv = np.asarray(solid_vec, bool)
        return (in_range == sv[None, :]).all(axis=1)
    raise ValueError(f"unknown solidity kind {kind!r}")


def _superbatch_count_multibank(codes, valid, lengths, bank_ids, pass_i, *,
                                k: int, m: int, spare: bool, nb_banks: int,
                                cap_out: int | None = None,
                                nb_passes: int = 1):
    """Multibank superbatch: ONE sort over the union of all banks' kmers
    with the bank id riding as the least significant key plane; the reduce
    yields one count column per bank (reference one-pass multibank
    matrices, PartitionsCommand.cpp:1855-2100). codes/valid: (G, B, L)
    bytes/bools; bank_ids: (G, B) per-read bank. nb_passes > 1 applies the
    DSK pass filter (minimizer % nb_passes == pass,
    SortingCountAlgorithm.cpp:806). Returns (planes, counts (nb_banks,
    cap), n, overflow)."""
    planes, keep, _, _, _, bank = _extract_superbatch(
        codes, valid, lengths, pass_i, k=k, m=m, nb_passes=nb_passes,
        packed=False, L=None, bank_ids=bank_ids)
    return count_planes_multibank(planes, keep, bank, nb_banks,
                                  spare_bits=spare, cap_out=cap_out)


def count_kmers_multibank(banks, kmer_size: int = 31,
                          abundance_min=2, abundance_max=MAX_INT32,
                          solidity_kind: str = "sum", solid_vec=None,
                          batch_reads: int = 1024, batch_len: int = 256,
                          superbatch_rows: int = 1 << 22,
                          minimizer_size: int = 10, nb_passes: int = 1,
                          processor=None, device: str = "cuda",
                          **kwargs) -> MultiBankCountResult:
    """One-pass multibank counting: all banks stream through ONE counting
    pipeline with per-bank count columns riding the sort (reference
    _multibank variants, PartitionsCommand.cpp:1855-2100, NOT B
    independent passes). ``abundance_min``/``abundance_max`` may be scalars
    or per-bank lists (reference custom thresholds). ``nb_passes`` bounds
    live device memory exactly like the single-bank DSK pass loop."""
    device = torch.device(device)
    banks = [open_bank(b) for b in banks]
    nb = len(banks)
    k = kmer_size
    w = nb_limbs(kmer_size)
    spare = (2 * k) % 32 != 0
    nb_passes = max(1, int(nb_passes))
    builder = _BatchBuilder(k, batch_reads, batch_len)
    rows_per_batch = batch_reads * (builder.L - k + 1)
    G = max(1, int(superbatch_rows) // rows_per_batch)

    def produce():
        """(batch, bank_id) stream; the builder is flushed at bank
        boundaries so every batch belongs to one bank."""
        for j, bk in enumerate(banks):
            for seq in bk:
                for batch in builder.add(seq.data):
                    yield batch, j
            if builder.row:
                yield builder.flush(), j

    tables: list = []  # (planes, counts (nb, cap), n)
    # adaptive distinct-ratio capacity, learned per superbatch exactly
    # like the single-bank count (overflow flag guards exactness)
    dedup_ratio = {"est": 0.25}

    def flush_group(group, pass_i):
        g = len(group)
        if g < G:
            gp = _next_pow2(g)
            B, L = group[0][0][0].shape
            while len(group) < gp:
                group.append(((np.zeros((B, L), np.uint8),
                               np.zeros((B, L), bool),
                               np.zeros((B,), np.int32), 0), 0))
        codes = _stage(np.stack([b[0][0] for b in group]), device)
        valid = _stage(np.stack([b[0][1] for b in group]), device)
        lengths = _stage(np.stack([b[0][2] for b in group]), device)
        bank_ids = _stage(np.stack(
            [np.full((group[0][0][0].shape[0],), b[1], np.int32)
             for b in group]), device)
        rows = _next_pow2(max(codes.shape[0] * rows_per_batch, 256))
        cap_out = _next_pow2(max(
            256, min(rows, int(rows * dedup_ratio["est"] * 1.5))))

        def count(cap):
            return _superbatch_count_multibank(
                codes, valid, lengths, bank_ids, pass_i, k=k,
                m=minimizer_size, spare=spare, nb_banks=nb, cap_out=cap,
                nb_passes=nb_passes)

        out = count(cap_out)
        if bool(out[3]):
            out = count(None)
        out_p, counts_t, n, _ = out
        n = int(n)
        dedup_ratio["est"] = max(dedup_ratio["est"], n / rows)
        capn = _next_pow2(max(n, 256))
        tables.append((out_p[:, :capn].contiguous(),
                       counts_t[:, :capn].contiguous(), n))

    for pass_i in range(nb_passes):
        group: list = []
        for item in _prefetch(produce(), depth=4):
            group.append(item)
            if len(group) == G:
                flush_group(group, pass_i)
                group = []
        if group:
            flush_group(group, pass_i)

    # pairwise merge (smallest first), count columns riding each merge
    tables = [t for t in tables if t[2] > 0]
    while len(tables) > 1:
        tables.sort(key=lambda t: t[2])
        (pa, ca, na), (pb, cb, nbl) = tables[0], tables[1]
        cap_out = _next_pow2(max(na + nbl, 256))
        planes, counts_t, n, _ = merge_tables_planes_multi(
            pa, ca, na, pb, cb, nbl, cap_out=cap_out)
        tables = tables[2:] + [(planes, counts_t, int(n))]

    uniq = np.zeros((0, w), np.uint32)
    counts = np.zeros((0, nb), np.int32)
    if tables and tables[0][2]:
        planes, counts_t, n = tables[0]
        uniq = kmers_to_numpy(planes[:, :n])
        counts = np.ascontiguousarray(counts_t[:, :n].cpu().numpy().T)

    amin = abundance_min if isinstance(abundance_min, (list, tuple)) \
        else [abundance_min]
    amax = abundance_max if isinstance(abundance_max, (list, tuple)) \
        else [abundance_max]
    if len(amin) == 1:
        amin = amin * nb
    if len(amax) == 1:
        amax = amax * nb
    thresholds = list(zip(amin, amax))
    solid = solidity_check(counts, solidity_kind, thresholds, solid_vec)

    if processor is not None:
        # custom CountProcessor sweep over the kmer-complete matrix
        # (ICountProcessor.hpp:92-200 lifecycle; per-bank counts like the
        # reference _multibank PartitionsCommands feed their processor)
        processor.begin(None)
        processor.begin_pass(0)
        clone = processor.clone()
        clone.begin_part(0, 0, 0, "multibank")
        clone.process_table(0, uniq, counts,
                            counts.sum(axis=1).astype(np.int64))
        clone.end_part(0, 0)
        processor.end_pass(0)
        processor.finish_clones([clone])
        processor.end()

    total = counts.sum(axis=1).astype(np.int64)
    info = {
        "kmers_nb_distinct": int(len(uniq)),
        "kmers_nb_solid": int(solid.sum()),
        "solidity_kind": solidity_kind,
        "nb_banks": nb,
    }
    return MultiBankCountResult(uniq, counts, total, solid, info)


def _rows_searchsorted(table: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Index of each query row in a row-sorted uint32 array (exact match)."""
    def pack(a):
        return np.ascontiguousarray(a).view(
            [("", a.dtype)] * a.shape[1]).ravel()

    t = pack(table)
    q = pack(queries)
    idx = np.searchsorted(t, q)
    return idx

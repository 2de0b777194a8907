"""SortingCount: the DSK-equivalent k-mer counting pipeline on one CUDA device.

Port of gatb_core_tpu/kmer/counting.py: the fold path (the default,
``CountConfig.carry_accumulator=True``), the LSM merge chain
(``carry_accumulator=False``, or a table budget below one read batch), the
multi-pass device bank cache and multibank counting. Reference: gatb-core
SortingCountAlgorithm (kmer/impl/SortingCountAlgorithm.cpp), where reads
are split into superkmers spilled to per-partition files, then each
partition is radix-binned, sorted and 453-way-merged
(PartitionsCommand.cpp). Here:

  host input pipeline:  bank -> packed (B, L) read batches (native C++
                        batcher, or the Python builder)
  device, per superbatch (_FoldDriver, _superbatch_count_fold): canonical
                        multi-limb k-mer extraction (ops/kmer_ops.py), one
                        sort of the raw rows and one merge level against
                        the device-resident accumulator (the CUDA kernels
                        of ops/limb_sort.py), then the distinct reduce
                        (ops/sortops.py)
  device, LSM chain (_LsmDriver, _superbatch_count): extraction, one sort
                        and a distinct reduce per superbatch into its own
                        table; the per-pass tables merge by size class
                        (_merge_smallest_pair), at most _MAX_LIVE_LSM live
  device, pass end:     the default CountProcessor chain (histogram ->
                        solidity -> collect) as one kernel
                        (ops/solid_select.py): the histogram's bins and
                        the solid rows, which alone are copied to the host;
                        with several passes they stay on the device and
                        merge there after the last (_merge_solid_parts)
  host, pass end:       with a caller's processor, custom solidity or an
                        auto cutoff over several passes, the pass's whole
                        table is fetched (_fetch_table), and at the end of
                        the run the numpy chain sweeps every pass's table

Both drivers sit behind one pass loop (SortingCount._execute): the host
stages each superbatch (_stage_superbatch) and hands it to the driver's
``dispatch``; the driver's ``end_pass`` returns the pass's distinct table.

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
    # (_superbatch_count_fold). The LSM chain (one distinct table per
    # superbatch, merged by size class) runs instead when this is False,
    # or when table_budget_bytes is below one read batch, which the fold's
    # accumulator could not hold
    carry_accumulator: bool = True
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
    pass_distinct: the distinct k-mers of each pass's table, in pass order
    (DSK's pass split; empty where the count ran no pass loop)
    """

    solid_kmers: np.ndarray
    solid_counts: np.ndarray
    histogram: Histogram
    info: dict
    config: CountConfig
    pass_distinct: tuple = ()

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


def _host_copies(tensors):
    """Device tensors -> host tensors (pinned, copied asynchronously on
    the current stream) plus the event that marks the copies done; CPU
    tensors come back as they are, with no event."""
    if not tensors[0].is_cuda:
        return list(tensors), None
    out = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                        pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
    ev = torch.cuda.Event()
    ev.record()
    return out, ev


def _scalars_to_host(*scalars):
    """One superbatch's device scalars (0-d or 1-d) gathered into one
    int64 tensor and copied to the host without blocking
    (``_host_copies``), right after its device work is queued: its
    resolve waits on this copy's event alone, not on the work queued
    after it."""
    return _host_copies([torch.cat([s.reshape(-1).to(I64)
                                    for s in scalars])])


def _fetch_table(planes, counts, n: int, w: int):
    """The host fetch of a device distinct table: planes and int32 counts
    copied whole with ``.cpu()`` -> (kmers (n, W) uint32, counts (n,)
    int32)."""
    if n == 0:
        return np.zeros((0, w), np.uint32), np.zeros((0,), np.int32)
    return (kmers_to_numpy(planes[:, :n]),
            counts[:n].cpu().numpy().astype(np.int32))


# the solidity kinds that, on one bank, are each lo <= count <= hi
_DEVICE_KINDS = ("sum", "min", "max", "all", "one")


def _merge_solid_parts(parts: list):
    """The passes' solid rows merged on their device into one sorted
    table. ``parts`` are (rows (n, W) int32, counts (n,) int32), each
    sorted, none empty, and disjoint (a pass keeps the k-mers of its own
    minimizers); the list is emptied as they are laid out. Each part is
    laid out as one run of R = next_pow2(max n) rows of W + 1 planes, its
    counts the last plane (a payload: keys never tie), padded with all-ones
    sentinel rows (no canonical k-mer is all ones), beside all-sentinel
    runs up to a power of two of runs; the runs then double by
    ``merge_sorted_runs`` levels, and the sentinels sort to the tail.
    Returns (rows (N, W) int32, counts (N,) int32)."""
    w = parts[0][0].shape[1]
    run = _next_pow2(max(cnt.numel() for _, cnt in parts))
    size = run * _next_pow2(len(parts))
    x = torch.full((w + 1, size), -1, dtype=I32, device=parts[0][1].device)
    n = 0
    for i in range(len(parts)):
        rows, cnt = parts[i]
        parts[i] = None
        x[:w, i * run:i * run + cnt.numel()] = rows.T
        x[w, i * run:i * run + cnt.numel()] = cnt
        n += cnt.numel()
        del rows, cnt
    parts.clear()
    while run < size:
        x = merge_sorted_runs(x, run)
        run *= 2
    return x[:w, :n].T.contiguous(), x[w, :n]


def _parts_fit(parts: list, more: int) -> bool:
    """Whether the passes' solid rows may stay on their card and merge
    there: the parts so far and ``more`` passes more of the largest one's
    rows, with ``_merge_solid_parts``'s two padded buffers, beside the
    most this process has held on the card, within nine tenths of its
    memory. A table larger than that (a whole genome's) goes to the host
    pass by pass. On a CPU device the parts always stay."""
    rows, cnt = parts[-1]
    if not cnt.is_cuda:
        return True
    big = max(c.numel() for _, c in parts)
    held = sum(c.numel() for _, c in parts) + more * big
    merge = 2 * _next_pow2(big) * _next_pow2(len(parts) + more)
    need = 4 * (rows.shape[1] + 1) * (held + merge)
    total = torch.cuda.get_device_properties(cnt.device).total_memory
    return torch.cuda.max_memory_allocated(cnt.device) + need \
        <= 0.9 * total


def _merge_host_parts(parts: list):
    """The passes' solid rows merged on the host: ``parts`` are host
    (rows (n, W) int32, counts (n,) int32), each sorted and disjoint; the
    list is emptied once they are joined. A stable sort of the rows as
    big-endian byte strings (a timsort, which takes each part as one run:
    a merge of the runs) orders them. Returns (rows (N, W) uint32, counts
    (N,) int32)."""
    rows = np.concatenate([r.numpy().view(np.uint32) for r, _ in parts])
    cnt = np.concatenate([c.numpy() for _, c in parts])
    parts.clear()
    order = np.argsort(rows.astype(">u4").view(f"S{4 * rows.shape[1]}")
                       .ravel(), kind="stable")
    return rows[order], cnt[order]


class _DeviceChain:
    """The default processor vector (histogram -> solidity -> collect) on
    the device, for a kind of ``_DEVICE_KINDS``: at each pass end the
    pass's table adds into the histogram's device bins and its solid rows
    are compacted (``ops.solid_select``). With one pass they are copied to
    pinned host memory without blocking. With several they stay on the
    device while they fit there with their merge (``_parts_fit``), and
    ``result`` merges them there (``_merge_solid_parts``) and copies the
    merged table once; past that they go to pinned host memory, and
    ``result`` merges the copies (``_merge_host_parts``). Either merge is
    the ``count.collect`` span, where more than one pass has solid rows.
    ``result`` waits for the copies and brings the bins over once. An auto
    cutoff (one pass only) is computed from the pass's histogram before
    its select."""

    def __init__(self, cfg: CountConfig, device, nb_passes: int):
        self.cfg = cfg
        self.histogram = Histogram(cfg.histo_max)
        self.bins = torch.zeros((cfg.histo_max + 1,), dtype=I64,
                                device=device)
        self.cutoff = None if cfg.auto_cutoff else int(cfg.abundance_min)
        self.merge = nb_passes > 1
        self.copies: list = []      # ((rows, counts) on the host, event)
        # the passes' (rows, counts) kept on the device for its merge;
        # None once they went to the host
        self.parts: list | None = []

    def _fetch_bins(self) -> None:
        self.histogram.bins = self.bins.cpu().numpy().astype(np.uint64)

    def end_pass(self, planes, counts, n: int, more: int) -> None:
        """The pass's table into the bins and its solid rows kept;
        ``more``: the passes still to come."""
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
        if not self.merge:
            self.copies.append(_host_copies([rows, cnt]))
            return
        if not cnt.numel():
            return
        if self.parts is None:
            held = [(rows, cnt)]
        else:
            self.parts.append((rows, cnt))
            if _parts_fit(self.parts, more):
                return
            held, self.parts = self.parts, None
        for part in held:
            self.copies.append(_host_copies(list(part)))

    def _merge_on_device(self) -> None:
        """The kept parts as one copy, merged on the device where more
        than one pass has any; the span waits for the merged copy."""
        parts, self.parts = self.parts, None
        if len(parts) == 1:
            self.copies.append(_host_copies(list(parts[0])))
            return
        with time_info.span("count.collect"):
            copy, ev = _host_copies(_merge_solid_parts(parts))
            if ev is not None:
                ev.synchronize()
        self.copies.append((copy, None))

    def result(self, w: int):
        """(solid k-mers (N, W) uint32, their counts (N,) int32), sorted
        across the passes; sets the histogram's bins and cutoff."""
        if self.parts:
            self._merge_on_device()
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
        copies, self.copies = self.copies, []
        if not copies:
            return np.zeros((0, w), np.uint32), np.zeros((0,), np.int32)
        if len(copies) == 1:
            (rows, cnt), _ = copies[0]
            return rows.numpy().view(np.uint32), cnt.numpy()
        parts = [part for part, _ in copies]
        del copies
        with time_info.span("count.collect"):
            return _merge_host_parts(parts)


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


_MAX_LIVE_LSM = 10   # hard cap on the LSM chain's live per-pass tables


class _ReadStream:
    """The count's input: the bank as host read batches (parse + 2-bit
    encode [+ pack]) and its BankStats block
    (SortingCountAlgorithm.cpp:735-742), gathered on the first pass."""

    def __init__(self, bank, cfg: CountConfig):
        self.bank = bank
        self.cfg = cfg
        self.builder = _BatchBuilder(cfg.kmer_size, cfg.batch_reads,
                                     cfg.batch_len)
        self.native_paths = _native_fastx_paths(bank)
        self.nb_seq = 0
        self.total_size = 0
        self.min = -1
        self.max = 0
        self.sumsq = 0.0
        self.parse_bytes = 0     # native reader: input bytes read
        self.parse_carried = 0   # native reader: sequences it copied

    def _add(self, n: int, total: int, lo: int, hi: int, sumsq: float):
        self.nb_seq += n
        self.total_size += total
        if n:
            self.min = lo if self.min < 0 else min(self.min, lo)
            self.max = max(self.max, hi)
            self.sumsq += sumsq

    def batches(self, count_stats: bool, group: int):
        """The host batch stream, run on a producer thread (``_prefetch``)
        so parsing overlaps device work; ``count_stats`` adds the
        sequences to the BankStats fields. The native reader fills
        ``group`` batches (a superbatch) a call."""
        cfg = self.cfg
        packed = bool(cfg.packed_transfer)
        if self.native_paths is not None:
            # native C++ parse+encode+batch path (native/fastx.cpp),
            # batch shapes identical to _BatchBuilder; the C call
            # releases the GIL
            from ..native import NativeBatcher

            for path in self.native_paths:
                nat = NativeBatcher(path, cfg.kmer_size, cfg.batch_reads,
                                    self.builder.L)
                yield from nat.batches(packed, group)
                if count_stats:
                    self._add(*nat.stats_full())
                nbytes, carried = nat.parse_counters()
                self.parse_bytes += nbytes
                self.parse_carried += carried
            return
        from ..ops.bitpack import pack_batch_np

        def emit(batch):
            if not packed:
                return batch
            codes, val, lens, row = batch
            words, vmask = pack_batch_np(codes, val)
            return words, vmask, lens, row

        for seq in self.bank:
            if count_stats:
                n = len(seq)
                self._add(1, n, n, n, float(n) * n)
            for batch in self.builder.add(seq.data):
                yield emit(batch)
        if self.builder.row:
            yield emit(self.builder.flush())


def _groups(batches, G: int):
    """The batch stream in superbatch groups of G batches (the last one
    may be shorter)."""
    group: list = []
    for batch in batches:
        group.append(batch)
        if len(group) == G:
            yield group
            group = []
    if group:
        yield group


class _BankCache:
    """The multi-pass device-resident bank cache: every DSK pass streams
    the SAME packed reads (the pass filter is on the device), so pass 0
    keeps its staged device tensors and later passes dispatch off them:
    no re-parse, no re-upload. Budget-gated: the cache is dropped whole
    (``staged`` None) the moment it would exceed its budget."""

    def __init__(self, budget: int, enabled: bool):
        self.budget = budget
        self.bytes = 0
        self.staged: list | None = [] if enabled else None

    def add(self, staged) -> None:
        if self.staged is None:
            return
        nb = sum(_nbytes(t) for t in staged)
        if self.bytes + nb <= self.budget:
            self.staged.append(staged)
            self.bytes += nb
        else:
            self.staged = None


def _stage_superbatch(group, G: int, driver, cache: _BankCache):
    """One superbatch on the driver's device: its read batches stacked, a
    short group padded with empty batches to G or, where the driver asks
    (``driver.pow2_tail``), to the next power of two, uploaded
    (``_stage``: pinned and without blocking on a CUDA device), and kept
    in ``cache`` while the cache takes them. Returns (codes,
    valid, lengths); valid is None where the driver takes dense transfer
    (``driver.dense``) and every validity mask is the all-in-length
    pattern."""
    g = len(group)
    if g < G:
        c0, v0 = group[0][0], group[0][1]
        empty = (np.zeros(c0.shape, c0.dtype), np.zeros(v0.shape, v0.dtype),
                 np.zeros((c0.shape[0],), np.int32), 0)
        to = _next_pow2(g) if driver.pow2_tail else G
        group = group + [empty] * (to - g)
    device = driver.device
    with driver.ti.section("1.stack", span="count.stage"):
        codes = _stage([b[0] for b in group], device)
        if driver.dense and all(_vmask_dense(b[1], b[2]) for b in group):
            valid = None
        else:
            valid = _stage([b[1] for b in group], device)
        lengths = _stage([b[2] for b in group], device)
    staged = (codes, valid, lengths)
    cache.add(staged)
    return staged


class _Driver:
    """What the fold and LSM drivers share: the count's constants, the
    superbatches in flight, the learned distinct ratio and the first
    pass's window counts. A driver takes each staged superbatch in
    ``dispatch(staged, pass_i, first_pass, g)`` (``g`` read batches, the
    progress step) and gives the pass's distinct table, (planes, counts,
    n) on the device or None when no superbatch ran, from ``end_pass()``.
    """

    def __init__(self, cfg: CountConfig, nb_passes: int, L: int,
                 rows_per_batch: int, budget_rows: int, root, ti,
                 progress):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.k = cfg.kmer_size
        self.w = nb_limbs(self.k)
        self.nb_passes = nb_passes
        self.packed = bool(cfg.packed_transfer)
        self.L = L if self.packed else None
        self.rows_per_batch = rows_per_batch
        self.budget_rows = budget_rows
        self.root, self.ti, self.progress = root, ti, progress
        # adaptive distinct-ratio estimate: start from the caller's plan
        # hint, learn from each superbatch's measured n/rows
        self.ratio = float(cfg.distinct_ratio_hint)
        self.pending: list = []   # dispatched superbatches to resolve
        self.n_resolved = 0
        self.windows = 0          # valid k-mer windows (first pass)
        self.inside = 0           # windows inside the reads (first pass)

    def _drain(self) -> None:
        while self.pending:
            self._resolve(self.pending.pop(0))

    def _read(self, readback) -> list:
        """The host values of one superbatch's scalars
        (``_scalars_to_host``): waits on their copy's event alone, and
        counts ``resolve_ready`` where it had completed before the ask
        (always, where there is no event: the values are on the host)."""
        (host,), ev = readback
        if ev is None or ev.query():
            self.root.count(resolve_ready=1)
        else:
            ev.synchronize()
        return host.tolist()

    def _cap_out(self, rows: int) -> int:
        """Distinct-table capacity of one superbatch: coverage makes
        distinct << rows; the ratio is learned from each superbatch's
        measured n/rows (with 1.5x headroom) and the overflow flags
        guard exactness (a re-run or replay at full capacity), the role
        of the plan's distinct-kmer estimate in the reference
        (ConfigurationAlgorithm.cpp:308)."""
        return _next_pow2(max(256, min(rows, int(rows * self.ratio * 1.5))))


class _FoldDriver(_Driver):
    """The fused count+fold accumulator: one device step per superbatch
    (_superbatch_count_fold). The in-flight window stays 2 deep (the
    overflow flags and counts are copied to the host as each fold is
    queued, and its resolve waits on that copy's event alone, so device
    work queues ahead of the host); an overflowed superbatch was NOT
    committed
    (transactional fold), so it is replayed from its staged inputs on a
    doubled accumulator, the pre-growth acc is parked, and parked accs
    fold back in at pass end with one merge each. Every superbatch has
    one shape (a short group is padded to G), and with packed transfer a
    clean bank's all-ones validity masks are not sent (the extraction
    uses the in-length rule)."""

    pow2_tail = False

    def __init__(self, *args):
        super().__init__(*args)
        self.dense = self.packed
        self.cap_budget = max(_next_pow2(self.budget_rows), 1024)
        self.p = self.c = self.n = None     # the accumulator
        self.cap = 0
        self.used = False
        self.n_known = 0
        self.parked: list = []
        self.replay: list = []

    def _arrays(self, cap: int) -> None:
        self.p, self.c, self.n = _empty_table(self.w, cap, self.device)
        self.cap = cap
        self.used = False

    def _park_and_grow(self, newcap: int) -> None:
        """Drain the window, park the committed acc, continue on a fresh
        accumulator of ``newcap`` rows (parked accs fold back in at pass
        end)."""
        if newcap > self.cap_budget:
            raise _RePlan(self.nb_passes)
        self._drain()
        if self.p is not None and self.used:
            self.parked.append((self.p, self.c, self.n))
        self._arrays(newcap)

    def _caps(self, rows: int):
        """(cap_out | None, capR) for a superbatch of ``rows`` raw rows:
        compact-first when the learned distinct ratio says the
        per-superbatch table is far below the raw row count."""
        capR = _next_pow2(max(rows, 256))
        co = self._cap_out(rows)
        return (co if co <= capR // 4 else None), capR

    def dispatch(self, staged, pass_i: int, first_pass: bool, g: int):
        self._dispatch(staged, pass_i, first_pass, g)
        if self.replay:
            self._grow_and_replay()

    def _dispatch(self, staged, pass_i, count_stats, g):
        rows = staged[0].shape[0] * self.rows_per_batch
        cap_out, capR = self._caps(rows)
        if self.p is None:
            # fresh pass: raw mode needs room for the raw rows; compact
            # mode sizes from the distinct estimate with 4x headroom; a
            # previous pass's grown capacity is kept
            init = capR if cap_out is None else \
                min(capR, max(4 * cap_out, 1 << 12))
            self._arrays(max(self.cap, init))
        elif cap_out is None and self.cap < capR:
            # mode flipped to raw mid-run: the acc must hold raw rows
            self._park_and_grow(capR)
        elif cap_out is not None and self.used and self.cap < capR \
                and self.n_known + 3 * cap_out > self.cap:
            # proactive: the (lagged) live count plus the in-flight
            # window could overflow — grow now, without replays
            self._park_and_grow(
                min(capR, max(self.cap * 2,
                              _next_pow2(self.n_known + 4 * cap_out))))
        # reset=False: every accumulator comes fresh from _arrays
        self.root.count(superbatches=1)
        with self.ti.section("2.sort", span="count.dispatch"):
            out = _superbatch_count_fold(
                *staged, pass_i, self.p, self.c, self.n, False, k=self.k,
                m=self.cfg.minimizer_size, nb_passes=self.nb_passes,
                packed=self.packed, L=self.L, cap_acc=self.cap,
                cap_out=cap_out)
        self.p, self.c, self.n, flags, n_loc, nv, ni = out
        self.used = True
        self.pending.append((_scalars_to_host(flags, n_loc, self.n, nv, ni),
                             staged, pass_i, count_stats, g, rows,
                             cap_out is not None))
        # window 2: each in-flight fold keeps its staged inputs alive for
        # a possible replay
        while len(self.pending) > 2:
            self._resolve(self.pending.pop(0))

    def _resolve(self, item) -> None:
        readback, staged, pass_i, count_stats, g, rows, compact = item
        with self.ti.section("2.sort", span="count.resolve"):
            fl0, fl1, nl, kn, nvv, niv = self._read(readback)
        if count_stats:
            self.windows += int(nvv)
            self.inside += int(niv)
        if fl0 or fl1:
            if fl0:   # cap_out too small: raise the ratio estimate
                self.ratio = min(1.0, max(self.ratio * 2, int(nl) / rows))
            self.replay.append((staged, pass_i, bool(fl1)))
        else:
            self.n_known = max(self.n_known, int(kn))
            if compact:
                self.ratio = max(self.ratio, int(nl) / rows)
            elif self.n_resolved == 0:
                # first raw superbatch onto an empty acc: keep_n IS its
                # distinct count — calibrate the ratio
                self.ratio = max(self.ratio, int(kn) / rows)
        self.n_resolved += 1
        self.progress.inc(g)

    def _grow_and_replay(self) -> None:
        """Overflow seen: drain the window (collecting any further
        overflows), park the committed acc and double the accumulator if
        it overflowed, replay the uncommitted superbatches."""
        self._drain()
        while self.replay:
            replays, self.replay = self.replay, []
            if any(acc_ovf for _, _, acc_ovf in replays):
                self._park_and_grow(self.cap * 2)
            self.root.count(replays=len(replays))
            for staged, pass_i, _ in replays:
                self._dispatch(staged, pass_i, False, staged[0].shape[0])
            self._drain()

    def end_pass(self):
        self._grow_and_replay()     # drain, then replay any overflow
        table = None
        with self.ti.section("3.merge", span="count.merge"):
            for pp, pc, pn in self.parked:
                while True:
                    planes_m, counts_m, n_m, ovf_m = merge_tables_planes(
                        pp, pc, pn, self.p, self.c, self.n,
                        cap_out=self.cap)
                    with time_info.span("count.merge_wait"):
                        ovf_m = bool(ovf_m)
                    if not ovf_m:
                        break
                    if self.cap * 2 > self.cap_budget:
                        raise _RePlan(self.nb_passes)
                    self.cap *= 2
                self.p, self.c, self.n = planes_m, counts_m, n_m
            self.parked = []
            if self.p is not None:
                with time_info.span("count.merge_wait"):
                    table = (self.p, self.c, int(self.n))
        # the fold updates its accumulator in place and the table is the
        # pass's result, so the next pass starts from fresh tensors
        self.p = self.c = self.n = None
        self.n_known = 0
        return table


class _LsmDriver(_Driver):
    """The LSM chain: one distinct table per superbatch
    (_superbatch_count), this pass's tables rolling-merged by size class
    so that device memory stays bounded: at most _MAX_LIVE_LSM tables
    during a pass, ONE at its end. A short group is padded to the next
    power of two, which the capacity sizing expects; every validity mask
    is sent."""

    dense = False
    pow2_tail = True

    def __init__(self, *args):
        super().__init__(*args)
        self.spare = (2 * self.k) % 32 != 0
        self.tables: list = []      # (planes, counts, n, ub)

    def _count(self, staged, pass_i, cap_out):
        self.root.count(superbatches=1)
        return _superbatch_count(
            *staged, pass_i, k=self.k, m=self.cfg.minimizer_size,
            nb_passes=self.nb_passes, spare=self.spare, cap_out=cap_out,
            packed=self.packed, L=self.L)

    def dispatch(self, staged, pass_i: int, first_pass: bool, g: int):
        rows = staged[0].shape[0] * self.rows_per_batch
        with self.ti.section("2.sort", span="count.dispatch"):
            out = self._count(staged, pass_i, self._cap_out(rows))
            readback = _scalars_to_host(out[3], out[2], out[4], out[5])
        self.pending.append((out, readback, rows, staged, pass_i,
                             first_pass, g))
        # resolve the FIRST superbatch immediately (learn the distinct
        # ratio before sizing the next); after that keep up to 3 in
        # flight so host parse + transfer overlap device work
        while len(self.pending) > (0 if self.n_resolved == 0 else 3):
            self._resolve(self.pending.pop(0))

    def _resolve(self, item) -> None:
        """Sync point of one superbatch: overflow check (+ exact rerun
        at full capacity when tripped), stats, ratio update, merges."""
        out, readback, rows, staged, pass_i, first_pass, g = item
        with self.ti.section("2.sort", span="count.resolve"):
            # the overflow flag, n and the valid/inside counts
            ov, n, nv, ni = self._read(readback)
            if ov:  # overflow: rerun unbounded (always exact); the
                # table's capacity is then the padded row count, a
                # power of two with a sentinel tail as merges need
                self.root.count(replays=1)
                with time_info.span("count.dispatch"):
                    out = self._count(staged, pass_i, None)
                    readback = _scalars_to_host(out[2], out[4], out[5])
                n, nv, ni = self._read(readback)
            if first_pass:
                self.windows += int(nv)
                self.inside += int(ni)
            n = int(n)
            self.ratio = max(self.ratio, n / rows)
        lst = self.tables
        # no eager trim: rows past n are sentinel, merges mask them; ub = n
        lst.append((out[0], out[1], n, n))
        if sum(t[3] for t in lst) > self.budget_rows:
            # bounds are no-dedup sums; collapse every bound to the exact
            # n before concluding the pass really blew the budget
            # (high-overlap banks would otherwise spuriously cascade
            # re-plans)
            lst[:] = [(p, c, nn, int(nn)) for (p, c, nn, _u) in lst]
            if sum(t[3] for t in lst) > self.budget_rows:
                raise _RePlan(self.nb_passes)
        self.n_resolved += 1
        with self.ti.section("3.merge", span="count.merge"):
            # LSM-style size-classed merging: only merge the two smallest
            # tables while they are in the same size class. An
            # accumulate-into-one policy re-sorts the big table once per
            # superbatch, O(N*P) rows; the binary-counter tree is
            # O(N*log P) with <= ~log2(P)+2 live tables
            while len(lst) >= 2:
                lst.sort(key=lambda t: t[3])
                if len(lst) <= _MAX_LIVE_LSM and lst[1][3] > 2 * lst[0][3]:
                    break
                _merge_smallest_pair(lst)
        self.progress.inc(g)

    def end_pass(self):
        """Pass boundary: drain and merge this pass down to ONE table:
        device memory holds at most the active pass's tables, so the
        _RePlan budget bounds it."""
        self._drain()
        table = None
        with self.ti.section("3.merge", span="count.merge"):
            lst = self.tables
            while len(lst) > 1:
                _merge_smallest_pair(lst)
            if lst:
                planes, counts, n, _ = lst.pop()
                with time_info.span("count.merge_wait"):
                    table = (planes, counts, int(n))
        return table


class SortingCount(Algorithm):
    """Driver for the counting pipeline (SortingCountAlgorithm equivalent),
    on the Algorithm execute()/run()/get_info() contract
    (Algorithm.hpp:8-120).

    ``processor`` plugs a custom CountProcessor (kmer/count_processor.py,
    the ICountProcessor.hpp:92-200 extension point) into the run: it
    joins the processor vector as its own sweep, receiving every pass's
    kmer-complete table with full lifecycle calls. ``run()`` records the
    ``count`` span, with the superbatches dispatched, the ``replays``
    among them (dispatched again after an overflow) and the
    ``resolve_ready`` ones whose scalars were on the host when their
    resolve asked (no wait for the card), the row width in
    ``limbs``, the k-mer ``windows`` counted and the ``distinct`` rows
    after the reduce as its counts; and the ``passes`` run, the later
    passes' superbatches ``cached`` (dispatched from the bank cache) and
    ``reparsed`` (staged again from a fresh parse), and the
    ``cache_bytes`` the cache held when pass 0 ended (0 where it was
    dropped or there was one pass)."""

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
        stream = _ReadStream(open_bank(bank), cfg)
        k = cfg.kmer_size
        w = nb_limbs(k)
        L = stream.builder.L
        t0 = time.time()
        root = time_info.current()      # ``count``, where it is recorded
        # soft budget: STORED bytes per live table row (limb planes +
        # counts); sort transients are bounded separately by
        # cfg.superbatch_rows and do not persist across superbatches
        row_bytes = 4 * w + 4
        budget_rows = max(cfg.table_budget_bytes // row_bytes, 1024)
        rows_per_batch = cfg.batch_reads * (L - k + 1)
        G = max(1, int(cfg.superbatch_rows) // rows_per_batch)

        # the default processor vector runs on the device unless the
        # caller plugs a processor, the solidity kind is custom, or an
        # auto cutoff needs every pass's histogram before any select
        chain = None
        if self.processor is None and cfg.solidity_kind in _DEVICE_KINDS \
                and not (cfg.auto_cutoff and nb_passes > 1):
            chain = _DeviceChain(cfg, device, nb_passes)
        ti = time_info.TimeInfo()
        try:
            est_n, est_total, _ = stream.bank.estimate()
            est_batches = max(1, est_total // max(
                cfg.batch_reads * L, 1) + 1)
        except Exception:
            est_batches = 1
        progress = time_info.Progress(est_batches * nb_passes,
                                      "DSK: counting kmers",
                                      verbose=cfg.verbose > 0)

        # the fold's accumulator must hold one superbatch's raw rows
        # within the budget: G halves until it does
        use_fold = bool(cfg.carry_accumulator)
        cap0 = _next_pow2(max(G * rows_per_batch, 256))
        if use_fold:
            while G > 1 and cap0 > budget_rows:
                G //= 2
                cap0 = _next_pow2(max(G * rows_per_batch, 256))
            if cap0 > budget_rows:
                use_fold = False  # tiny budget: LSM compacts per batch
        driver = (_FoldDriver if use_fold else _LsmDriver)(
            cfg, nb_passes, L, rows_per_batch, budget_rows, root, ti,
            progress)
        cache = _BankCache(cfg.bank_cache_bytes, nb_passes > 1)
        host_tables: dict = {}  # pass -> its fetched (kmers, counts)
        nb_distinct = 0
        pass_distinct: list = []
        # later passes' superbatches dispatched from the cache, or staged
        # again from a fresh parse; the cache's bytes after pass 0
        cached = reparsed = cache_bytes = 0

        # DSK pass loop (SortingCountAlgorithm.cpp:678): pass p keeps kmers
        # with minimizer % nb_passes == p; each pass streams the whole bank
        for pass_i in range(nb_passes):
            first_pass = pass_i == 0
            if not first_pass and cache.staged is not None:
                cached += len(cache.staged)
                for staged in cache.staged:     # device-resident reuse
                    driver.dispatch(staged, pass_i, False,
                                    staged[0].shape[0])
            else:
                # a queue of two superbatches' batches: the parse runs
                # a whole superbatch ahead of the staging
                batches = _prefetch(stream.batches(first_pass, G),
                                    depth=max(4, 2 * G))
                for group in _groups(batches, G):
                    reparsed += not first_pass
                    driver.dispatch(_stage_superbatch(group, G, driver,
                                                      cache),
                                    pass_i, first_pass, len(group))
                if first_pass and cache.staged is not None:
                    cache_bytes = cache.bytes
            # each pass yields ONE kmer-complete table (passes partition
            # kmers by minimizer, so a pass table is the reference's
            # notion of a completed partition)
            table = driver.end_pass()
            n_pass = 0 if table is None else table[2]
            nb_distinct += n_pass
            pass_distinct.append(int(n_pass))
            if chain is not None:
                root.count(solid_select=1)
                if n_pass:
                    with ti.section("4.process", span="count.process"):
                        chain.end_pass(*table, nb_passes - 1 - pass_i)
            elif n_pass:
                with ti.section("4.process", span="count.process"), \
                        time_info.span("count.fetch_wait"):
                    host_tables[pass_i] = _fetch_table(*table, w)

        t_fill = time.time() - t0
        progress.finish()

        t1 = time.time()
        kmers_nb_valid = driver.windows
        kmers_nb_invalid = driver.inside - kmers_nb_valid
        t_merge = time.time() - t1

        if chain is None:
            solid_kmers, solid_counts, histogram, amin = self._host_chain(
                ti, host_tables, nb_passes, w)
        else:
            with ti.section("4.process", span="count.process"):
                solid_kmers, solid_counts = chain.result(w)
            histogram, amin = chain.histogram, chain.cutoff
        histogram.nb_solids_after_cutoff = len(solid_counts)
        root.count(limbs=w, windows=kmers_nb_valid, distinct=nb_distinct,
                   solid=len(solid_counts), passes=nb_passes, cached=cached,
                   reparsed=reparsed, cache_bytes=cache_bytes)
        if stream.native_paths is not None:
            root.count(parse_bytes=stream.parse_bytes,
                       parse_carried=stream.parse_carried)

        nb_seq = stream.nb_seq
        total_size = stream.total_size
        info = {
            "kmers_nb_distinct": nb_distinct,
            "kmers_nb_solid": int(len(solid_counts)),
            "kmers_nb_weak": int(nb_distinct - len(solid_counts)),
            "kmers_nb_valid": int(kmers_nb_valid),
            "kmers_nb_invalid": int(kmers_nb_invalid),
            "sequences_number": int(nb_seq),
            "sequences_size": int(total_size),
            # seq_size_* (BankStats, SortingCountAlgorithm.cpp:735-742)
            "seq_size_min": int(max(stream.min, 0)),
            "seq_size_max": int(stream.max),
            "seq_size_mean": round(total_size / nb_seq, 1)
            if nb_seq else 0.0,
            "seq_size_deviation": round(
                max(stream.sumsq / nb_seq
                    - (total_size / nb_seq) ** 2, 0.0) ** 0.5, 1)
            if nb_seq else 0.0,
            "kmer_size": k,
            "abundance_min": amin,
            "abundance_max": cfg.abundance_max,
            "time_fill": t_fill,
            "time_merge": t_merge,
            # passes actually RUN (>= cfg.nb_passes after optimistic
            # re-planning, counting._RePlan)
            "nb_passes_effective": int(nb_passes),
            "parser": "python" if stream.native_paths is None
            else "native",
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
                           cfg, tuple(pass_distinct))

    def _host_chain(self, ti, tables: dict, nb_passes: int, w: int):
        """The processor vector on the host, for what the device chain
        does not take (a caller's processor, custom solidity, an auto
        cutoff over several passes): each pass's fetched table
        (``tables``: pass -> (kmers, counts), none for a pass with no
        k-mer) swept as one part by the numpy chain and then by the
        caller's processor. Returns (solid k-mers, solid counts,
        histogram, abundance min)."""
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
        collect = CountProcessorCollect()
        if cfg.auto_cutoff:
            solidity = CountProcessorSolidity(
                cfg.solidity_kind, (0, amax), auto_histogram=hist_proc)
            vector = [CountProcessorChain(hist_proc),
                      CountProcessorChain(solidity, collect)]
        else:
            solidity = CountProcessorSolidity(
                cfg.solidity_kind, (int(cfg.abundance_min), amax))
            vector = [CountProcessorChain(hist_proc, solidity, collect)]
        if self.processor is not None:
            vector.append(self.processor)

        with ti.section("4.process", span="count.process"):
            for proc in vector:
                proc.begin(cfg)
                clones = []
                for p in range(nb_passes):
                    proc.begin_pass(p)
                    c = proc.clone()
                    if p in tables:
                        kmers, counts = tables[p]
                        c.begin_part(p, 0, 0, "superbatch")
                        c.process_table(p, kmers, counts[:, None], counts)
                        c.end_part(p, 0)
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


def _stage(a, device) -> torch.Tensor:
    """Host batch array, or a list of equal-shape ones stacked, -> tensor
    on ``device``; uint32 words travel as int32 storage with the same
    bits. On a CUDA device the rows are written straight into pinned host
    memory and uploaded without blocking the host (torch's caching host
    allocator keeps the buffer until its copy has completed)."""
    stack = isinstance(a, list)
    first = a[0] if stack else a
    store = np.int32 if first.dtype == np.uint32 else first.dtype
    if torch.device(device).type != "cuda":
        host = np.stack(a) if stack else np.ascontiguousarray(a)
        return torch.from_numpy(host.view(store)).to(device)
    host = torch.empty(((len(a),) if stack else ()) + first.shape,
                       dtype=torch.from_numpy(np.empty(0, store)).dtype,
                       pin_memory=True)
    out = host.numpy().view(first.dtype)
    if stack:
        np.stack(a, out=out)
    else:
        out[...] = a
    return host.to(device, non_blocking=True)


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
        codes = _stage([b[0][0] for b in group], device)
        valid = _stage([b[0][1] for b in group], device)
        lengths = _stage([b[0][2] for b in group], device)
        bank_ids = _stage(
            [np.full((group[0][0][0].shape[0],), b[1], np.int32)
             for b in group], device)
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

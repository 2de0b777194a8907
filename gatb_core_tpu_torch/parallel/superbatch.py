"""Multi-rank counting, production shape: the superbatch exchange driver.

Port of gatb_core_tpu/parallel/superbatch.py (the reference's streaming
partition exchange, SortingCountAlgorithm::fillPartitions +
PartitionsCommand, kmer/impl/SortingCountAlgorithm.cpp:1211-1600). One
step per superbatch on every rank:

  extraction (packed 2-bit words) -> DSK pass filter -> local sort +
  distinct reduce -> k-mer RANGE split (contiguous slices of the sorted
  table) -> all-to-all -> merge into the rank's resident accumulator.

- **Range partitioning.** Rank d owns the k-mers in [bounds[d-1],
  bounds[d]); the bounds are quantiles of a sampled census of canonical
  k-mers (``sample_range_bounds``, the same sample and so the same bounds
  as the JAX package). Each send window is a contiguous slice of the local
  sorted table, and the global table is the concatenation of the ranks'
  tables.
- **The accumulator stays on the rank's device.** The received segments
  (each a sorted slice) and the accumulator (sorted) are merged by the
  limb-sort kernels' merge levels with the counts as the least significant
  key, then reduced; the table leaves the device once per pass. The JAX
  package sorts the concatenation whole; any correct sort or merge gives
  the same reduced table.
- **Overflow is transactional.** The local table, the send window and the
  accumulator have fixed capacities, chosen as in the JAX package. Their
  three overflow flags are summed over every rank (one all-reduce, with the
  valid and inside-read window counts); if any is set, every rank keeps its
  accumulator and the host grows the capacity that overflowed and replays
  the superbatch, at the points where JAX retries (the local flag includes
  the JAX blocked compaction's block-skew flag, ``_blocked_overflow``).

On a 2-D (host, chip) mesh the exchange rides the chip axis and the hosts
merge at the end of a pass by an all-gather over the host axis
(``make_host_merge``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kmer_ops import nb_limbs
from ..ops.limb_sort import merge_sorted_runs
from ..ops.sortops import (SENTINEL, _next_pow2, count_planes,
                           count_sorted_planes)
from .mesh import CHIP_AXIS, DATA_AXIS, HOST_AXIS

I32 = torch.int32
I64 = torch.int64
_BIAS = -(1 << 31)     # x ^ _BIAS orders int32 storage as uint32
# superbatches replayed after an overflow (the transactional retry)
retries = {"superbatch": 0}
# the rows of the last count's local table, send window and accumulator
capacities: dict = {}


def _ge_bound(planes: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Columns of (W, N) limb planes >= bound (W,), big-endian unsigned
    lexicographic (rows: pass ``rows.T``)."""
    ge = torch.zeros(planes.shape[1], dtype=torch.bool, device=planes.device)
    eq = torch.ones_like(ge)
    for j in range(planes.shape[0]):
        p, b = planes[j] ^ _BIAS, bound[j] ^ _BIAS
        ge = ge | (eq & (p > b))
        eq = eq & (p == b)
    return ge | eq


def sample_range_bounds(bank, k: int, ndev: int, sample_reads: int = 4096,
                        batch_len: int = 256, device="cuda") -> np.ndarray:
    """Range census: canonical-k-mer quantiles of a bank sample.

    Returns (ndev - 1, W) uint32 split keys; rank d owns [bounds[d-1],
    bounds[d]). Canonical k-mers distribute like min(U, U'), so the
    quantiles are measured, not assumed uniform (the RepartitorAlgorithm's
    sampling role, kmer/impl/RepartitorAlgorithm.cpp). The first batch of
    ``sample_reads`` reads is extracted on ``device``."""
    from ..kmer.counting import _BatchBuilder
    from ..ops.kmer_ops import extract_kmers

    w = nb_limbs(k)
    if ndev <= 1:
        return np.zeros((0, w), np.uint32)
    builder = _BatchBuilder(k, sample_reads, batch_len)
    got = None
    for seq in bank:
        for b in builder.add(seq.data):
            got = b
            break
        if got is not None:
            break
    if got is None and builder.row:
        got = builder.flush()
    uniform = np.zeros((ndev - 1, w), np.uint32)
    uniform[:, 0] = ((np.arange(1, ndev, dtype=np.uint64) << 32)
                     // ndev).astype(np.uint32)
    if got is None:
        return uniform
    codes, valid, lengths, _rows = got
    kb = extract_kmers(torch.from_numpy(codes).to(device),
                       torch.from_numpy(valid).to(device),
                       torch.from_numpy(lengths).to(device), k,
                       with_minimizers=False)
    km = kb.kmers.reshape(-1, w).cpu().numpy().astype(np.uint32)
    km = km[kb.valid.reshape(-1).cpu().numpy()]
    if len(km) < 4 * ndev:
        return uniform
    order = np.lexsort(tuple(km[:, j] for j in reversed(range(w))))
    km = km[order]
    idx = (np.arange(1, ndev, dtype=np.int64) * len(km)) // ndev
    return km[idx].astype(np.uint32)


def _blocked_overflow(counts: torch.Tensor, n, n_rows: int, cap_out: int,
                      block: int = 4096, margin: int = 3) -> torch.Tensor:
    """The block-skew flag of the JAX package's blocked compaction
    (sortops._compact_ends_blocked): its n_rows sorted rows in blocks of
    ``block``, more run ends in one block than its slice of ``e_cols``.
    With unit weights the end of run r sits at cumsum(counts)[r] - 1; past
    cap_out runs the overflow flag is set anyway."""
    nb = n_rows // block
    if nb * block != n_rows or nb < 2:
        return torch.zeros((), dtype=torch.bool, device=counts.device)
    e_cols = max(128, margin * block * cap_out // n_rows)
    e_cols = min(-(-e_cols // 128) * 128, block)
    live = torch.arange(counts.shape[0], device=counts.device) < n
    blk = (torch.cumsum(counts.to(I64), 0) - 1) // block
    per = torch.zeros(nb + 1, dtype=I64, device=counts.device)
    per.index_add_(0, torch.where(live, blk, nb), live.to(I64))
    return (per[:nb] > e_cols).any()


def _merge_segments(segs: torch.Tensor) -> torch.Tensor:
    """(P, S, n) sorted segments (n a power of two) -> (P, S2 * n) one
    sorted run, S2 = next_pow2(S): sentinel segments pad S, then the
    merge levels of the limb-sort kernels."""
    p, s, n = segs.shape
    s2 = _next_pow2(s)
    flat = torch.full((p, s2 * n), SENTINEL, dtype=I32, device=segs.device)
    flat[-1] = 0
    flat[:, :s * n] = segs.reshape(p, s * n)
    run = n
    while run < s2 * n:
        flat = merge_sorted_runs(flat, run)
        run *= 2
    return flat


def _reduce_run(run: torch.Tensor, n_live, cap_out: int):
    """Reduce one sorted (W + 1, len) run, counts in the last plane and
    all-ones keys past the live rows, to a distinct table of ``cap_out``
    rows. Returns (planes, counts, n, overflow)."""
    inv = torch.arange(run.shape[1], device=run.device) >= n_live
    return count_sorted_planes(run[:-1], inv, weights=run[-1],
                               cap_out=cap_out)


def make_superbatch_step(mesh, *, k: int, m: int, nb_passes: int, L: int,
                         cap_local: int, cap_send: int, cap_acc: int,
                         packed: bool, exchange_axis: str = DATA_AXIS,
                         shard_axes: tuple = None):
    """The one-step-per-superbatch exchange over ``mesh``.

    Returns fn(words, vmask, lengths, pass_i, bounds, acc_planes,
    acc_counts, acc_n) -> (planes (W, cap_acc), counts (cap_acc,), n,
    stats (5,) int64), run by every rank on its local shard: (G, b, ...)
    packed words and validity bitmasks (or codes and validity with
    packed=False), (G, b) lengths, the (ndev - 1, W) int32 bounds and the
    rank's accumulator. ``stats`` is summed over ``shard_axes`` (every
    rank): the local, send and accumulator overflow counts, then the valid
    and inside-read windows. Where an overflow count is set, the returned
    table is not a valid accumulator and the caller keeps the old one.

    On a 2-D (host, chip) mesh the all-to-all rides ``exchange_axis`` (the
    chip axis): each host range-partitions its reads' k-mers among its
    chips."""
    from ..kmer.counting import _extract_superbatch

    shard_axes = shard_axes or (exchange_axis,)
    ndev = mesh.shape[exchange_axis]
    w = nb_limbs(k)

    def step(words, vmask, lengths, pass_i, bounds, acc_planes,
             acc_counts, acc_n):
        dev = lengths.device
        g, b = lengths.shape
        planes, keep, _, n_valid, n_inside, _ = _extract_superbatch(
            words, vmask, lengths, pass_i, k=k, m=m, nb_passes=nb_passes,
            packed=packed, L=L)
        # ---- local sort + distinct reduce ---------------------------
        loc_p, loc_c, n_loc, ovf_loc = count_planes(
            planes, keep, spare_bits=True, cap_out=cap_local)
        ovf_loc = ovf_loc | _blocked_overflow(
            loc_c, n_loc, g * b * (L - k + 1), cap_local)
        # ---- k-mer range split: owner of each live row ----------------
        live = torch.arange(cap_local, device=dev) < n_loc
        owner = torch.zeros(cap_local, dtype=I64, device=dev)
        for j in range(ndev - 1):
            owner += _ge_bound(loc_p, bounds[j])
        cnt = torch.zeros(ndev, dtype=I64, device=dev).index_add_(
            0, owner, live.to(I64))
        starts = torch.cumsum(cnt, 0) - cnt
        send_counts = torch.clamp(cnt, max=cap_send)
        n_over = (cnt - send_counts).sum()
        # (ndev, cap_send, W + 1) windows over the sorted table, with a
        # sentinel tail so no window runs past its end
        padded = torch.full((w + 1, cap_local + cap_send), SENTINEL,
                            dtype=I32, device=dev)
        padded[:w, :cap_local] = loc_p
        padded[w] = 0
        padded[w, :cap_local] = loc_c
        win = starts[:, None] + torch.arange(cap_send, device=dev)
        send = padded[:, win].permute(1, 2, 0)
        # ---- all-to-all over the exchange axis ------------------------
        recv = mesh.all_to_all(send, exchange_axis).permute(2, 0, 1)
        recv_counts = mesh.all_to_all(send_counts.reshape(ndev, 1),
                                      exchange_axis).reshape(ndev)
        # slots past a window's count hold the sender's next segment
        rvalid = torch.arange(cap_send, device=dev)[None, :] \
            < recv_counts[:, None]
        recv = torch.cat([torch.where(rvalid, recv[:w], SENTINEL),
                          (recv[w] * rvalid)[None]])
        # ---- merge received + accumulator: two sorted runs, one merge
        # level, then the reduce ----------------------------------------
        got = _merge_segments(recv)
        run = max(cap_acc, got.shape[1])
        cat = torch.full((w + 1, 2 * run), SENTINEL, dtype=I32, device=dev)
        cat[w] = 0
        cat[:w, :cap_acc] = acc_planes
        cat[w, :cap_acc] = acc_counts
        cat[:, run:run + got.shape[1]] = got
        new_p, new_c, n_acc2, ovf_acc = _reduce_run(
            merge_sorted_runs(cat, run), acc_n + recv_counts.sum(), cap_acc)
        stats = mesh.psum(torch.stack([
            ovf_loc.to(I64), (n_over > 0).to(I64), ovf_acc.to(I64),
            n_valid.to(I64), n_inside.to(I64)]), shard_axes)
        return new_p, new_c, n_acc2, stats

    return step


def make_host_merge(mesh, *, w: int, cap_acc: int, cap_out: int):
    """Pass-end cross-host reduce: every rank all-gathers the per-host
    tables of its chip's key range over the host axis and reduces them to
    one sorted distinct table of ``cap_out`` rows (the merge the reference
    does by concatenating per-thread partition files). ``cap_out`` >=
    nb_hosts * cap_acc, so it never overflows. Returns fn(acc_planes,
    acc_counts, acc_n) -> (planes, counts, n)."""

    def step(acc_planes, acc_counts, acc_n):
        acc = torch.cat([acc_planes, acc_counts[None, :]])
        segs = mesh.all_gather(acc, HOST_AXIS).permute(1, 0, 2)
        n_all = mesh.all_gather(acc_n.reshape(1), HOST_AXIS).sum()
        out_p, out_c, n2, _ = _reduce_run(_merge_segments(segs), n_all,
                                          cap_out)
        return out_p, out_c, n2

    return step


def count_kmers_distributed_superbatch(
        bank, mesh, kmer_size: int = 31, minimizer_size: int = 10,
        abundance_min=2, abundance_max: int = 2**31 - 1,
        nb_passes: int = 1, batch_reads_per_device: int = 256,
        batch_len: int = 256, capacity_factor: float = 2.0,
        superbatch_rows: int = 1 << 22, repartitor="auto",
        histo_max: int = 10000, distinct_ratio_hint: float = 0.3,
        packed: bool = True):
    """End-to-end multi-rank SortingCount over a mesh, called by every
    rank with the same arguments; every rank returns the same CountResult,
    equal to the single-device count for any mesh size, with the JAX
    package's ``info``. ``repartitor`` is accepted for API compatibility
    and unused: the driver partitions by k-mer range. ``capacity_factor``
    scales the send window (small values force the overflow retry; each
    replayed superbatch is counted in ``retries``).

    Every rank reads the whole bank as global batches of
    ``batch_reads_per_device`` reads per rank (by the native batcher for
    one FASTA/FASTQ file, else by the Python batch builder: the same
    batches) and stages its slice of each batch to its device; the JAX
    package's single controller reads it once."""
    from ..bank.fasta import open_bank
    from ..kmer.counting import (_BatchBuilder, _global_merge,
                                 _native_fastx_paths, _prefetch)
    from ..ops.bitpack import pack_batch_np
    from .exchange import _count_result

    bank = open_bank(bank)
    k = kmer_size
    w = nb_limbs(k)
    dev = mesh.device
    if HOST_AXIS in mesh.axis_names:
        # (host, chip): the exchange rides the chip axis; hosts merge at
        # pass end over the host axis (make_host_merge)
        shard_axes = (HOST_AXIS, CHIP_AXIS)
        exchange_axis = CHIP_AXIS
        ndev = mesh.shape[CHIP_AXIS]              # exchange group size
        nb_hosts = mesh.shape[HOST_AXIS]
    else:
        shard_axes = (DATA_AXIS,)
        exchange_axis = DATA_AXIS
        ndev = mesh.shape[DATA_AXIS]
        nb_hosts = 1
    ndev_total = nb_hosts * ndev
    nb_passes = max(1, int(nb_passes))

    bounds = torch.from_numpy(sample_range_bounds(
        bank, k, ndev, device=dev).view(np.int32)).to(dev)

    Bg = batch_reads_per_device * ndev_total
    builder = _BatchBuilder(k, Bg, batch_len)
    L = builder.L
    rows_per_batch = Bg * (L - k + 1)
    G = max(1, int(superbatch_rows) // rows_per_batch)
    rows_sb = G * rows_per_batch
    mine = slice(mesh.rank * batch_reads_per_device,
                 (mesh.rank + 1) * batch_reads_per_device)

    # distinct estimate sizing the accumulator (the reference sizes its
    # partitions from the plan's estimate, ConfigurationAlgorithm.cpp:
    # 308-319); the overflow retry guards exactness
    try:
        _, est_total, _ = bank.estimate()
        est_kmers = max(est_total, rows_sb)
    except (AttributeError, OSError, ValueError):
        est_kmers = rows_sb * nb_passes
    est_distinct = int(est_kmers * distinct_ratio_hint) + 1024
    caps = {
        "local": _next_pow2(max(256, min(
            rows_sb // ndev_total,
            int(rows_sb / ndev_total * distinct_ratio_hint * 2)))),
        "acc": _next_pow2(max(256, int(
            est_distinct / max(1, nb_passes) / ndev_total * 1.5))),
    }
    caps["send"] = _next_pow2(max(
        64, int(caps["local"] / ndev * capacity_factor)))
    capacities.clear()
    capacities.update(caps)

    def get_step():
        return make_superbatch_step(
            mesh, k=k, m=minimizer_size, nb_passes=nb_passes, L=L,
            cap_local=caps["local"], cap_send=caps["send"],
            cap_acc=caps["acc"], packed=packed,
            exchange_axis=exchange_axis, shard_axes=shard_axes)

    def fresh_carry():
        return (torch.full((w, caps["acc"]), SENTINEL, dtype=I32,
                           device=dev),
                torch.zeros(caps["acc"], dtype=I32, device=dev),
                torch.zeros((), dtype=I64, device=dev))

    def grow_carry(carry):
        """Double cap_acc, the live carry padded into the new capacity."""
        caps["acc"] *= 2
        planes, counts, n = fresh_carry()
        planes[:, :carry[0].shape[1]] = carry[0]
        counts[:carry[1].shape[0]] = carry[1]
        return planes, counts, carry[2]

    native = _native_fastx_paths(bank)
    native = native if native is not None and len(native) == 1 else None
    stats = [0, 0]      # sequences, bases (first pass)

    def produce(count_stats: bool):
        if native is not None:
            from ..native import NativeBatcher

            nat = NativeBatcher(native[0], k, Bg, L)
            yield from nat.batches(packed, G)
            if count_stats:
                s_n, s_t = nat.stats_full()[:2]
                stats[0] += s_n
                stats[1] += s_t
            return
        for seq in bank:
            if count_stats:
                stats[0] += 1
                stats[1] += len(seq)
            for codes, valid, lengths, rows in builder.add(seq.data):
                yield (*pack_batch_np(codes, valid), lengths, rows) \
                    if packed else (codes, valid, lengths, rows)
        if builder.row:
            codes, valid, lengths, rows = builder.flush()
            yield (*pack_batch_np(codes, valid), lengths, rows) \
                if packed else (codes, valid, lengths, rows)

    def stage(group):
        """This rank's slice of G stacked batches on its device; a short
        tail superbatch is padded with empty batches."""
        while len(group) < G:
            group.append((np.zeros_like(group[0][0]),
                          np.zeros_like(group[0][1]),
                          np.zeros((Bg,), np.int32), 0))

        def local(j):
            x = np.stack([b[j][mine] for b in group])
            if x.dtype == np.uint32:
                x = x.view(np.int32)
            return torch.from_numpy(x).to(dev)

        return local(0), local(1), local(2)

    pass_tables: list = []   # (kmers (N, W) uint32, counts (N,) int32)
    totals = [0, 0]          # valid windows, windows inside the reads

    for pass_i in range(nb_passes):
        first_pass = pass_i == 0
        carry = fresh_carry()
        group: list = []

        def dispatch(group):
            nonlocal carry
            words, vmask, lengths = stage(group)
            while True:
                *new_carry, st = get_step()(words, vmask, lengths, pass_i,
                                            bounds, *carry)
                st = st.tolist()
                if not any(st[:3]):
                    if first_pass:
                        totals[0] += st[3]
                        totals[1] += st[4]
                    carry = tuple(new_carry)
                    return
                # transactional abort: the carry is unchanged; grow the
                # capacity that overflowed and replay the superbatch
                retries["superbatch"] += 1
                if st[0]:
                    caps["local"] = min(caps["local"] * 2,
                                        _next_pow2(max(rows_sb, 256)))
                if st[1]:
                    caps["send"] = min(caps["send"] * 2, caps["local"])
                if st[2]:
                    carry = grow_carry(carry)

        for batch in _prefetch(produce(first_pass), depth=4):
            group.append(batch)
            if len(group) == G:
                dispatch(group)
                group = []
        if group:
            dispatch(group)
        capacities.update(caps)

        # ---- pass end: cross-host merge (2-D), then the range tables of
        # every chip, gathered in range order -----------------------------
        planes, counts, n = carry
        if nb_hosts > 1:
            cap_out = _next_pow2(nb_hosts * caps["acc"])
            planes, counts, n = make_host_merge(
                mesh, w=w, cap_acc=caps["acc"], cap_out=cap_out)(
                    planes, counts, n)
        all_p = mesh.all_gather(planes, exchange_axis)
        all_c = mesh.all_gather(counts, exchange_axis)
        all_n = mesh.all_gather(n.reshape(1), exchange_axis).reshape(-1)
        segs_k, segs_c = [], []
        for d, n_d in enumerate(all_n.tolist()):
            segs_k.append(all_p[d, :, :n_d].T.cpu().numpy().view(np.uint32))
            segs_c.append(all_c[d, :n_d].cpu().numpy())
        pass_tables.append((np.concatenate(segs_k, axis=0),
                            np.concatenate(segs_c, axis=0)))

    # ---- cross-pass merge (passes partition k-mers; ranges interleave) --
    if nb_passes == 1:
        uniq, counts = pass_tables[0]
    else:
        uniq, counts = _global_merge(
            np.concatenate([t[0] for t in pass_tables]),
            np.concatenate([t[1] for t in pass_tables]), w, dev)
    return _count_result(
        np.ascontiguousarray(uniq), counts,
        {"kmers_nb_valid": int(totals[0]),
         "kmers_nb_invalid": int(totals[1] - totals[0])},
        stats[0], stats[1], k=k, minimizer_size=minimizer_size,
        abundance_min=abundance_min, abundance_max=abundance_max,
        nb_passes=nb_passes, histo_max=histo_max, ndev=ndev, dev=dev)

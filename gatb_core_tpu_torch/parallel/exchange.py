"""Multi-rank counting step: minimizer-partition all-to-all over the mesh.

Port of gatb_core_tpu/parallel/exchange.py, the equivalent of DSK's
minimizer -> partition spill (SortingCountAlgorithm::fillPartitions,
kmer/impl/SortingCountAlgorithm.cpp:1211-1345): each rank extracts the
k-mers of its read shard, assigns each a partition from its minimizer, and
the partitions are exchanged so that rank p receives every k-mer whose
partition is p. Each rank then sorts and reduces what it received (the
port's ``sort_by_kmer`` / ``count_sorted``, the limb-sort kernels).

The send windows are fixed, (ndev, cap) rows per rank as in the JAX
package: a k-mer past its window is not dropped but counted where it is,
in an overflow table merged on the host, so the result is exact and the
overflow decisions are JAX's. Every rank calls the step with the global
batch and keeps its own rows (``mesh.data_sharding``); the step returns
the global stacked tables (all-gathered), the same on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.sortops import CountTable, SENTINEL, count_sorted, sort_by_kmer
from .mesh import DATA_AXIS, data_sharding

I32 = torch.int32
I64 = torch.int64


def partition_of_minimizer(minim: torch.Tensor, n_parts: int,
                           repart_table: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Minimizer -> partition id: a gather from a Repartitor table
    (kmer/repartition.py), else the multiplicative hash
    ``(minim * 0x9E3779B1 mod 2^32) >> 16`` mod n_parts. Partitioning
    only affects balance, never results."""
    if repart_table is not None:
        return repart_table[minim.long()].to(I32)
    a = minim.to(I64) & 0xFFFFFFFF
    # the low 32 bits of the product, in halves that fit int64
    c = 0x9E3779B1
    h = ((a & 0xFFFF) * c + (((a >> 16) * c) << 16)) & 0xFFFFFFFF
    return ((h >> 16) % n_parts).to(I32)


class ShardCount(NamedTuple):
    """The stacked per-rank output of the exchange + count step.

    table.kmers has the global shape (ndev * cap_t, W), rank d's rows at
    [d * cap_t, (d + 1) * cap_t); table.n and overflow.n are (ndev,) live
    rows per rank."""

    table: CountTable          # counts of k-mers routed to each rank
    overflow: CountTable       # counts of k-mers that missed the window
    n_overflowed: torch.Tensor  # (ndev,) overflow sizes (kept, not lost)


def _local_count(kmers: torch.Tensor, invalid: torch.Tensor) -> CountTable:
    sk, si = sort_by_kmer(kmers, invalid)
    return count_sorted(sk, si)


def make_count_step(mesh, k: int, m: int = 10, capacity_factor: float = 2.0,
                    repartitor=None, nb_passes: int = 1):
    """The multi-rank counting step over ``mesh``.

    Returns fn(codes, valid, lengths, pass_i=None) -> ShardCount, called
    by every rank with the same global batch ((B, L) codes and validity,
    (B,) lengths; numpy or tensors); each rank counts its rows. With
    nb_passes > 1 the DSK pass filter applies (minimizer % nb_passes ==
    pass_i, SortingCountAlgorithm.cpp:806). ``repartitor`` supplies the
    load-balanced minimizer -> partition table."""
    from ..ops.kmer_ops import extract_kmers

    ndev = mesh.shape[DATA_AXIS]
    dev = mesh.device
    repart_table = None
    if repartitor is not None:
        if repartitor.nb_partitions != ndev:
            raise ValueError("repartitor partitions != mesh size")
        repart_table = repartitor.device_table(dev)

    def step(codes, valid, lengths, pass_i):
        kb = extract_kmers(codes, valid, lengths, k, m)
        w = kb.kmers.shape[-1]
        flat_k = kb.kmers.reshape(-1, w)
        flat_v = kb.valid.reshape(-1)
        if nb_passes > 1:
            flat_v = flat_v & (kb.minimizer.reshape(-1) % nb_passes
                               == pass_i)
        n = flat_k.shape[0]
        cap = max(int(capacity_factor * n / ndev) if ndev > 1 else n, 1)

        pid = partition_of_minimizer(kb.minimizer.reshape(-1), ndev,
                                     repart_table)
        # invalid k-mers: route nowhere (pid ndev -> dropped from sends)
        pid = torch.where(flat_v, pid, ndev)
        order = torch.sort(pid, stable=True).indices
        pid_s = pid[order]
        kmer_s = flat_k[order]
        # rank within partition
        starts = torch.searchsorted(
            pid_s, torch.arange(ndev + 1, dtype=I32, device=dev))
        rank = torch.arange(n, device=dev) \
            - starts[pid_s.clamp(0, ndev).long()]
        # (ndev, cap) send windows; overflow and invalid rows go to a dump
        # row past the windows
        in_window = (rank < cap) & (pid_s < ndev)
        dest = torch.where(in_window, pid_s.to(I64) * cap + rank,
                           ndev * cap)
        send_k = torch.full((ndev * cap + 1, w), SENTINEL, dtype=I32,
                            device=dev)
        send_k[dest] = kmer_s.to(I32)
        send_live = torch.zeros((ndev * cap + 1,), dtype=I32, device=dev)
        send_live[dest] = in_window.to(I32)
        # rank p receives row [s] = what rank s sent to p
        recv_k = mesh.all_to_all(send_k[:-1].reshape(ndev, cap, w))
        recv_live = mesh.all_to_all(send_live[:-1].reshape(ndev, cap))
        table = _local_count(recv_k.reshape(-1, w),
                             recv_live.reshape(-1) == 0)
        # k-mers past their window: counted here, exactly
        over = flat_v[order] & (rank >= cap) & (pid_s < ndev)
        otable = _local_count(kmer_s, ~over)
        return table, otable, over.sum().to(I32)

    def wrapped(codes, valid, lengths, pass_i=None) -> ShardCount:
        rows = data_sharding(mesh, len(lengths))

        def local(a, dtype):
            return torch.as_tensor(a[rows]).to(dev, dtype)

        table, otable, n_over = step(
            local(codes, torch.uint8), local(valid, torch.bool),
            local(lengths, I32), int(pass_i or 0))

        def stacked(t: CountTable) -> CountTable:
            return CountTable(mesh.all_gather(t.kmers).flatten(0, 1),
                              mesh.all_gather(t.counts).flatten(0, 1),
                              mesh.all_gather(t.n.reshape(1)).reshape(-1))

        return ShardCount(stacked(table), stacked(otable),
                          mesh.all_gather(n_over.reshape(1)).reshape(-1))

    return wrapped


def count_kmers_distributed(bank, mesh, **kwargs):
    """End-to-end multi-rank SortingCount over a mesh: the superbatch
    exchange driver (parallel/superbatch.py). The batch-granular host-merge
    driver below stays as the reference of the equality tests."""
    from .superbatch import count_kmers_distributed_superbatch

    return count_kmers_distributed_superbatch(bank, mesh, **kwargs)


def count_kmers_distributed_hostmerge(
        bank, mesh, kmer_size: int = 31,
        minimizer_size: int = 10, abundance_min=2,
        abundance_max: int = 2**31 - 1,
        nb_passes: int = 1,
        batch_reads_per_device: int = 256,
        batch_len: int = 256,
        capacity_factor: float = 2.0,
        repartitor="auto",
        histo_max: int = 10000):
    """Batch-granular multi-rank SortingCount (host merge per batch).

    SortingCountAlgorithm::execute (kmer/impl/SortingCountAlgorithm.cpp:
    636-680) in SPMD form: the bank streams as fixed global batches, each
    runs extraction -> repartitor-table all-to-all -> per-rank sort and
    reduce, with the DSK pass loop on top; the per-rank tables and the
    overflow rows merge into the final sorted table, equal to the
    single-device result for any mesh size.

    repartitor: 'auto' builds the sampled-census greedy table; None uses
    the multiplicative hash; or pass a kmer.repartition.Repartitor."""
    from ..bank.fasta import open_bank
    from ..kmer.counting import _BatchBuilder, _global_merge, _prefetch
    from ..ops.kmer_ops import nb_limbs

    bank = open_bank(bank)
    k = kmer_size
    ndev = mesh.shape[DATA_AXIS]
    dev = mesh.device
    if repartitor == "auto":
        from ..kmer.repartition import build_repartitor

        repartitor = build_repartitor(bank, k, ndev, minimizer_size,
                                      device=dev)
    step = make_count_step(mesh, k, minimizer_size,
                           capacity_factor=capacity_factor,
                           repartitor=repartitor, nb_passes=nb_passes)

    builder = _BatchBuilder(k, batch_reads_per_device * ndev, batch_len)

    def produce():
        for seq in bank:
            yield from builder.add(seq.data)
        if builder.row:
            yield builder.flush()

    parts_k: list = []
    parts_c: list = []
    nb_seq = 0
    seq_total = 0
    for pass_i in range(max(1, nb_passes)):
        for codes, valid, lengths, rows in _prefetch(produce(), depth=2):
            if pass_i == 0:
                nb_seq += rows
                seq_total += int(lengths.sum())
            bk, bc = global_table(step(codes, valid, lengths, pass_i), ndev)
            if len(bk):
                parts_k.append(bk)
                parts_c.append(bc)

    w = nb_limbs(k)
    if parts_k:
        uniq, counts = _global_merge(np.concatenate(parts_k),
                                     np.concatenate(parts_c), w, dev)
    else:
        uniq = np.zeros((0, w), np.uint32)
        counts = np.zeros((0,), np.int32)

    return _count_result(uniq, counts,
                         {"kmers_nb_valid": int(counts.sum())}, nb_seq,
                         seq_total, k=k, minimizer_size=minimizer_size,
                         abundance_min=abundance_min,
                         abundance_max=abundance_max, nb_passes=nb_passes,
                         histo_max=histo_max, ndev=ndev, dev=dev)


def _count_result(uniq: np.ndarray, counts: np.ndarray, windows: dict,
                  nb_seq: int, seq_total: int, *, k: int,
                  minimizer_size: int, abundance_min, abundance_max: int,
                  nb_passes: int, histo_max: int, ndev: int, dev):
    """The tail both count drivers share: the histogram, the solidity
    threshold (``'auto'``: its first minimum) and the CountResult of the
    solid rows, with the JAX package's ``info`` (``windows``: the driver's
    window counts)."""
    from ..kmer.counting import CountConfig, CountResult
    from ..kmer.histogram import Histogram

    histogram = Histogram(histo_max)
    if len(counts):
        histogram.add_counts(counts)
    if abundance_min == "auto":
        amin = histogram.compute_threshold(2)
    else:
        amin = int(abundance_min)
        histogram.cutoff = amin
    solid = (counts >= amin) & (counts <= abundance_max)
    info = {
        "kmers_nb_distinct": int(len(counts)),
        "kmers_nb_solid": int(solid.sum()),
        "kmers_nb_weak": int(len(counts) - solid.sum()),
        **windows,
        "sequences_number": int(nb_seq),
        "sequences_size": int(seq_total),
        "kmer_size": k,
        "abundance_min": amin,
        "abundance_max": abundance_max,
        "nb_devices": ndev,
        "nb_passes": max(1, nb_passes),
    }
    cfg = CountConfig(kmer_size=k, minimizer_size=minimizer_size,
                      abundance_min=abundance_min,
                      abundance_max=abundance_max, nb_passes=nb_passes,
                      device=str(dev))
    histogram.nb_solids_after_cutoff = int(solid.sum())
    return CountResult(uniq[solid], counts[solid].astype(np.int32),
                       histogram, info, cfg)


def global_table(shards: ShardCount, ndev: int):
    """Host side: merge the per-rank tables (+ overflow) into the final
    globally sorted (kmers (N, W) uint32, counts (N,) int32) numpy arrays.
    Exact: per-rank tables are disjoint by partition; overflow rows merge
    by summation (``_global_merge`` on the tables' device)."""
    from ..convert import u32_to_numpy
    from ..kmer.counting import _global_merge

    tk = u32_to_numpy(shards.table.kmers)
    tc = shards.table.counts.cpu().numpy()
    tn = shards.table.n.cpu().numpy().reshape(ndev)
    ok = u32_to_numpy(shards.overflow.kmers)
    oc = shards.overflow.counts.cpu().numpy()
    on = shards.overflow.n.cpu().numpy().reshape(ndev)
    cap_t = tk.shape[0] // ndev
    cap_o = ok.shape[0] // ndev
    parts_k, parts_c = [], []
    for d in range(ndev):
        parts_k.append(tk[d * cap_t: d * cap_t + tn[d]])
        parts_c.append(tc[d * cap_t: d * cap_t + tn[d]])
        parts_k.append(ok[d * cap_o: d * cap_o + on[d]])
        parts_c.append(oc[d * cap_o: d * cap_o + on[d]])
    return _global_merge(np.concatenate(parts_k, axis=0),
                         np.concatenate(parts_c, axis=0), tk.shape[-1],
                         shards.table.kmers.device)

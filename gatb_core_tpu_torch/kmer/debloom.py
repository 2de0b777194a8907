"""Debloom: critical false positive (cFP) set construction.

Port of gatb_core_tpu/kmer/debloom.py, itself a port of gatb-core's
DebloomAlgorithm (kmer/impl/DebloomAlgorithm.cpp) /
DebloomMinimizerAlgorithm: the de Bruijn graph membership oracle is
(Bloom AND not cFP), where cFP = the Bloom's false positives among the
1-neighborhood of solid k-mers, exactly the queries graph traversal can
make. Phases (DebloomAlgorithm.cpp:270-600):

  1. probe all 8 neighbor extensions of every solid k-mer against the Bloom
  2. subtract the true-solid k-mers
  3. persist the remainder as a sorted set (DebloomKind 'original'
     ContainerSet; the reference's 'cascading' variant is an alternative
     *encoding* of the same set)

Phases 1-2 are one sweep over the solid table in chunks, on ``device``:
candidate generation, the Bloom gather, the rank search of every candidate
in the solid table (``ops/rank_search.rank_rows``) and a sort + distinct
reduce of the hits (``ops/sortops.count_planes``, the limb-sort kernels).
The chunks' tables are joined by one more sort + reduce on the device. The
cFP set is a set: it does not depend on the chunking.

With a ``mesh`` the sweep runs range-sharded over its ranks
(parallel/postsolid.distributed_debloom_probe); the cFP set is the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..collections.bloom import BloomFilter, _bloom_build, _bloom_contains, \
    build_bloom, debloom_nbits_per_kmer
from ..collections.sortedset import SortedKmerSet
from ..convert import u32_to_numpy, u32_to_torch
from ..ops.neighbor_ops import neighbor_candidates
from ..ops.rank_search import as_rows


@dataclass
class CascadeCFP:
    """Cascading-bloom encoding of the cFP set (DebloomAlgorithm::createCFP
    DEBLOOM_CASCADING branch, kmer/impl/DebloomAlgorithm.cpp:487-590):
    bloom2 over cFP, bloom3 over T2 = {solid hit by bloom2}, bloom4 over
    T3 = {cFP hit by bloom3}, and the exact sorted set T4 = {T2 hit by
    bloom4}. All three blooms use the cache-coherent kind (forced,
    :497)."""

    blooms: list            # [bloom2, bloom3, bloom4]
    t4: np.ndarray          # (T, W) sorted exact leftover set


@dataclass
class DebloomResult:
    bloom: BloomFilter
    cfp: np.ndarray           # (C, W) sorted critical false positives
    nb_cfp: int
    info: dict
    kind: str = "original"
    cascade: CascadeCFP | None = None


def _f32(x) -> float:
    return float(np.float32(x))


def rows_to_device(limbs, device) -> torch.Tensor:
    """(N, W) uint32 numpy rows, or a tensor of limb rows -> contiguous
    int32 storage on ``device``."""
    if isinstance(limbs, torch.Tensor):
        return as_rows(limbs.to(device))
    return u32_to_torch(limbs, device)


def rows_to_numpy(rows: torch.Tensor) -> np.ndarray:
    """Limb rows (int32 storage) -> contiguous (N, W) uint32 numpy."""
    return np.ascontiguousarray(u32_to_numpy(rows))


def build_cascading_cfp(solid_limbs, cfp_limbs, k: int, user_seed: int = 0,
                        device="cuda") -> CascadeCFP:
    """Exact port of the cascading cFP construction
    (DebloomAlgorithm.cpp:487-590, float32 size arithmetic preserved).
    ``solid_limbs`` and ``cfp_limbs`` are (N, W) uint32 numpy rows or limb
    tensors; the blooms' words stay on ``device``."""
    solid = rows_to_device(solid_limbs, device)
    cfp = rows_to_device(cfp_limbs, device)
    nbits = debloom_nbits_per_kmer(k, True)
    nb_solid = solid.shape[0]
    nb_cfp = cfp.shape[0]
    n_hash = max(1, int(np.floor(np.float32(0.7 * _f32(nbits)))))
    # powf computes in float32: (double)powf((double)0.62,(double)nbits)
    pw = float(np.power(np.float32(0.62), np.float32(nbits),
                        dtype=np.float32))
    t2_est = max(int(np.ceil(np.float32(nb_solid * pw))), 1)
    t3_est = max(int(np.ceil(np.float32(nb_cfp * pw))), 1)

    def sized_bloom(items: torch.Tensor, est_items: int) -> BloomFilter:
        size = int(np.float32(est_items) * np.float32(nbits))
        size = max(size, 1)
        words = _bloom_build(items, None, size, n_hash, user_seed, "cache",
                             k)
        return BloomFilter(words, size, n_hash, user_seed, "cache", k)

    bloom2 = sized_bloom(cfp, nb_cfp)
    t2 = solid[bloom2.contains(solid)]
    bloom3 = sized_bloom(t2, t2_est)
    t3 = cfp[bloom3.contains(cfp)]
    bloom4 = sized_bloom(t3, t3_est)
    t4 = t2[bloom4.contains(t2)]
    # reference sorts cfpItems (already ascending here: t2 preserves the
    # sorted solid order and t4 filters it)
    return CascadeCFP([bloom2, bloom3, bloom4], rows_to_numpy(t4))


def _dedup_rows(rows: torch.Tensor, valid: torch.Tensor, cap_out: int):
    """Sorted distinct valid rows of (N, W) int32 ``rows`` through the
    limb-sort kernels: ``count_planes`` with invalid rows sent to the
    all-ones tail (no canonical k-mer is all-ones, so ``spare_bits`` holds
    for every k). Rows equal in every plane are identical, so any correct
    sort gives the same table. Returns (planes (W, cap_out), n, overflow)
    with n and overflow 0-d tensors."""
    from ..ops.sortops import _next_pow2, count_planes

    n, w = rows.shape
    cap = _next_pow2(max(n, 2))
    planes = torch.full((w, cap), -1, dtype=torch.int32, device=rows.device)
    planes[:, :n] = rows.T
    live = torch.zeros((cap,), dtype=torch.bool, device=rows.device)
    live[:n] = valid
    out_p, _, n_out, ovf = count_planes(planes, live, spare_bits=True,
                                        cap_out=cap_out)
    return out_p, n_out, ovf


def build_debloom(solid_limbs, k: int,
                  bloom_nbits: float | None = None,
                  cascading: bool = False, user_seed: int = 0,
                  bloom_kind: str = "neighbor",
                  chunk: int | None = None, mesh=None,
                  device="cuda", index=None) -> DebloomResult:
    """Build Bloom + cFP over the solid set (BloomAlgorithm +
    DebloomAlgorithm equivalents) on ``device``. ``solid_limbs`` is the
    sorted (N, W) uint32 table (numpy, or limb rows already on the device).
    ``bloom_kind`` defaults to the reference graph build's main-bloom
    default (neighbor-coherent: a reference dbgh5 .h5 carries /bloom
    kind='neighbor'); ``cascading`` selects the cFP encoding (reference
    default kind). ``chunk`` bounds the nodes per sweep step. ``index``:
    the table's ``RankIndex`` where the caller holds one; else the sweep
    builds one for all its steps. With ``mesh`` the 8-probe sweep runs
    range-sharded over its ranks (on the mesh's device)."""
    from ..ops.rank_search import held_index
    from ..ops.sortops import _next_pow2, sweep_chunk

    table = rows_to_device(solid_limbs, device)
    n = table.shape[0]
    w = table.shape[1] if n else 1
    if bloom_nbits is None:
        # NBITS_PER_KMER formula (DebloomAlgorithm.cpp:628-650)
        bloom_nbits = debloom_nbits_per_kmer(k, cascading)
    bloom = build_bloom(table, nbits_per_kmer=bloom_nbits,
                        nb_items=max(n, 1), user_seed=user_seed,
                        kind=bloom_kind, kmer_size=k)

    if mesh is not None and n:
        from ..parallel.postsolid import distributed_debloom_probe

        return _debloom_result(
            table, k, bloom, bloom_nbits, cascading, user_seed, device,
            distributed_debloom_probe(mesh, table, k, bloom, index=index))
    index = held_index(table, n, index)
    csize = sweep_chunk(max(n, 1))
    if chunk:                   # caller-imposed bound
        csize = min(csize, chunk)
    # the cFP hits are a few % of the 8 probes/node (4.2% under the default
    # 6-bit cascading Bloom, so 1/16 of the probes where the JAX package
    # starts at 1/32 and always retries there); overflow doubles the
    # capacity and retries the chunk (exact either way)
    cap_out = _next_pow2(max(4096, (csize * 8) // 16))
    parts = []
    for i in range(0, n, csize):
        while True:
            out_p, n_hit, ovf = _debloom_probe_compact(
                table[i:i + csize], table, n, bloom.words, k=k,
                size_bits=bloom.size_bits, n_hash=bloom.n_hash,
                seed=user_seed, kind=bloom.kind, cap_out=cap_out,
                index=index)
            if not bool(ovf):
                break
            cap_out *= 2
        nh = int(n_hit)
        if nh:
            parts.append(out_p[:, :nh].T)
    if len(parts) > 1:
        # the chunks' tables overlap: one more sort + reduce joins them
        allc = torch.cat(parts, dim=0).contiguous()
        ones = torch.ones((allc.shape[0],), dtype=torch.bool,
                          device=allc.device)
        out_p, n_all, _ = _dedup_rows(allc, ones, allc.shape[0])
        cfp = rows_to_numpy(out_p[:, :int(n_all)].T)
    elif parts:
        cfp = rows_to_numpy(parts[0])
    else:
        cfp = np.zeros((0, w), np.uint32)
    return _debloom_result(table, k, bloom, bloom_nbits, cascading,
                           user_seed, device, cfp)


def _debloom_result(table, k: int, bloom, bloom_nbits, cascading: bool,
                    user_seed: int, device, cfp: np.ndarray):
    """The DebloomResult of a cFP set: its kind, the cascade and info."""
    # reference falls back to ORIGINAL when there are no false positives
    # (DebloomAlgorithm.cpp:476-478)
    kind = "cascading" if (cascading and len(cfp)) else "original"
    cascade = None
    if kind == "cascading":
        cascade = build_cascading_cfp(table, cfp, k, user_seed, device)

    info = {
        "bloom_size_bits": bloom.size_bits,
        "bloom_nb_hash": bloom.n_hash,
        "nbits_per_kmer": bloom_nbits,
        "nb_cfp": int(len(cfp)),
        "debloom_kind": kind,
    }
    return DebloomResult(bloom, cfp, len(cfp), info, kind, cascade)


def _debloom_probe(nodes, table, n_table, bloom_words, *, k: int,
                   size_bits: int, n_hash: int, seed: int,
                   kind: str = "basic", index=None):
    """8-extension cFP probe sweep: Bloom gather + rank search in the solid
    table (through its ``index`` where the sweep holds one), the
    reference's 8 probes/solid k-mer hot loop (DebloomAlgorithm.cpp:270-300).
    Returns (hit (8N,) bool, cands (N, 8, W) int64)."""
    from ..ops.sortops import rank_join_traced

    cands = neighbor_candidates(nodes, k)            # (N, 8, W)
    flat = cands.reshape(-1, cands.shape[-1])
    in_bloom = _bloom_contains(bloom_words, flat, size_bits, n_hash,
                               seed, kind, k)
    _, solid = rank_join_traced(table, flat, n_table, index=index)
    return in_bloom & ~solid, cands


def _debloom_probe_compact(nodes, table, n_table, bloom_words, *, k: int,
                           size_bits: int, n_hash: int, seed: int,
                           kind: str, cap_out: int, index=None):
    """_debloom_probe + dedup/compaction of the cFP hits on the device:
    only the (W, cap_out) distinct cFP table leaves it. Returns (planes,
    n, overflow)."""
    hit, cands = _debloom_probe(nodes, table, n_table, bloom_words, k=k,
                                size_bits=size_bits, n_hash=n_hash,
                                seed=seed, kind=kind, index=index)
    flat = cands.reshape(-1, cands.shape[-1]).to(torch.int32)
    return _dedup_rows(flat, hit, cap_out)


class BloomCfpContainer:
    """Graph membership oracle: bloom(x) and not cfp(x)
    (ContainerNode equivalent, debruijn/impl/ContainerNode.hpp:60-90).

    Exact for every query in the 1-neighborhood of solid k-mers, the
    closure traversal operates in. When the debloom kind is cascading,
    the cFP test is the bloom chain (ContainerNodeCascading::containsCFP,
    ContainerNode.hpp:174-186): in-cFP iff bloom2(x) and (not bloom3(x)
    or (bloom4(x) and x not in T4)). Queries run on the device of the
    main bloom's words."""

    def __init__(self, debloom: DebloomResult):
        self.bloom = debloom.bloom
        self.kind = debloom.kind
        device = self.bloom.words.device
        if debloom.kind == "cascading" and debloom.cascade is not None:
            self.cascade = debloom.cascade
            self.t4 = SortedKmerSet(rows_to_device(self.cascade.t4, device),
                                    len(self.cascade.t4))
            self.cfp = None
        else:
            self.cascade = None
            self.cfp = SortedKmerSet(rows_to_device(debloom.cfp, device),
                                     len(debloom.cfp))

    def _contains_cfp(self, q: torch.Tensor) -> torch.Tensor:
        if self.cascade is None:
            return self.cfp.contains(q)
        b2, b3, b4 = self.cascade.blooms
        in2 = b2.contains(q)
        in3 = b3.contains(q)
        in4 = b4.contains(q)
        in_t4 = self.t4.contains(q)
        return in2 & (~in3 | (in4 & ~in_t4))

    def contains(self, queries) -> np.ndarray:
        """(N, W) or (W,) uint32 numpy rows (or a limb tensor) -> (N,) bool
        numpy."""
        if not isinstance(queries, torch.Tensor):
            queries = np.atleast_2d(queries)
        q = rows_to_device(queries, self.bloom.words.device)
        hit = self.bloom.contains(q)
        return (hit & ~self._contains_cfp(q)).cpu().numpy()

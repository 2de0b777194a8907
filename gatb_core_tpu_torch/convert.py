"""State carried between the JAX package and this port: count tables, and
the Bloom and debloom structures of the graph build.

There are no model weights; the state is a distinct count table, the
fold accumulator, and a graph's Bloom filter and cFP encoding. The JAX
package hands tables over as numpy arrays: a table is
``(planes, counts, n)`` with ``planes`` a tuple of (C,) uint32 limb planes
(most significant first), ``counts`` (C,) int32 and ``n`` the number of
live rows; a result's ``solid_kmers`` is (N, W) uint32. The port
keeps planes as one (W, C) int32 tensor holding the same bit patterns. A
multibank table adds B count columns (a tuple there, one (B, C) tensor
here); a row-major ``CountTable`` and a ``MultiBankCountResult`` have the
same fields on both sides.

A ``BloomFilter`` has the same six fields in both packages, with ``words``
a uint32 array there and an int32 tensor of the same bits here; a
``DebloomResult`` and its ``CascadeCFP`` hold numpy sets and such blooms. A
``BooPHF`` has the same eight fields in both packages (arrays there,
tensors of the same bits here).
This module imports nothing of the JAX package: towards the port it reads
any object with those fields, towards JAX it hands out the fields with
numpy arrays (``gatb_core_tpu.collections.bloom.BloomFilter(
jnp.asarray(words), *rest)`` rebuilds the filter there).
"""

from __future__ import annotations

import numpy as np
import torch


def u32_to_torch(a, device="cpu") -> torch.Tensor:
    """uint32 numpy array -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def u32_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 (or int64 zero-extended) tensor -> uint32 numpy array."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def planes_to_torch(planes, device="cpu") -> torch.Tensor:
    """Tuple of (C,) uint32 planes -> (W, C) int32 tensor."""
    return u32_to_torch(np.stack([np.asarray(p) for p in planes]), device)


def planes_to_numpy(planes: torch.Tensor) -> tuple:
    """(W, C) int32 tensor -> tuple of (C,) uint32 planes."""
    a = u32_to_numpy(planes)
    return tuple(a[i] for i in range(a.shape[0]))


def table_to_torch(planes, counts, n, device="cpu"):
    """JAX-layout table -> ((W, C) int32 planes, (C,) int32 counts,
    0-d int32 n) on ``device``."""
    return (planes_to_torch(planes, device),
            torch.from_numpy(np.asarray(counts, np.int32).copy()).to(device),
            torch.tensor(int(n), dtype=torch.int32, device=device))


def table_to_numpy(planes: torch.Tensor, counts: torch.Tensor, n):
    """Port table -> (tuple of uint32 planes, int32 counts, int n)."""
    return (planes_to_numpy(planes), counts.detach().cpu().numpy(),
            int(n))


def kmers_to_torch(kmers, device="cpu") -> torch.Tensor:
    """(N, W) uint32 rows (``solid_kmers`` layout) -> (W, N) int32 planes."""
    return u32_to_torch(np.asarray(kmers, np.uint32).T, device)


def kmers_to_numpy(planes: torch.Tensor) -> np.ndarray:
    """(W, N) planes -> (N, W) uint32 rows."""
    return np.ascontiguousarray(u32_to_numpy(planes).T)


def table_multi_to_torch(planes, counts_list, n, device="cpu"):
    """JAX-layout multibank table (tuple of (C,) uint32 planes, tuple of B
    (C,) int32 count columns, n) -> ((W, C) int32 planes, (B, C) int32
    counts, 0-d int32 n) on ``device``."""
    counts = np.stack([np.asarray(c, np.int32) for c in counts_list])
    return (planes_to_torch(planes, device),
            torch.from_numpy(counts).to(device),
            torch.tensor(int(n), dtype=torch.int32, device=device))


def table_multi_to_numpy(planes: torch.Tensor, counts: torch.Tensor, n):
    """Port multibank table -> (tuple of uint32 planes, tuple of B int32
    count columns, int n)."""
    c = counts.detach().cpu().numpy()
    return planes_to_numpy(planes), tuple(c[i] for i in range(c.shape[0])), \
        int(n)


def count_table_to_torch(kmers, counts, n, device="cpu"):
    """Row-major CountTable of the JAX package, as numpy arrays (kmers
    (C, W) uint32, counts (C,) int32, n) -> the port's CountTable."""
    from .ops.sortops import CountTable

    return CountTable(
        u32_to_torch(np.asarray(kmers, np.uint32), device),
        torch.from_numpy(np.asarray(counts, np.int32).copy()).to(device),
        torch.tensor(int(n), dtype=torch.int32, device=device))


def count_table_to_numpy(table):
    """The port's CountTable -> (kmers (C, W) uint32, counts (C,) int32,
    int n), the fields of the JAX package's CountTable as numpy arrays."""
    return (u32_to_numpy(table.kmers), table.counts.detach().cpu().numpy(),
            int(table.n))


def multibank_result_from_numpy(kmers, counts_per_bank, counts_sum,
                                solid_mask, info):
    """Fields of a JAX-package MultiBankCountResult (numpy arrays and the
    info dict) -> the port's MultiBankCountResult."""
    from .kmer.counting import MultiBankCountResult

    return MultiBankCountResult(
        np.asarray(kmers, np.uint32), np.asarray(counts_per_bank, np.int32),
        np.asarray(counts_sum, np.int64), np.asarray(solid_mask, bool),
        dict(info))


def multibank_result_to_numpy(res):
    """A MultiBankCountResult -> (kmers, counts_per_bank, counts_sum,
    solid_mask, info), the order of the JAX package's constructor."""
    return (np.asarray(res.kmers), np.asarray(res.counts_per_bank),
            np.asarray(res.counts_sum), np.asarray(res.solid_mask),
            dict(res.info))


def bloom_to_torch(bloom, device="cpu"):
    """Any BloomFilter-shaped object (the JAX package's, or fields with a
    numpy ``words``) -> the port's BloomFilter with words on ``device``."""
    from .collections.bloom import BloomFilter

    return BloomFilter(u32_to_torch(np.asarray(bloom.words), device),
                       int(bloom.size_bits), int(bloom.n_hash),
                       int(bloom.user_seed), str(bloom.kind),
                       int(bloom.kmer_size))


def bloom_to_numpy(bloom) -> tuple:
    """The port's BloomFilter -> (words uint32 numpy, size_bits, n_hash,
    user_seed, kind, kmer_size), the order of the JAX package's fields."""
    return (bloom.to_numpy(), bloom.size_bits, bloom.n_hash,
            bloom.user_seed, bloom.kind, bloom.kmer_size)


def debloom_to_torch(res, device="cpu"):
    """A DebloomResult-shaped object of the JAX package -> the port's
    DebloomResult (cascade and all), Bloom words on ``device``."""
    from .kmer.debloom import CascadeCFP, DebloomResult

    cascade = None
    if res.cascade is not None:
        cascade = CascadeCFP(
            [bloom_to_torch(b, device) for b in res.cascade.blooms],
            np.asarray(res.cascade.t4, np.uint32))
    return DebloomResult(bloom_to_torch(res.bloom, device),
                         np.asarray(res.cfp, np.uint32), int(res.nb_cfp),
                         dict(res.info), res.kind, cascade)


def debloom_to_numpy(res) -> dict:
    """The port's DebloomResult -> its fields with numpy arrays: ``bloom``
    and each of ``cascade_blooms`` as ``bloom_to_numpy`` tuples, ``cfp``,
    ``nb_cfp``, ``info``, ``kind`` and ``t4`` (None without a cascade)."""
    cas = res.cascade
    return {
        "bloom": bloom_to_numpy(res.bloom),
        "cfp": np.asarray(res.cfp, np.uint32),
        "nb_cfp": int(res.nb_cfp),
        "info": dict(res.info),
        "kind": res.kind,
        "cascade_blooms": None if cas is None
        else [bloom_to_numpy(b) for b in cas.blooms],
        "t4": None if cas is None else np.asarray(cas.t4, np.uint32),
    }


def boophf_to_torch(mphf, device="cpu"):
    """Any BooPHF-shaped object (the JAX package's: ``bits`` uint32,
    ``prefix`` / ``perm`` / ``fallback_ranks`` int32, ``fallback_keys``
    (F, W) uint32, ``sizes`` / ``offsets`` tuples, ``n``) -> the port's
    BooPHF with its tensors on ``device``."""
    from .collections.boophf import BooPHF

    def ints(a):
        return torch.from_numpy(np.asarray(a, np.int32).copy()).to(device)

    return BooPHF(tuple(int(x) for x in mphf.sizes),
                  u32_to_torch(np.asarray(mphf.bits), device),
                  ints(mphf.prefix),
                  tuple(int(x) for x in mphf.offsets),
                  u32_to_torch(np.asarray(mphf.fallback_keys), device),
                  ints(mphf.fallback_ranks), ints(mphf.perm), int(mphf.n))


def boophf_to_numpy(mphf) -> dict:
    """The port's BooPHF -> its fields with numpy arrays of the JAX
    package's dtypes."""
    return {
        "sizes": tuple(mphf.sizes), "offsets": tuple(mphf.offsets),
        "bits": u32_to_numpy(mphf.bits),
        "prefix": mphf.prefix.cpu().numpy(),
        "perm": mphf.perm.cpu().numpy(),
        "fallback_keys": u32_to_numpy(mphf.fallback_keys),
        "fallback_ranks": mphf.fallback_ranks.cpu().numpy(),
        "n": int(mphf.n),
    }

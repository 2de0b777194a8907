"""Time ``rank_rows`` and ``neighbor_masks`` at the main path's shapes.

    python gatb_core_tpu_torch/tools/rank_sweep.py [--tree DIR]

Shapes of ``rank_rows`` on one CUDA card (tables and queries made on the
card from fixed seeds, so two runs on one card see the same inputs;
``chip_smoke.py`` times the same four):

  a2, a4  8 x 2^20 queries, half drawn from the table and half random, in
          random order, on a table of 2^20 random rows of 2 / 4 limbs;
  b       the stress sweep step: the 8 neighbour candidates of the first
          2^21 sorted nodes (2^24 queries) of the canonical 31-mers of a
          random 30 Mbp genome (the stress bank's solid table: the genome's
          k-mers, ~30M rows);
  c       2^24 random-order queries, half present, on the same table
          (``node_index`` traffic);
  d       the candidate sweep of a k=63 table (4 limbs): every node's 8
          candidates on the canonical 63-mers of a random 523,456 bp genome
          (523,394 windows, the size of the k=63 graph of ``chip_smoke.py``).

and ``neighbor_masks`` (ops/neighbor_ops) at two shapes on the stress table:

  q       a query batch: 71,000 nodes (a Dispatcher group of 1,000 reads
          of 101 bp at k = 31) in random order, 6 in 7 present;
  s       the adjacency sweep step: the first 2^21 sorted nodes.

For each rank shape: the kernel with the table's index already built
(``ms``), the index build (``index_ms``), the one-shot call that builds a
transient index (``one_shot_ms``), the plain version (``plain_ms``) and,
at 1-2 limbs, ``torch.searchsorted`` on int64 keys (``library_ms``, lower
bound only); CUDA events, median after warm-up. Every result is held
against the plain version's, the found rows' ranks against the lower bound
of ``torch.searchsorted`` (``library_err``, the rows that differ), and a
digest of the ranks is printed so that two trees' runs can be compared.
For each mask shape: the kernel through the held index (``ms``), the chain
it replaces (``neighbor_candidates``, ``rank_rows``, the pack: ``chain_ms``),
``rank_rows`` alone on the same 8 N candidates (``rank_rows_ms``), the
same calls on the host's clock with a synchronise (``*_wall_ms``), and the
bound: a node's row read, 8 table rows read and a byte written, over
3.35 TB/s (``bound_ms``); the kernel's masks held against the chain's and
the plain version's. One JSON line per shape; the exit code is 1 if any
rank shape disagreed with ``torch.searchsorted``.

``--tree DIR`` times the package of another checkout (a git-archive copy
of an earlier commit): where that tree has no ``RankIndex``, its kernel is
timed as it comes, as ``one_shot_ms``; where it has no ``neighbor_masks``,
only the chain and ``rank_rows`` are timed at the mask shapes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

K31_GENOME = 30_000_000
K63_GENOME = 523_456
STRESS_CHUNK = 1 << 21
QUERY_NODES = 71_000
PEAK_BYTES_S = 3.35e12              # HBM3 of one H100 SXM (data sheet)


def event_ms(torch, fn, warm: int = 2, reps: int = 7) -> float:
    """Median CUDA-event time of ``fn()`` after ``warm`` calls."""
    times = []
    for r in range(warm + reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if r >= warm:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def wall_ms(torch, fn, warm: int = 2, reps: int = 7) -> float:
    """Median host-clock time of ``fn()`` and a synchronise, after
    ``warm`` calls, with the card idle before each."""
    times = []
    for r in range(warm + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if r >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def lex_less(a, b):
    """Row-wise a < b over the last axis (big-endian limbs, int64)."""
    import torch

    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for j in range(a.shape[-1]):
        lt |= eq & (a[..., j] < b[..., j])
        eq &= a[..., j] == b[..., j]
    return lt


def sorted_distinct(rows):
    """(N, W) int64 limb rows -> their distinct rows ascending, as (M, W)
    int32 storage (checked ascending)."""
    import torch

    out = torch.unique(rows, dim=0)
    if len(out) > 1 and not bool(lex_less(out[:-1], out[1:]).all()):
        raise RuntimeError("torch.unique did not sort the rows")
    return out.to(torch.int32).contiguous()


def genome_rows(torch, k: int, genome_len: int, seed: int, device="cuda"):
    """The distinct canonical k-mers of a random genome, sorted, as (N, W)
    int32 limb rows (2 bits a base, A C T G = 0 1 2 3, the complement is
    x ^ 2, limb 0 most significant and holding the first bases)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    bases = torch.randint(0, 4, (genome_len,), dtype=torch.int64,
                          device=device, generator=gen)
    m = genome_len - k + 1
    w = (k + 15) // 16
    first = k - 16 * (w - 1)            # bases in limb 0
    fwd = torch.zeros((m, w), dtype=torch.int64, device=device)
    rev = torch.zeros((m, w), dtype=torch.int64, device=device)
    for j in range(k):
        limb = 0 if j < first else 1 + (j - first) // 16
        end = first + 16 * limb
        shift = 2 * (end - 1 - j)
        fwd[:, limb] |= bases[j:j + m] << shift
        rev[:, limb] |= (bases[k - 1 - j:k - 1 - j + m] ^ 2) << shift
    del bases
    canon = torch.where(lex_less(rev, fwd)[:, None], rev, fwd)
    del fwd, rev
    return sorted_distinct(canon)


def random_rows(torch, w: int, n: int, gen):
    x = torch.randint(0, 1 << 32, (n, w), dtype=torch.int64,
                      device=gen.device, generator=gen)
    x[x == (1 << 32) - 1] = 0            # no all-ones limb
    return sorted_distinct(x)


def mixed_queries(torch, table, q: int, gen, k: int | None = None):
    """q query rows in random order: half drawn from the table (so some
    are duplicated), half random (k-mers of k bases where k is given)."""
    n, w = table.shape
    out = torch.randint(0, 1 << 32, (q, w), dtype=torch.int64,
                        device=gen.device, generator=gen)
    if k is not None:
        out[:, 0] &= (1 << (2 * (k - 16 * (w - 1)))) - 1
    pick = torch.randint(0, n, (q,), device=gen.device, generator=gen)
    hit = torch.rand((q,), device=gen.device, generator=gen) < 0.5
    out = torch.where(hit[:, None], table[pick].to(torch.int64) & 0xFFFFFFFF,
                      out)
    return out.to(torch.int32).contiguous()


def candidates(torch, neighbor_candidates, nodes, k: int):
    return neighbor_candidates(nodes, k).reshape(-1, nodes.shape[1]) \
        .to(torch.int32).contiguous()


def shapes(torch, neighbor_candidates):
    """Yield (name, table, queries) for every shape, one table alive at a
    time (a2, a4, then b and c on the stress table, then d)."""
    gen = torch.Generator(device="cuda")
    for w in (2, 4):
        gen.manual_seed(17 + w)
        table = random_rows(torch, w, 1 << 20, gen)
        yield f"a{w}", table, mixed_queries(torch, table, 8 << 20, gen)
        del table
    table = genome_rows(torch, 31, K31_GENOME, 11)
    yield "b", table, candidates(torch, neighbor_candidates,
                                 table[:STRESS_CHUNK], 31)
    gen.manual_seed(23)
    yield "c", table, mixed_queries(torch, table, 1 << 24, gen, k=31)
    del table
    table = genome_rows(torch, 63, K63_GENOME, 63)
    yield "d", table, candidates(torch, neighbor_candidates, table, 63)


def digest(rank) -> str:
    return hashlib.sha256(rank.cpu().numpy().tobytes()).hexdigest()[:16]


def library_call(torch, table, queries):
    """torch.searchsorted on the rows as int64 keys (1-2 limbs), made
    before the clock: the lower bound only. None above 2 limbs."""
    w = table.shape[1]
    if w > 2:
        return None

    def keys_of(x):
        v = x[:, 0].long() & 0xFFFFFFFF
        if w == 2:
            v = (v << 32) | (x[:, 1].long() & 0xFFFFFFFF)
            v = v ^ torch.iinfo(torch.int64).min
        return v

    tkeys, qkeys = keys_of(table), keys_of(queries)
    return lambda: torch.searchsorted(tkeys, qkeys)


def measure(torch, R, table, queries) -> dict:
    """The times of one shape (see the module's note), its results held
    against the plain version's (a difference raises) and, at 1-2 limbs,
    the kernel's found rows' ranks against torch.searchsorted's lower bound
    (``library_err``: the rows that differ)."""
    n, w = table.shape
    out = {"w": w, "n_table": n, "queries": queries.shape[0]}
    ref = R.rank_rows_plain(table, queries, n)
    got = [R.rank_rows(table, queries, n)]
    out["one_shot_ms"] = event_ms(torch, lambda: R.rank_rows(table, queries,
                                                             n))
    if hasattr(R, "RankIndex"):
        index = R.RankIndex(table, n)
        out["levels"] = len(index.lengths)
        out["index_mib"] = index.rows.numel() * 4 / 2**20
        out["index_ms"] = event_ms(torch, lambda: R.RankIndex(table, n))
        got.append(R.rank_rows(table, queries, n, index=index))
        out["ms"] = event_ms(torch, lambda: R.rank_rows(table, queries, n,
                                                        index=index))
    for rank, found in got:
        if not (torch.equal(rank, ref[0]) and torch.equal(found, ref[1])):
            raise RuntimeError(f"rank_rows differs from its plain version "
                               f"at {out}")
    out["digest"] = digest(ref[0])
    out["found"] = int(ref[1].sum())
    out["plain_ms"] = event_ms(
        torch, lambda: R.rank_rows_plain(table, queries, n), warm=1, reps=3)
    lib = library_call(torch, table, queries)
    out["library_ms"] = out["library_err"] = None
    if lib is not None:
        rank, found = got[-1]           # the kernel's, through the index
        out["library_err"] = int((lib()[found] != rank[found]).sum())
        out["library_ms"] = event_ms(torch, lib)
    return out


def mask_shapes(torch):
    """Yield (name, table, nodes) for the neighbour masks: q and s on the
    stress table (shape b's)."""
    table = genome_rows(torch, 31, K31_GENOME, 11)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(71)
    pick = torch.randint(0, table.shape[0], (QUERY_NODES,),
                         device="cuda", generator=gen)
    nodes = table[pick]
    absent = mixed_queries(torch, table, QUERY_NODES, gen, k=31)
    nodes[::7] = absent[::7]
    yield "q", table, nodes.contiguous()
    yield "s", table, table[:STRESS_CHUNK]


def measure_masks(torch, R, N, table, nodes, k: int) -> dict:
    """The times of one mask shape (see the module's note); the kernel's
    masks differ from the chain's or the plain version's: raises."""
    n, w = table.shape
    m = nodes.shape[0]
    index = R.RankIndex(table, n)
    weights = 1 << torch.arange(8, dtype=torch.int32, device="cuda")
    cands = R.as_rows(N.neighbor_candidates(nodes, k).reshape(-1, w))

    def chain():
        c = R.as_rows(N.neighbor_candidates(nodes, k).reshape(-1, w))
        _, found = R.rank_rows(table, c, n, index=index)
        return (found.reshape(m, 8).to(torch.int32) * weights).sum(dim=1) \
            .to(torch.uint8)

    def rank_alone():
        return R.rank_rows(table, cands, n, index=index)

    out = {"w": w, "n_table": n, "nodes": m,
           "bound_ms": (m * w * 4 + 8 * m * w * 4 + m) / PEAK_BYTES_S * 1e3}
    want = chain()
    fns = {"chain": chain, "rank_rows": rank_alone}
    if hasattr(N, "neighbor_masks"):
        def fused():
            return N.neighbor_masks(nodes, table, n, k, index=index)

        if not (torch.equal(fused(), want) and torch.equal(
                N.neighbor_masks_plain(nodes, table, n, k, index), want)):
            raise RuntimeError(f"neighbor_masks differs from the chain or "
                               f"its plain version at {out}")
        fns = {"": fused, **fns}
    for name, fn in fns.items():
        key = f"{name}_ms" if name else "ms"
        out[key] = event_ms(torch, fn)
        out[key.replace("ms", "wall_ms")] = wall_ms(torch, fn)
    out["digest"] = digest(want)
    out["nonzero"] = int((want != 0).sum())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
                    help="checkout whose gatb_core_tpu_torch is timed")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("rank_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from gatb_core_tpu_torch.ops import neighbor_ops as N
    from gatb_core_tpu_torch.ops import rank_search as R

    print(f"rank_sweep: tree {os.path.abspath(args.tree)}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    bad = 0
    for name, table, queries in shapes(torch, N.neighbor_candidates):
        res = measure(torch, R, table, queries)
        bad += bool(res["library_err"])
        print(json.dumps({"shape": name, **res}), flush=True)
        del queries
    for name, table, nodes in mask_shapes(torch):
        res = measure_masks(torch, R, N, table, nodes, 31)
        print(json.dumps({"shape": name, **res}), flush=True)
        del nodes
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

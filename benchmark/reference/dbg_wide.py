"""The count, the de Bruijn graph and its unitigs of a k > 31
configuration, worked out again and compared with what the program gave.

The wide twin of ``dbg.py``: the same comparisons, each the number of
answers that differ (0 in a sound run), over the exact 126-bit keys of
``wide.py`` in place of int64 values, for 1 <= k <= 63. The unitigs are
judged against the graph as ``dbg.check_unitigs`` judges them: every
node in exactly one unitig once, each step inside one the only way out
of its k-mer and the only way into the next, no end extensible; their
k-mer counts, mean abundances and links follow.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import wide as W
from .dbg import _CODE
from .kmers import popcount4, sym_diff as sym_diff_1d

I64 = torch.int64


@dataclass
class Truth:
    """The reference's count and graph of one bank, as (N, 2) keys."""

    k: int
    abundance_min: int
    distinct: torch.Tensor       # every distinct canonical k-mer, ascending
    distinct_counts: torch.Tensor
    windows: int                 # k-mers counted (kmers_nb_valid)
    nodes: torch.Tensor          # the solid ones, ascending
    counts: torch.Tensor
    masks: torch.Tensor          # (N,) uint8 adjacency masks

    @classmethod
    def of(cls, blocks, k: int, abundance_min: int, member=None,
           count=W.count):
        distinct, dcounts, windows = count(blocks, k)
        solid = dcounts >= abundance_min
        nodes, counts = distinct[solid], dcounts[solid]
        return cls(k, abundance_min, distinct, dcounts, windows, nodes,
                   counts, W.masks(nodes, nodes, k, member))


def describe(t: Truth) -> str:
    """The graph's shape as the reference reads it."""
    n = t.nodes.shape[0]
    branch = int(((popcount4(t.masks) != 1)
                  | (popcount4(t.masks >> 4) != 1)).sum())
    top = int(t.counts.max()) if n else 0
    return (f"graph (k {t.k}): {n} nodes, {branch} branching "
            f"({100 * branch / max(n, 1):.3f}%), {t.distinct.shape[0]} "
            f"distinct k-mers, {t.windows} windows, highest count {top}")


def keys_of(limbs, device) -> torch.Tensor:
    return torch.from_numpy(W.limbs_to_keys(limbs)).to(device)


def compare_count(t: Truth, limbs, counts, info: dict) -> dict:
    """The solid k-mers, their counts and the histogram against the
    program's (node rows, counts, and its info's k-mer totals)."""
    dev = t.nodes.device
    v = keys_of(limbs, dev)
    c = torch.as_tensor(np.asarray(counts), device=dev).to(I64)
    order = W.argsort(v)
    v, c = v[order], c[order]
    uv, _ = W.unique(v)
    out = {"solid_kmers_diff": W.sym_diff(uv, t.nodes)
           + int(v.shape[0] - uv.shape[0])}
    r = W.rank(t.nodes, v)
    hit = r >= 0
    out["count_diff"] = int((c[hit] != t.counts[r[hit]]).sum())
    top = int(max(int(c.max()) if c.numel() else 0,
                  int(t.counts.max()) if t.counts.numel() else 0)) + 1
    hp = torch.bincount(c.clamp(min=0), minlength=top)
    hr = torch.bincount(t.counts, minlength=top)
    weak_ref = int((t.distinct_counts < t.abundance_min).sum())
    out["histogram_diff"] = int((hp != hr).sum()) \
        + int(info.get("kmers_nb_weak", -1) != weak_ref) \
        + int(info.get("kmers_nb_distinct", -1) != t.distinct.shape[0])
    out["valid_kmers_diff"] = abs(int(info.get("kmers_nb_valid", -1))
                                  - t.windows)
    return out


def compare_graph(t: Truth, limbs, masks, branching) -> dict:
    """Adjacency masks of every node and the branching nodes."""
    dev = t.nodes.device
    n = t.nodes.shape[0]
    v = keys_of(limbs, dev)
    m = torch.as_tensor(np.asarray(masks), device=dev)
    r = W.rank(t.nodes, v)
    hit = r >= 0
    bad = int((~hit).sum()) + int(n - hit.sum())
    if m.numel() != v.shape[0]:
        bad = max(bad, n)
    else:
        bad += int((m[hit] != t.masks[r[hit]]).sum())
    deg_out, deg_in = popcount4(t.masks), popcount4(t.masks >> 4)
    ref_branch = t.nodes[(deg_out != 1) | (deg_in != 1)]
    b, _ = W.unique(keys_of(branching, dev))
    return {"mask_diff": bad, "branching_diff": W.sym_diff(b, ref_branch)}


def _oriented_degrees(mask: torch.Tensor, strand: torch.Tensor):
    o, i = popcount4(mask), popcount4(mask >> 4)
    rev = strand.bool()
    return torch.where(rev, i, o), torch.where(rev, o, i)


def _pick(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(cond[:, None], a, b)


def check_unitigs(t: Truth, chars: np.ndarray, lengths, kmer_counts,
                  mean_abundance, link_offsets, link_targets) -> dict:
    """The program's unitigs (their bases back to back in ``chars``, their
    ``lengths``) and its per-unitig k-mer counts, mean abundances and
    links (CSR over oriented ids 2u + s, s = 1 the reverse complement)
    against the graph of ``t``."""
    k, dev = t.k, t.nodes.device
    n = t.nodes.shape[0]
    lengths = torch.as_tensor(np.asarray(lengths, np.int64), device=dev)
    u_count = lengths.numel()
    codes = torch.from_numpy(_CODE[np.frombuffer(chars, np.uint8)]) \
        .to(dev)
    out = {"unitig_errors": 0, "unitig_abundance_diff": 0, "link_diff": 0}
    if u_count == 0:
        out["unitig_errors"] = n
        return out
    short = lengths < k
    nk = (lengths - k + 1).clamp(min=0)
    errors = int(short.sum()) + int((codes == 255).sum())
    errors += int(codes.numel() != int(lengths.sum()))
    if errors:
        out["unitig_errors"] = errors + n
        return out
    # oriented key of the k-mer at every position of the concatenation
    c = codes.to(I64)
    p_all = max(c.numel() - k + 1, 0)
    fh = torch.zeros((p_all,), dtype=I64, device=dev)
    fl = torch.zeros_like(fh)
    for i in range(k):
        fh, fl = W._shl2(fh, fl)
        fl = fl | c[i:i + p_all]
    fwd = W.key(fh, fl)
    del fh, fl
    off = torch.cumsum(lengths, 0) - lengths
    kstart = torch.cumsum(nk, 0) - nk
    uid = torch.repeat_interleave(torch.arange(u_count, device=dev), nk)
    pos = torch.arange(uid.numel(), device=dev) - kstart[uid]
    f = fwd[off[uid] + pos]
    del fwd
    rc = W.revcomp(f, k)
    canon = W.minimum(f, rc)
    strand = W.less(rc, f).to(I64)
    r = W.rank(t.nodes, canon)
    del rc, canon
    found = r >= 0
    errors += int((~found).sum())
    occ = torch.bincount(r[found], minlength=n)
    errors += int((occ != 1).sum())
    rr = r.clamp(min=0)
    mask = torch.where(found, t.masks[rr], torch.zeros_like(t.masks[rr]))
    d_out, d_in = _oriented_degrees(mask, strand)
    inner = pos < nk[uid] - 1
    nxt = torch.nonzero(inner).squeeze(1)
    errors += int(((d_out[nxt] != 1) | (d_in[nxt + 1] != 1)).sum())

    # every node's place: unitig, position, oriented key as stored
    node_u = torch.full((n,), -1, dtype=I64, device=dev)
    node_pos = torch.zeros((n,), dtype=I64, device=dev)
    node_val = torch.zeros((n, 2), dtype=I64, device=dev)
    node_u[r[found]] = uid[found]
    node_pos[r[found]] = pos[found]
    node_val[r[found]] = f[found]

    heads = f[kstart]
    tails = f[kstart + nk - 1]

    def step_out(v):
        """(out-degree, the one successor where it is 1) of oriented
        k-mers."""
        succ = torch.zeros_like(v)
        deg = torch.zeros((v.shape[0],), dtype=I64, device=dev)
        for cand in W.successors(v, k):
            hit = W.rank(t.nodes, W.canonical(cand, k)) >= 0
            deg += hit.to(I64)
            succ = _pick(hit, cand, succ)
        return deg, succ

    def in_degree(v):
        cr = W.canonical(v, k)
        rk = W.rank(t.nodes, cr)
        m = torch.where(rk >= 0, t.masks[rk.clamp(min=0)],
                        torch.zeros_like(t.masks[rk.clamp(min=0)]))
        return _oriented_degrees(m, (~W.equal(cr, v)).to(I64))[1]

    for tail, head in ((tails, heads),
                       (W.revcomp(heads, k), W.revcomp(tails, k))):
        deg, succ = step_out(tail)
        stops = (deg != 1) | (in_degree(succ) != 1)
        closes = W.equal(succ, head) | W.equal(succ, W.revcomp(tail, k))
        errors += int((~(stops | closes)).sum())
    kc = torch.as_tensor(np.asarray(kmer_counts), device=dev).to(I64)
    errors += int(kc.numel() != u_count) if kc.numel() != u_count \
        else int((kc != nk).sum())
    out["unitig_errors"] = errors

    # mean abundance: a float64 mean of the integer counts, in float32
    sums = torch.zeros((u_count,), dtype=torch.float64, device=dev)
    sums.index_add_(0, uid[found], t.counts[r[found]].to(torch.float64))
    mean = (sums / nk.clamp(min=1).to(torch.float64)).to(torch.float32)
    ma = torch.as_tensor(np.asarray(mean_abundance, np.float32), device=dev)
    out["unitig_abundance_diff"] = u_count if ma.numel() != u_count \
        else int((ma != mean).sum())

    # links: the last k-mer of oriented a = (u, s) steps into the first of
    # oriented b: the node at the head of v in its stored sense (b = 2v),
    # or at the tail of v in the other sense (b = 2v + 1)
    last = torch.cat([tails, W.revcomp(heads, k)])
    src_ids = torch.cat([2 * torch.arange(u_count, device=dev),
                         2 * torch.arange(u_count, device=dev) + 1])
    src, dst = [], []
    for cand in W.successors(last, k):
        rk = W.rank(t.nodes, W.canonical(cand, k))
        hit = rk >= 0
        rk = rk.clamp(min=0)
        v, q, sv = node_u[rk], node_pos[rk], node_val[rk]
        same = W.equal(cand, sv)
        into_head = hit & same & (q == 0)
        into_tail = hit & ~same & (q == nk[v.clamp(min=0)] - 1)
        src += [src_ids[into_head], src_ids[into_tail]]
        dst += [2 * v[into_head], 2 * v[into_tail] + 1]
    ref_links = torch.unique(torch.cat(src) * (2 * u_count) + torch.cat(dst))
    offs = torch.as_tensor(np.asarray(link_offsets, np.int64), device=dev)
    tg = torch.as_tensor(np.asarray(link_targets, np.int64), device=dev)
    if offs.numel() != 2 * u_count + 1 or int(offs[-1]) != tg.numel():
        out["link_diff"] = ref_links.numel() + tg.numel()
        return out
    psrc = torch.repeat_interleave(torch.arange(2 * u_count, device=dev),
                                   offs[1:] - offs[:-1])
    pl = psrc * (2 * u_count) + tg
    upl = torch.unique(pl)
    out["link_diff"] = sym_diff_1d(upl, ref_links) \
        + int(pl.numel() - upl.numel())
    return out


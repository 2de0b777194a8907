"""Device-side k-mer extraction: rolling canonical k-mers + minimizers.

Port of gatb_core_tpu/ops/kmer_ops.py (plus ``revcomp_limbs`` from its
ops/neighbor_ops.py). K-mers are arrays of uint32 *limbs* in big-endian
limb order (most-significant limb first), ``W = ceil(2k/32)`` limbs per
k-mer, so lexicographic comparison over the limb axis equals integer
comparison of the 2k-bit value (gatb-core's LargeInt order).

torch has no unsigned 32-bit shifts or comparisons, so every function here
computes in int64 tensors holding zero-extended uint32 values and returns
int64 limbs; ``kmers_to_py``/``py_to_limbs`` and the tests convert at the
numpy boundary. Inputs may be any integer dtype: int32 is read as raw
32-bit storage. Every function runs on the device of its inputs.

Semantics matched bit-for-bit with gatb-core:
  - rolling forward update  v = ((v << 2) + c) & mask     (Model.hpp:824)
  - rolling revcomp update  r = (r >> 2) + rc(c)<<2(k-1)  (Model.hpp:936-944)
  - canonical = min(fwd, rev) as integers                 (Model.hpp:218-295)
  - k-mer valid iff its k nucleotides are all valid       (Model.hpp:725-770)
  - minimizer = min over m-mer windows of LUT(mmer) where
    LUT(x) = canon(x) if allowed else 4^m-1               (Model.hpp:1040-1065)

The JAX package splits extraction batches above ``_MAX_EXTRACT_ROWS``
rows to dodge an XLA:TPU miscompile; that split is not carried over.

``extract_planes`` is the count's extraction as the sort takes it: the
canonical limbs of every window of a superbatch, the pass filter and the
all-ones encoding of dropped windows, written into (W, cap) int32 planes.
For a CUDA tensor it is one launch of the hand-written kernel of
``csrc/kmer_extract.cu``, counted in ``launches``; for a CPU tensor it runs
``extract_planes_plain``, the functions above in steps of
``EXTRACT_ROWS`` windows; any other device raises. Nothing falls back from
the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .bitpack import M32, as_u32_i64, mmer_allowed, revcomp_u32

I64 = torch.int64
I32 = torch.int32
# windows extract_planes_plain extracts per step: bounds its temporaries (a
# few hundred MB), as lax.map over batches does in JAX
EXTRACT_ROWS = 1 << 22
# limbs the extraction kernel takes (k <= 128)
KERNEL_MAX_LIMBS = 8

# launches of the extraction kernel (CUDA tensors only), and the distinct
# (k, L, reads, words a read, validity words a read or 0, cap, m, nb_passes)
# they launched with
launches = {"extract_planes": 0}
launch_shapes: dict[str, set] = {"extract_planes": set()}


def reset_launches() -> None:
    launches["extract_planes"] = 0
    launch_shapes["extract_planes"].clear()


def nb_limbs(k: int) -> int:
    """Number of uint32 limbs for a k-mer (ceil(2k/32))."""
    return (2 * k + 31) // 32


def top_mask(k: int) -> int:
    bits = (2 * k) % 32
    return 0xFFFFFFFF if bits == 0 else (1 << bits) - 1


def lex_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the last (limb) axis. Big-endian limbs,
    int64 zero-extended values."""
    w = a.shape[-1]
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for j in range(w):
        aj, bj = a[..., j], b[..., j]
        lt = lt | (eq & (aj < bj))
        eq = eq & (aj == bj)
    return lt


def lex_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)


class KmerBatch(NamedTuple):
    """Extracted canonical k-mers for a padded batch of reads.

    kmers: (B, P, W) int64 canonical k-mer limbs (garbage where invalid)
    valid: (B, P) bool — True iff all k bases of the window are ACGT and the
           window lies inside the read (P = L - k + 1 window positions)
    minimizer: (B, P) int64 — LUT-mapped minimizer value of each k-mer
           (4^m - 1 when every m-mer of the window is banned)
    """

    kmers: torch.Tensor
    valid: torch.Tensor
    minimizer: torch.Tensor | None


def _window_validity(valid: torch.Tensor, lengths: torch.Tensor, k: int,
                     P: int) -> torch.Tensor:
    """(B, P) bool: all k bases valid and the window inside the read."""
    B = valid.shape[0]
    pos = torch.arange(P, device=valid.device)[None, :]
    inside = pos + k <= lengths.to(I64)[:, None]
    inval = (~valid).to(torch.int32)
    cum = torch.cumsum(inval, dim=1, dtype=torch.int32)
    cum = torch.cat([torch.zeros((B, 1), dtype=torch.int32,
                                 device=valid.device), cum], dim=1)
    window_bad = cum[:, k:k + P] - cum[:, :P]
    return (window_bad == 0) & inside


def extract_kmers(codes: torch.Tensor, valid: torch.Tensor,
                  lengths: torch.Tensor, k: int, m: int = 10,
                  freq_order: torch.Tensor | None = None,
                  with_minimizers: bool = True) -> KmerBatch:
    """Extract canonical k-mers + minimizers from a padded code batch.

    codes:   (B, L) integer 2-bit codes (padding may be any value)
    valid:   (B, L) bool per-character validity (padding must be False)
    lengths: (B,) true read lengths

    Codes are packed 16-per-uint32 and each window's limbs are
    funnel-shifted out of the packed stream, grouped by the 16 possible
    bit offsets; reverse complements come from the vectorized revcomp of
    the forward limbs. No loop-carried dependency.
    """
    B, L = codes.shape
    if L < k:
        raise ValueError(f"padded length {L} < k={k}")
    P = L - k + 1
    codes = codes.to(I64)
    fwds = _window_limbs(codes, k)  # (B, P, W)
    revs = revcomp_limbs_(fwds, k)
    canon = torch.where(lex_lt(fwds, revs)[..., None], fwds, revs)
    kvalid = _window_validity(valid.to(torch.bool), lengths, k, P)
    minim = _minimizers(codes, k, m, freq_order) if with_minimizers \
        else None
    return KmerBatch(canon, kvalid, minim)


def extract_kmers_packed(words: torch.Tensor, vmask: torch.Tensor | None,
                         lengths: torch.Tensor, k: int, L: int, m: int = 10,
                         freq_order: torch.Tensor | None = None,
                         with_minimizers: bool = True) -> KmerBatch:
    """extract_kmers over the packed transfer format (pack_words/
    pack_valid): words (B, ceil(L/16)) uint32 patterns, vmask
    (B, ceil(L/32)).

    The limb extraction consumes the packed words directly (they ARE the
    internal stream _window_limbs builds), so byte codes are materialized
    only when minimizers are requested.

    ``vmask=None`` declares every in-length base valid (the dense
    transfer mode): window validity reduces to the in-read position
    check."""
    B = words.shape[0]
    if L < k:
        raise ValueError(f"padded length {L} < k={k}")
    P = L - k + 1
    words = as_u32_i64(words)
    fwds = _window_limbs_from_words(words, L, k)
    revs = revcomp_limbs_(fwds, k)
    canon = torch.where(lex_lt(fwds, revs)[..., None], fwds, revs)
    if vmask is None:        # dense mode: in-length bases are all valid
        pos = torch.arange(P, device=words.device)[None, :]
        kvalid = pos + k <= lengths.to(I64)[:, None]
    else:
        kvalid = _window_validity(unpack_valid(vmask, L), lengths, k, P)
    minim = _minimizers(unpack_codes(words, L).to(I64), k, m, freq_order) \
        if with_minimizers else None
    return KmerBatch(canon, kvalid, minim)


def _shifts(step: int, n: int, top: int, device) -> torch.Tensor:
    return (top - step * torch.arange(n, dtype=I64, device=device))[
        None, None, :]


def pack_words(codes: torch.Tensor) -> torch.Tensor:
    """Pack (B, L) 2-bit codes 16-per-uint32, first code in the MSBs.
    Returns (B, ceil(L/16)) int64."""
    B, L = codes.shape
    pad = (-L) % 16
    c = codes.to(I64)
    if pad:
        c = torch.cat([c, torch.zeros((B, pad), dtype=I64,
                                      device=c.device)], dim=1)
    return (c.reshape(B, -1, 16) << _shifts(2, 16, 30, c.device)).sum(dim=2)


def pack_valid(valid: torch.Tensor) -> torch.Tensor:
    """Pack (B, L) validity bools 32-per-uint32, first position at bit 31.
    Returns (B, ceil(L/32)) int64."""
    B, L = valid.shape
    pad = (-L) % 32
    v = valid.to(I64)
    if pad:
        v = torch.cat([v, torch.zeros((B, pad), dtype=I64,
                                      device=v.device)], dim=1)
    return (v.reshape(B, -1, 32) << _shifts(1, 32, 31, v.device)).sum(dim=2)


def unpack_valid(vmask: torch.Tensor, L: int) -> torch.Tensor:
    """(B, ceil(L/32)) uint32 patterns -> (B, L) bool (inverse of
    pack_valid)."""
    vm = as_u32_i64(vmask)
    B = vm.shape[0]
    bits = (vm[:, :, None] >> _shifts(1, 32, 31, vm.device)) & 1
    return bits.reshape(B, -1)[:, :L] != 0


def unpack_codes(words: torch.Tensor, L: int) -> torch.Tensor:
    """(B, ceil(L/16)) uint32 patterns -> (B, L) uint8 codes (inverse of
    pack_words)."""
    pw = as_u32_i64(words)
    B = pw.shape[0]
    c = (pw[:, :, None] >> _shifts(2, 16, 30, pw.device)) & 3
    return c.reshape(B, -1)[:, :L].to(torch.uint8)


def _window_limbs(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Forward k-mer limbs for every window position, scan-free.

    Packs codes 16-per-uint32 (first code in the MSBs), then extracts each
    limb as 32 bits at stream offset ``2*i + 2k - 32*(W-j)`` via funnel
    shifts, vectorized over the 16 offset classes of window positions.
    """
    return _window_limbs_from_words(pack_words(codes), codes.shape[1], k)


def _window_limbs_from_words(pw0: torch.Tensor, L: int,
                             k: int) -> torch.Tensor:
    """Forward k-mer limbs for every window from packed 16-code words:
    (B, P, W) int64."""
    pw0 = as_u32_i64(pw0)
    B = pw0.shape[0]
    w = nb_limbs(k)
    P = L - k + 1
    # number of 16-code words needed, padded so every extract stays in range
    nq_out = (P + 15) // 16
    n_words = (L + 15) // 16 + w + 1
    pad_w = n_words - pw0.shape[1]
    pw = pw0 if pad_w <= 0 else torch.cat(
        [pw0, torch.zeros((B, pad_w), dtype=I64, device=pw0.device)], dim=1)

    def extract32(word_idx_base: int, bit: int, nq: int):
        """32 bits at stream offset 32*word_idx_base + bit for nq starts."""
        a = pw[:, word_idx_base:word_idx_base + nq]
        if bit == 0:
            return a
        b = pw[:, word_idx_base + 1:word_idx_base + 1 + nq]
        return ((a << bit) & M32) | (b >> (32 - bit))

    top_bits = 2 * k - 32 * (w - 1)  # significant bits in limb 0 (1..32)
    mask0 = top_mask(k)
    allw = torch.empty((B, nq_out, 16, w), dtype=I64, device=pw.device)
    for o in range(16):
        for j in range(w):
            # stream offset of limb j for window start i=16q+o:
            #   2i + 2k - 32*(w - j)  (negative part masked for j=0)
            off = 2 * o + 2 * k - 32 * (w - j)
            if off >= 0:
                e = extract32(off // 32, off % 32, nq_out)
            else:
                # limb 0 with 2k < 32w: take bits starting at 2o, shifted
                # right so the value is right-aligned in the limb
                e = extract32((2 * o) // 32, (2 * o) % 32, nq_out) \
                    >> (32 - top_bits)
            if j == 0:
                e = e & mask0
            allw[:, :, o, j] = e
    # interleave: arr[b, q, o, w] -> position 16q + o
    return allw.reshape(B, nq_out * 16, w)[:, :P]


def revcomp_limbs_(limbs: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of (..., W) big-endian limb k-mers (int64)."""
    w = limbs.shape[-1]
    # 1) reverse 2-bit fields within each limb + complement
    x = limbs
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    x = (((x >> 16) | (x << 16)) & M32) ^ 0xAAAAAAAA
    # 2) reverse limb order: the 32W-bit word is now the pair-reversed
    #    complement, i.e. rc << (32W - 2k)
    x = x.flip(-1)
    # 3) shift right by the slack (static, < 32)
    s = 32 * w - 2 * k
    if s:
        lo = x >> s
        hi = torch.zeros_like(lo)
        hi[..., 1:] = (x[..., :-1] << (32 - s)) & M32
        x = hi | lo
    return x


def _minimizers(codes: torch.Tensor, k: int, m: int,
                freq_order: torch.Tensor | None = None) -> torch.Tensor:
    """Per-kmer minimizer values (windowed min of LUT-mapped m-mers).

    With ``freq_order`` ((4^m,) frequency ranks), minimizers are chosen by
    (rank, value) order and the banned-AA rule is disabled
    (ComparatorMinimizerFrequencyOrLex, Model.hpp:911-980).
    """
    B, L = codes.shape
    P = L - k + 1
    nmm = L - m + 1
    codes = codes.to(I64)
    # m-mer value at each position: polynomial of m consecutive codes.
    mm = torch.zeros((B, nmm), dtype=I64, device=codes.device)
    for i in range(m):
        mm = ((mm << 2) & M32) | codes[:, i:i + nmm]
    # LUT semantics (Model.hpp:1040-1065): canonicalize then ban.
    canon = torch.minimum(mm, revcomp_u32(mm, m))
    nwin = k - m + 1
    if freq_order is None:
        mask_m = (1 << (2 * m)) - 1
        lutv = torch.where(mmer_allowed(canon, m), canon,
                           torch.full_like(canon, mask_m))
        # windowed min over the k-m+1 m-mers of each k-mer window
        return lutv[:, :P + nwin - 1].unfold(1, nwin, 1).amin(dim=-1)
    ranks = as_u32_i64(freq_order.to(codes.device))[canon]
    best_r = ranks[:, 0:P]
    best_v = canon[:, 0:P]
    for i in range(1, nwin):
        r = ranks[:, i:i + P]
        v = canon[:, i:i + P]
        better = (r < best_r) | ((r == best_r) & (v < best_v))
        best_r = torch.where(better, r, best_r)
        best_v = torch.where(better, v, best_v)
    return best_v


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at the first launch, never at import)."""
    from ._build import load_cuda

    lib = load_cuda("kmer_extract")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.extract_planes.argtypes = [vp, i, vp, i, vp, vp, vp, vp, ll, ll, i,
                                   i, i, i, i, vp]
    lib.extract_planes.restype = ctypes.c_int
    return lib


def _as_words(x: torch.Tensor) -> torch.Tensor:
    """(R, n) uint32 patterns in int32 storage or zero-extended int64 ->
    contiguous int32 storage."""
    return x.to(I32).contiguous()


def extract_planes(words: torch.Tensor, vmask: torch.Tensor | None,
                   lengths: torch.Tensor, k: int, L: int, cap: int,
                   m: int = 10, nb_passes: int = 1, pass_i: int = 0):
    """The windows of R packed reads as the sort's limb planes.

    words: (R, >= ceil(L/16)) packed words (pack_words layout, int32
    storage or zero-extended int64); vmask: (R, >= ceil(L/32)) validity
    bits (pack_valid layout) or None (dense mode: every base inside the
    read is valid); lengths: (R,). Window p of read r (P = L - k + 1 a
    read) is row r * P + p of ``cap`` >= R * P rows. Returns (planes (W,
    cap) int32: the canonical limbs of the kept windows, all-ones on the
    others and on the rows past R * P; keep (cap,) bool; n_keep () int32
    kept windows; n_valid () int64 valid windows before the pass filter).
    With nb_passes > 1 a valid window is kept when its minimizer (the
    lexicographic one, ``_minimizers`` without ``freq_order``) modulo
    nb_passes is pass_i (SortingCountAlgorithm.cpp:806).

    For a CUDA tensor: one launch of the kernel (W <= 8, k >= m); for a
    CPU tensor: ``extract_planes_plain``."""
    r = words.shape[0]
    if L < k:
        raise ValueError(f"padded length {L} < k={k}")
    if r * (L - k + 1) > cap:
        raise ValueError(f"extract_planes: {r} reads of {L - k + 1} windows "
                         f"exceed {cap} rows")
    if words.device.type == "cpu":
        return extract_planes_plain(words, vmask, lengths, k, L, cap, m,
                                    nb_passes, pass_i)
    if not words.is_cuda:
        raise ValueError(f"extract_planes: unsupported device {words.device}")
    w = nb_limbs(k)
    if w > KERNEL_MAX_LIMBS:
        raise ValueError(f"extract_planes: k={k} takes {w} limbs, the kernel "
                         f"at most {KERNEL_MAX_LIMBS}")
    if nb_passes > 1 and not 2 <= m <= min(16, k):
        raise ValueError(f"extract_planes: minimizer size {m} outside "
                         f"2..min(16, k={k})")
    if cap >= 1 << 31:
        raise ValueError("extract_planes: rows are counted in int32")
    if words.shape[1] < (L + 15) // 16 or (
            vmask is not None and vmask.shape[1] < (L + 31) // 32):
        raise ValueError("extract_planes: fewer words than L bases take")
    dev = words.device
    words = _as_words(words)
    vmask = None if vmask is None else _as_words(vmask)
    lengths = lengths.to(I32).contiguous()
    if lengths.shape != (r,) or (vmask is not None and vmask.shape[0] != r):
        raise ValueError("extract_planes: words, vmask and lengths differ "
                         "in reads")
    planes = torch.empty((w, cap), dtype=I32, device=dev)
    keep = torch.empty((cap,), dtype=torch.bool, device=dev)
    counters = torch.zeros((2,), dtype=I64, device=dev)
    P = L - k + 1
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = _lib().extract_planes(
            words.data_ptr(), words.shape[1],
            None if vmask is None else vmask.data_ptr(),
            0 if vmask is None else vmask.shape[1], lengths.data_ptr(),
            planes.data_ptr(), keep.data_ptr(), counters.data_ptr(), r * P,
            cap, P, k, m, nb_passes, pass_i, stream)
    if rc != 0:
        raise RuntimeError(f"extract_planes: CUDA launch failed with error "
                           f"{rc}")
    launches["extract_planes"] += 1
    launch_shapes["extract_planes"].add(
        (k, L, r, words.shape[1], 0 if vmask is None else vmask.shape[1],
         cap, m if nb_passes > 1 else 0, nb_passes))
    # n_keep: the low word of the first 64-bit counter (a view, no copy)
    return planes, keep, counters.view(I32)[0], counters[1]


def extract_planes_plain(words: torch.Tensor, vmask: torch.Tensor | None,
                         lengths: torch.Tensor, k: int, L: int, cap: int,
                         m: int = 10, nb_passes: int = 1, pass_i: int = 0):
    """Plain version of ``extract_planes`` on any device, torch ops only:
    ``extract_kmers_packed``, the pass filter and the all-ones encoding in
    steps of at most EXTRACT_ROWS windows."""
    w = nb_limbs(k)
    r = words.shape[0]
    P = L - k + 1
    dev = words.device
    planes = torch.full((w, cap), -1, dtype=I32, device=dev)
    keep = torch.zeros((cap,), dtype=torch.bool, device=dev)
    n_keep = torch.zeros((), dtype=I64, device=dev)
    n_valid = torch.zeros((), dtype=I64, device=dev)
    step = max(1, EXTRACT_ROWS // P)
    for r0 in range(0, r, step):
        r1 = min(r, r0 + step)
        kb = extract_kmers_packed(
            words[r0:r1], None if vmask is None else vmask[r0:r1],
            lengths[r0:r1], k, L, m, with_minimizers=nb_passes > 1)
        pv = kb.valid
        if nb_passes > 1:
            # reference pass filter (SortingCountAlgorithm.cpp:806)
            pv = pv & (kb.minimizer % nb_passes == pass_i)
        n_valid += kb.valid.sum()
        n_keep += pv.sum()
        flat = kb.kmers.reshape(-1, w)
        enc = torch.where(pv.reshape(-1, 1), flat,
                          torch.full_like(flat, M32))
        planes[:, r0 * P:r1 * P] = enc.T.to(I32)
        keep[r0 * P:r1 * P] = pv.reshape(-1)
    return planes, keep, n_keep.to(I32), n_valid


def kmers_to_py(limbs) -> list[int]:
    """Convert (N, W) uint32 limb array to Python ints (host/debug)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    limbs = np.asarray(limbs).astype(np.uint64) & np.uint64(M32)
    n, w = limbs.shape
    out = np.zeros(n, dtype=object)
    for j in range(w):
        out = (out * (1 << 32)) + limbs[:, j]
    return list(out)


def py_to_limbs(values, k: int):
    """Convert iterable of Python ints to (N, W) uint32 limb array."""
    w = nb_limbs(k)
    vals = list(values)
    out = np.zeros((len(vals), w), dtype=np.uint32)
    for i, v in enumerate(vals):
        for j in range(w - 1, -1, -1):
            out[i, j] = v & 0xFFFFFFFF
            v >>= 32
    return out

"""The count's native fill (``native/fastx.cpp``): the in-place record
scan, the word-at-a-time pack and the call that fills a superbatch of
batches.

- ``NativeBatcher``'s batches, packed (one batch a call and three) and as
  bytes (one and three), byte for byte equal to the port's own Python
  parser through ``_BatchBuilder`` and ``pack_batch_np``, and to JAX's
  ``NativeBatcher``; ``stats_full()`` equal to both; on CRLF line ends,
  lower case, N and IUPAC bytes, empty sequences, reads of exactly L,
  L+1 and over 2L bases (split with k-1 overlap), multi-line FASTA,
  ``.gz``, a last record with no newline, plain FASTQ and FASTA files a
  few MB larger than the scan buffer, so that records cross a refill
  (one with a CR as the first buffer's last byte), and a FASTQ and a
  FASTA sequence line longer than the scan buffer (the FASTA one's CR
  the last byte of a full buffer);
- the count span's ``parse_bytes`` (the plain file's size) and
  ``parse_carried`` (0 on short reads; the reads longer than a row, and
  every FASTA record);
- the pack and the byte coding on every byte value a line can hold,
  against ``ascii_to_codes_np`` and ``pack_batch_np``.
"""

import gzip

import numpy as np
import pytest

from gatb_core_tpu import native as jnative
from gatb_core_tpu_torch import CountConfig, SortingCount
from gatb_core_tpu_torch import native as tnative
from gatb_core_tpu_torch.bank.fasta import BankFasta
from gatb_core_tpu_torch.kmer.counting import _BatchBuilder
from gatb_core_tpu_torch.misc import time_info as T
from gatb_core_tpu_torch.ops.bitpack import ascii_to_codes_np, pack_batch_np

K, B, L = 15, 8, 64   # L: the row, 4 code words and 2 validity words
SCAN_BUF = 1 << 22    # native/fastx.cpp's kScanBuf

pytestmark = pytest.mark.skipif(
    not (tnative.available() and jnative.available()),
    reason="no C++ toolchain for the native parser")


def _rng_seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), size=n))


def _bases(rng, n):
    return np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=n)].tobytes().decode()


def _fastq(seqs, nl="\n"):
    return "".join(f"@r{i} x{nl}{s}{nl}+{nl}{'I' * len(s)}{nl}"
                   for i, s in enumerate(seqs))


def _case(name, rng):
    """(file name, text) of one case."""
    short = [_rng_seq(rng, n) for n in (5, 40, 63, 31, 17, 50)]
    if name == "crlf":
        return "r.fq", _fastq(short, "\r\n")
    if name == "lowercase":
        return "r.fq", _fastq([s.lower() for s in short[:3]] + short[3:])
    if name == "n_iupac":
        return "r.fq", _fastq([_rng_seq(rng, 60, "ACGTNRYKMSWBDHV")
                               for _ in range(9)] + ["NNNN", "acgtn"])
    if name == "empty_seq":
        seqs = short[:2] + [""] + short[2:4] + [""] + short[4:]
        return "r.fa", "".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs))
    if name == "lengths_l":
        seqs = [_rng_seq(rng, n) for n in (L, L + 1, 2 * L + 7, 5 * L + 3,
                                           L - 1, 2 * L, 16, 32, 33)]
        return "r.fq", _fastq(seqs)
    if name == "multiline_fasta":
        seqs = [_rng_seq(rng, n, "ACGTN") for n in (200, 7, 64, 90, 300)]
        return "r.fa", "".join(
            f">s{i} c\n" + "".join(s[j:j + 60] + "\n"
                                   for j in range(0, len(s), 60))
            for i, s in enumerate(seqs))
    if name == "gz":
        return "r.fq.gz", _fastq(short + [_rng_seq(rng, 150)] * 3)
    if name == "no_final_newline":
        return "r.fq", _fastq(short).rstrip("\n")
    if name == "past_buffer":
        # 6 MB of 150 bp reads: records cross the 4 MiB scan buffer's end
        g = _rng_seq(rng, 40_000, "ACGT")
        starts = rng.integers(0, len(g) - 150, size=19_000)
        seqs = [g[s:s + 150] for s in starts]
        seqs[7_000] = seqs[7_000][:70] + "N" + seqs[7_000][71:]
        return "r.fq", _fastq(seqs)
    if name == "fasta_past_buffer":
        # 6 MB of one-line CRLF records; the read whose CR is the first
        # buffer's last byte is padded to it by its header
        g = _bases(rng, 40_000)
        starts = iter(rng.integers(0, len(g) - 150, size=40_000))
        recs, size = [], 0
        while size < 6_000_000:
            s = int(next(starts))
            head = f">s{len(recs)}"
            if size < SCAN_BUF <= size + 400:
                head += "x" * (SCAN_BUF - 1 - size - len(head) - 2 - 150)
            recs.append(f"{head}\r\n{g[s:s + 150]}\r\n")
            size += len(recs[-1])
        return "r.fa", "".join(recs)
    if name == "fastq_long_line":
        # sequence and quality lines longer than the scan buffer
        seq = _bases(rng, SCAN_BUF + 300_000)
        seq = seq[:5_000] + "NNRY" + seq[5_004:]
        return "r.fq", _fastq([_rng_seq(rng, 40), seq, _rng_seq(rng, 90)])
    if name == "fasta_long_line":
        # a line that fills the buffer up to its CR, the LF past it
        return "r.fa", (f">s0\n{_bases(rng, SCAN_BUF - 1)}\r\n"
                        f">s1\r\n{_rng_seq(rng, 70)}\r\n")
    raise ValueError(name)


CASES = ["crlf", "lowercase", "n_iupac", "empty_seq", "lengths_l",
         "multiline_fasta", "gz", "no_final_newline", "past_buffer",
         "fasta_past_buffer", "fastq_long_line", "fasta_long_line"]


def _write(tmp_path, fname, text):
    path = tmp_path / fname
    if fname.endswith(".gz"):
        with gzip.open(path, "wt", newline="") as f:
            f.write(text)
    else:
        path.write_bytes(text.encode())
    return str(path)


def _python_batches(path):
    """The port's Python parser through _BatchBuilder: (codes, valid,
    lengths, rows) batches and the BankStats block."""
    builder = _BatchBuilder(K, B, L)
    out, lens = [], []
    for seq in BankFasta(path):
        lens.append(len(seq.data))
        out += builder.add(seq.data)
    if builder.row:
        out.append(builder.flush())
    n = np.array(lens, np.int64)
    stats = (len(n), int(n.sum()), int(n.min()) if len(n) else 0,
             int(n.max()) if len(n) else 0, float((n * n).sum()))
    return out, stats


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[3] == w[3]
        for a, b in zip(g[:3], w[:3]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_native_fill_byte_equal(tmp_path, case):
    rng = np.random.default_rng(CASES.index(case))
    path = _write(tmp_path, *_case(case, rng))
    ref, ref_stats = _python_batches(path)
    ref_packed = [(*pack_batch_np(c, v), n, r) for c, v, n, r in ref]

    def port(packed, group):
        nat = tnative.NativeBatcher(path, K, B, L)
        got = list(nat.batches(packed, group))
        assert nat.stats_full() == ref_stats
        return got

    for group in (1, 3):
        _equal(port(True, group), ref_packed)
        _equal(port(False, group), ref)
    _equal(list(tnative.NativeBatcher(path, K, B, L).iter_packed()),
           ref_packed)
    _equal(list(tnative.NativeBatcher(path, K, B, L)), ref)

    jnat = jnative.NativeBatcher(path, K, B, L)
    _equal(port(True, 3), list(jnat.iter_packed()))
    assert jnat.stats_full() == ref_stats
    _equal(port(False, 2), list(jnative.NativeBatcher(path, K, B, L)))


def _count_span(path, **kw):
    T.clear_spans()
    with T.recording():
        SortingCount(CountConfig(kmer_size=K, abundance_min=1,
                                 batch_reads=B, batch_len=L,
                                 superbatch_rows=1 << 13, device="cpu",
                                 **kw)).run(path)
    (count,) = [sp for sp in T.spans() if sp.name == "count"]
    T.clear_spans()
    return count.counts


@pytest.mark.parametrize("case,carried", [
    ("short_fastq", 0), ("long_reads", 2), ("multiline_fasta", 5)])
def test_parse_counters(tmp_path, case, carried):
    rng = np.random.default_rng(5)
    if case == "short_fastq":
        fname, text = "r.fq", _fastq([_rng_seq(rng, 50) for _ in range(40)])
    elif case == "long_reads":
        fname, text = "r.fq", _fastq([_rng_seq(rng, n)
                                      for n in (30, 3 * L, 40, L + 1, L)])
    else:
        # every sequence fits a row, and every FASTA record is copied
        seqs = [_rng_seq(rng, n) for n in (50, 7, L, 20, 21)]
        fname, text = "r.fa", "".join(
            f">s{i}\n" + "".join(s[j:j + 20] + "\n"
                                 for j in range(0, len(s), 20))
            for i, s in enumerate(seqs))
    path = _write(tmp_path, fname, text)
    counts = _count_span(path)
    assert counts["parse_bytes"] == len(text.encode())
    assert counts["parse_carried"] == carried
    nat = tnative.NativeBatcher(path, K, B, L)
    for _ in nat.batches(True, 2):
        pass
    assert nat.parse_counters() == (counts["parse_bytes"],
                                    counts["parse_carried"])


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_pack_every_byte(tmp_path, fmt):
    rng = np.random.default_rng(7)
    n = 700
    rows = rng.integers(0, 256, size=(n, L), dtype=np.uint8)
    # every byte value first in a row, and rows of mostly ACGTacgt
    rows[:256, 0] = np.arange(256)
    rows[256:600] = np.frombuffer(b"ACGTacgtN", np.uint8)[
        rng.integers(0, 9, size=(344, L))]
    lengths = rng.integers(0, L + 1, size=n)
    lengths[:40] = np.arange(40)
    lengths[:256] = np.maximum(lengths[:256], 1)
    # a line holds no LF, ends in no CR, and a FASTA line starts with no '>'
    rows[rows == ord("\n")] = ord("A")
    last = np.arange(n), np.maximum(lengths - 1, 0)
    rows[last] = np.where(rows[last] == ord("\r"), ord("A"), rows[last])
    if fmt == "fasta":
        rows[:, 0][rows[:, 0] == ord(">")] = ord("A")
    lines = [rows[i, :lengths[i]].tobytes() for i in range(n)]
    if fmt == "fastq":
        text = b"".join(b"@r\n" + x + b"\n+\n" + b"I" * len(x) + b"\n"
                        for x in lines)
    else:
        text = b"".join(b">r\n" + x + b"\n" for x in lines)
    path = tmp_path / f"r.{fmt}"
    path.write_bytes(text)

    codes, valid = ascii_to_codes_np(rows)
    live = np.arange(L)[None, :] < lengths[:, None]
    codes, valid = codes * live, valid & live
    pad = (-n) % B
    codes, valid = (np.concatenate([a, np.zeros((pad, L), a.dtype)])
                    for a in (codes, valid))
    lens = np.concatenate([lengths, np.zeros(pad, int)]).astype(np.int32)
    want = [(codes[i:i + B], valid[i:i + B], lens[i:i + B],
             min(B, n - i)) for i in range(0, n, B)]
    want_packed = [(*pack_batch_np(c, v), ln, r) for c, v, ln, r in want]
    _equal(list(tnative.NativeBatcher(str(path), K, B, L).batches(True, 4)),
           want_packed)
    _equal(list(tnative.NativeBatcher(str(path), K, B, L).batches(False, 4)),
           want)

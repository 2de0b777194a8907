// Native host runtime: FASTA/FASTQ(.gz) reader + 2-bit encoder + batcher.
//
// Native counterpart of gatb-core's BankFasta parser
// (bank/impl/BankFasta.cpp:42,395 — zlib gzread) fused with the device
// batch builder: instead of producing Sequence objects, it fills
// fixed-shape (B, L) code/validity/length batches ready for host->device
// transfer, splitting long reads into (k-1)-overlap pieces exactly like
// kmer/counting.py _BatchBuilder (itself mirroring the reference's
// streaming superkmer split, Sequence2SuperKmer.hpp:139-155).
//
// The reader scans records in place: one large buffer filled by gzread
// (zlib reads plain files as they are), line ends found with memchr, the
// header, '+' and quality lines skipped without a copy, and a FASTQ
// sequence line handed to the packer as a view of the buffer. A record
// that runs past the end of the buffer moves the unread tail to the front
// before the refill. A FASTA sequence (its lines joined), a line longer
// than the buffer and a sequence longer than a row (split into pieces
// from a copy of its own) are copied.
//
// The packer takes 8 bytes a load, 16 bases a code word: a SWAR gather of
// (c >> 1) & 3 and a SWAR compare against ACGTacgt, in portable C++ (the
// library is built for the baseline ISA).
//
// Exposed as a plain C ABI consumed via ctypes (gatb_core_tpu_torch/native/__init__.py).
// Encoding: A=0 C=1 T=2 G=3 (IModel.hpp:73-84), case-insensitive; every
// other byte is an invalid position (ConvertASCII semantics, misc/api/Data.hpp).

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the packer reads bytes little-endian");

namespace {

constexpr size_t kScanBuf = size_t(1) << 22;  // 4 MiB scan buffer

// ---------------------------------------------------------------------------
// packing: 8 bytes a step
// ---------------------------------------------------------------------------

constexpr uint64_t kOnes = 0x0101010101010101ULL;
constexpr uint64_t kLow7 = 0x7F7F7F7F7F7F7F7FULL;

inline uint64_t load8(const unsigned char* p) {
  uint64_t x;
  std::memcpy(&x, p, 8);
  return x;
}

// up to 8 bytes, the rest zero (a zero byte is code 0 and invalid)
inline uint64_t load_upto8(const unsigned char* p, size_t r) {
  if (r >= 8) return load8(p);
  uint64_t x = 0;
  std::memcpy(&x, p, r);
  return x;
}

// 0x80 in each byte that is zero, exactly (no carry crosses a byte)
inline uint64_t zero_bytes(uint64_t z) {
  return ~(((z & kLow7) + kLow7) | z) & ~kLow7;
}

// 0x80 in each byte that is one of ACGTacgt: clearing bit 5 folds the
// lower case onto the upper, and only ACGTacgt fold onto ACGT
inline uint64_t acgt_bytes(uint64_t x) {
  const uint64_t y = x & (0xDF * kOnes);
  return zero_bytes(y ^ (0x41 * kOnes)) | zero_bytes(y ^ (0x43 * kOnes)) |
         zero_bytes(y ^ (0x47 * kOnes)) | zero_bytes(y ^ (0x54 * kOnes));
}

// u: 8 bytes with the first base in the top byte (a byte-swapped load).
// codes16: (c >> 1) & 3 of each byte, 16 bits, the first base in bits
// 15-14. flags8: the validity of each byte, 8 bits, the first base in
// bit 7.
inline uint32_t codes16(uint64_t u) {
  uint64_t t = (u >> 1) & (3 * kOnes);
  t = (t | (t >> 6)) & 0x000F000F000F000FULL;   // 4 bits a 16-bit lane
  t = (t | (t >> 12)) & 0x000000FF000000FFULL;  // 8 bits a 32-bit lane
  return (uint32_t)((t | (t >> 24)) & 0xFFFF);
}

inline uint32_t flags8(uint64_t u) {
  // bit 7 of byte j -> bit j (each product term lands on a bit of its own)
  return (uint32_t)(((acgt_bytes(u) >> 7) * 0x0102040810204080ULL) >> 56);
}

// One row of m bases from src into ceil(L/16) code words (first base in
// the MSBs) and ceil(L/32) validity words (first base at bit 31), every
// word of the row written: the layout of ops/kmer_ops.pack_words /
// pack_valid bit for bit.
void pack_row(const unsigned char* src, size_t m, uint32_t* wrow, int nw,
              uint32_t* vrow, int nv) {
  const size_t full = m / 16;
  uint32_t vhi = 0;
  size_t j = 0;
  for (; j <= full; j++) {
    const unsigned char* p = src + 16 * j;
    uint64_t a, b;
    if (j < full) {
      a = __builtin_bswap64(load8(p));
      b = __builtin_bswap64(load8(p + 8));
    } else {
      const size_t r = m & 15;
      if (r == 0) break;
      a = __builtin_bswap64(load_upto8(p, r));
      b = r > 8 ? __builtin_bswap64(load_upto8(p + 8, r - 8)) : 0;
    }
    wrow[j] = codes16(a) << 16 | codes16(b);
    const uint32_t v = flags8(a) << 8 | flags8(b);
    if (j & 1)
      vrow[j >> 1] = vhi | v;
    else
      vhi = v << 16;
  }
  if (j & 1) vrow[j >> 1] = vhi;
  for (size_t w = j; w < (size_t)nw; w++) wrow[w] = 0;
  for (size_t w = (j + 1) / 2; w < (size_t)nv; w++) vrow[w] = 0;
}

// One row of m bases as bytes: codes (c >> 1) & 3 and validity 0/1, the
// rest of the L bytes zero.
void code_row(const unsigned char* src, size_t m, uint8_t* crow,
              uint8_t* vrow, size_t L) {
  size_t i = 0;
  for (; i < m; i += 8) {
    const size_t r = m - i < 8 ? m - i : 8;
    const uint64_t x = load_upto8(src + i, r);
    const uint64_t c = (x >> 1) & (3 * kOnes);
    const uint64_t v = acgt_bytes(x) >> 7;
    std::memcpy(crow + i, &c, r);
    std::memcpy(vrow + i, &v, r);
  }
  std::memset(crow + m, 0, L - m);
  std::memset(vrow + m, 0, L - m);
}

// ---------------------------------------------------------------------------
// the in-place scanner
// ---------------------------------------------------------------------------

// A buffer over gzFile (zlib transparently handles plain files). Lines are
// handed out as [b, e) offsets into the buffer, valid until the next call.
class Scanner {
 public:
  enum { kEnd, kLine, kLong };

  explicit Scanner(const char* path) : f_(gzopen(path, "rb")) {
    if (f_) gzbuffer(f_, 1 << 17);
    buf_.resize(kScanBuf);
  }
  ~Scanner() {
    if (f_) gzclose(f_);
  }
  bool ok() const { return f_ != nullptr; }
  int64_t bytes() const { return bytes_; }
  const unsigned char* at(size_t off) const { return buf_.data() + off; }

  // The next line as [*b, *e) without its '\n' (and a '\r' before the
  // '\n'; a last line with no '\n' keeps its '\r'): kLine. kEnd at the
  // end of the input. kLong where the line does not fit the buffer:
  // [*b, *e) is its start, and append_rest / skip_line take the rest.
  int line(size_t* b, size_t* e) {
    size_t start = pos_, scan = pos_;
    for (;;) {
      const unsigned char* nl = (const unsigned char*)std::memchr(
          buf_.data() + scan, '\n', len_ - scan);
      if (nl) {
        size_t end = (size_t)(nl - buf_.data());
        pos_ = end + 1;
        if (end > start && buf_[end - 1] == '\r') end--;
        *b = start;
        *e = end;
        return kLine;
      }
      if (eof_) {
        pos_ = len_;
        *b = start;
        *e = len_;
        return start < len_ ? kLine : kEnd;
      }
      if (start == 0 && len_ == buf_.size()) {
        pos_ = len_;
        *b = 0;
        *e = len_;
        return kLong;
      }
      scan = len_ - start;
      refill(start);
      start = 0;
    }
  }

  // The rest of a kLong line appended to `out`, a '\r' before its '\n'
  // stripped from the whole line.
  void append_rest(std::string& out) {
    for (;;) {
      if (pos_ == len_) {
        refill(len_);
        if (pos_ == len_) return;  // end of input
      }
      const unsigned char* s = buf_.data() + pos_;
      const unsigned char* nl =
          (const unsigned char*)std::memchr(s, '\n', len_ - pos_);
      if (nl) {
        out.append((const char*)s, (size_t)(nl - s));
        pos_ += (size_t)(nl - s) + 1;
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return;
      }
      out.append((const char*)s, len_ - pos_);
      pos_ = len_;
    }
  }

  // Consumes the next line unread; false where none was left.
  bool skip_line() {
    bool any = false;
    for (;;) {
      const unsigned char* s = buf_.data() + pos_;
      const unsigned char* nl =
          (const unsigned char*)std::memchr(s, '\n', len_ - pos_);
      if (nl) {
        pos_ += (size_t)(nl - s) + 1;
        return true;
      }
      any = any || pos_ < len_;
      pos_ = len_;
      if (eof_) return any;
      refill(len_);
    }
  }

 private:
  // Moves [keep, len) to the front and reads into the free space once.
  void refill(size_t keep) {
    if (keep) {
      std::memmove(buf_.data(), buf_.data() + keep, len_ - keep);
      len_ -= keep;
      pos_ -= keep;
    }
    if (eof_) return;
    const int n = gzread(f_, buf_.data() + len_, (unsigned)(buf_.size() - len_));
    if (n <= 0) {
      eof_ = true;
      return;
    }
    len_ += (size_t)n;
    bytes_ += n;
  }

  gzFile f_;
  std::vector<unsigned char> buf_;
  size_t pos_ = 0, len_ = 0;
  int64_t bytes_ = 0;
  bool eof_ = false;
};

// A sequence payload: a view of the scan buffer or of the reader's own
// copy, valid until the next call.
struct SeqView {
  const unsigned char* p = nullptr;
  size_t n = 0;
  bool copied = false;
};

// Streaming FASTA/FASTQ record reader (format auto-detected per file, like
// BankFasta). Multiple comma-separated URIs are handled by the Python layer.
class FastxReader {
 public:
  explicit FastxReader(const char* path) : sc_(path) {}
  bool ok() const { return sc_.ok(); }
  int64_t bytes() const { return sc_.bytes(); }

  // Next sequence payload; false at EOF.
  bool next(SeqView& v) {
    size_t b, e;
    if (mode_ == kUnknown) {
      for (;;) {
        const int r = sc_.line(&b, &e);
        if (r == Scanner::kEnd) return false;
        if (e == b) continue;
        const unsigned char c = *sc_.at(b);
        if (r == Scanner::kLong) sc_.skip_line();
        if (c == '>') {
          mode_ = kFasta;
          have_header_ = true;
          break;
        }
        if (c == '@') {
          mode_ = kFastq;
          break;
        }
        return false;  // not FASTA/FASTQ
      }
    }
    return mode_ == kFasta ? next_fasta(v) : next_fastq(v);
  }

 private:
  bool view_of_copy(SeqView& v) {
    v.p = (const unsigned char*)seq_.data();
    v.n = seq_.size();
    v.copied = true;
    return true;
  }

  // FASTA: the sequence lines, copied until the next header or the end;
  // a last header with no line after it is no record.
  bool next_fasta(SeqView& v) {
    if (!have_header_) return false;
    seq_.clear();
    bool got = false;
    size_t b, e;
    for (int r; (r = sc_.line(&b, &e)) != Scanner::kEnd;) {
      if (e > b && *sc_.at(b) == '>') {
        if (r == Scanner::kLong) sc_.skip_line();
        return view_of_copy(v);
      }
      seq_.append((const char*)sc_.at(b), e - b);
      if (r == Scanner::kLong) sc_.append_rest(seq_);
      got = true;
    }
    have_header_ = false;
    return got && view_of_copy(v);
  }

  // FASTQ: @hdr / seq / + / qual, strictly 4 lines per record; the first
  // header is consumed during detection on the first record only. The
  // '+' and quality lines are skipped when the next record is asked for,
  // so that the sequence stays a view of the buffer until then.
  bool next_fastq(SeqView& v) {
    for (; skips_; skips_--) sc_.skip_line();
    if (!first_fastq_done_) {
      first_fastq_done_ = true;
    } else if (!sc_.skip_line()) {
      return false;  // expected @header
    }
    size_t b, e;
    const int r = sc_.line(&b, &e);
    if (r == Scanner::kEnd) return false;
    skips_ = 2;
    if (r == Scanner::kLong) {
      seq_.assign((const char*)sc_.at(b), e - b);
      sc_.append_rest(seq_);
      return view_of_copy(v);
    }
    v.p = sc_.at(b);
    v.n = e - b;
    v.copied = false;
    return true;
  }

  enum Mode { kUnknown, kFasta, kFastq };
  Scanner sc_;
  std::string seq_;
  Mode mode_ = kUnknown;
  bool have_header_ = false;
  int skips_ = 0;             // FASTQ: lines of the last record unread
  bool first_fastq_done_ = false;
};

struct Batcher {
  FastxReader reader;
  int k, B, L, nw, nv;
  int64_t nb_seqs = 0, total_size = 0;
  int64_t min_len = -1, max_len = 0;
  double sumsq = 0.0;   // for seq_size_deviation (BankStats equivalent)
  int64_t carried = 0;  // sequences that took a copy (multi-line, > L, ...)
  std::string carry;    // current sequence being split
  size_t carry_pos = 0;
  bool carry_active = false, done = false;

  Batcher(const char* path, int k_, int B_, int L_)
      : reader(path), k(k_), B(B_), L(L_), nw((L_ + 15) / 16),
        nv((L_ + 31) / 32) {}

  // Next piece of the current sequence, starting a new sequence when the
  // current one is used up; false at EOF. Mirrors _BatchBuilder.add: at
  // least one piece even for empty / short sequences, later pieces only
  // while they contain a window, (k-1)-overlap between pieces. A sequence
  // of at most L bases is its own piece, read where the reader holds it.
  bool next_piece(const unsigned char** src, size_t* m) {
    for (;;) {
      if (!carry_active) {
        SeqView v;
        if (done || !reader.next(v)) {
          done = true;
          return false;
        }
        const int64_t slen = (int64_t)v.n;
        nb_seqs++;
        total_size += slen;
        if (min_len < 0 || slen < min_len) min_len = slen;
        if (slen > max_len) max_len = slen;
        sumsq += (double)slen * (double)slen;
        if (v.n <= (size_t)L) {
          carried += v.copied;
          *src = v.p;
          *m = v.n;
          return true;
        }
        carried++;
        carry.assign((const char*)v.p, v.n);
        carry_pos = 0;
        carry_active = true;
      }
      const size_t n = carry.size();
      const size_t pos = carry_pos;
      if (pos != 0 && pos + (size_t)(k - 1) >= n) {
        carry_active = false;
        continue;
      }
      *src = (const unsigned char*)carry.data() + pos;
      *m = n - pos < (size_t)L ? n - pos : (size_t)L;
      if (pos + (size_t)L >= n) {
        carry_active = false;
      } else {
        carry_pos = pos + (size_t)(L - (k - 1));
      }
      return true;
    }
  }

  // Fills one batch of B rows; returns the rows filled (0 = EOF). codes /
  // valid are B*L bytes, lengths B int32; every byte is written (rows past
  // the fill zero).
  int next_batch(uint8_t* codes, uint8_t* valid, int32_t* lengths) {
    int row = 0;
    const unsigned char* src;
    size_t m;
    for (; row < B && next_piece(&src, &m); row++) {
      code_row(src, m, codes + (size_t)row * L, valid + (size_t)row * L,
               (size_t)L);
      lengths[row] = (int32_t)m;
    }
    const size_t rest = (size_t)(B - row);
    std::memset(codes + (size_t)row * L, 0, rest * L);
    std::memset(valid + (size_t)row * L, 0, rest * L);
    std::memset(lengths + row, 0, rest * sizeof(int32_t));
    return row;
  }

  // Packed-transfer variant: 2-bit code words (ceil(L/16) uint32 per row,
  // first base in the MSBs) + validity bitmasks (ceil(L/32) uint32, first
  // base at bit 31) — 2.25 bits/base over the host->device link instead
  // of 16, every word written.
  int next_batch_packed(uint32_t* words, uint32_t* vmask, int32_t* lengths) {
    int row = 0;
    const unsigned char* src;
    size_t m;
    for (; row < B && next_piece(&src, &m); row++) {
      pack_row(src, m, words + (size_t)row * nw, nw, vmask + (size_t)row * nv,
               nv);
      lengths[row] = (int32_t)m;
    }
    const size_t rest = (size_t)(B - row);
    std::memset(words + (size_t)row * nw, 0, rest * nw * sizeof(uint32_t));
    std::memset(vmask + (size_t)row * nv, 0, rest * nv * sizeof(uint32_t));
    std::memset(lengths + row, 0, rest * sizeof(int32_t));
    return row;
  }
};

}  // namespace

extern "C" {

void* fastx_open(const char* path, int k, int batch_reads, int batch_len) {
  Batcher* b = new Batcher(path, k, batch_reads, batch_len);
  if (!b->reader.ok()) {
    delete b;
    return nullptr;
  }
  return b;
}

// Up to n batches into n consecutive (B, L) codes / valid blocks and (B,)
// lengths; rows[g] the rows of batch g. Returns the batches filled: fewer
// than n only at EOF, and no batch is empty.
int fastx_fill(void* h, int n, uint8_t* codes, uint8_t* valid,
               int32_t* lengths, int32_t* rows) {
  Batcher* b = static_cast<Batcher*>(h);
  const size_t block = (size_t)b->B * b->L;
  int g = 0;
  for (; g < n; g++) {
    const int r = b->next_batch(codes + g * block, valid + g * block,
                                lengths + (size_t)g * b->B);
    if (r == 0) break;
    rows[g] = r;
  }
  return g;
}

// The packed variant of fastx_fill: (B, ceil(L/16)) words and
// (B, ceil(L/32)) validity words a batch.
int fastx_fill_packed(void* h, int n, uint32_t* words, uint32_t* vmask,
                      int32_t* lengths, int32_t* rows) {
  Batcher* b = static_cast<Batcher*>(h);
  int g = 0;
  for (; g < n; g++) {
    const int r = b->next_batch_packed(words + (size_t)g * b->B * b->nw,
                                       vmask + (size_t)g * b->B * b->nv,
                                       lengths + (size_t)g * b->B);
    if (r == 0) break;
    rows[g] = r;
  }
  return g;
}

// Full BankStats block (SortingCountAlgorithm.cpp:735-742 equivalents)
void fastx_stats_full(void* h, int64_t* nb_seqs, int64_t* total_size,
                      int64_t* min_len, int64_t* max_len, double* sumsq) {
  Batcher* b = static_cast<Batcher*>(h);
  *nb_seqs = b->nb_seqs;
  *total_size = b->total_size;
  *min_len = b->min_len < 0 ? 0 : b->min_len;
  *max_len = b->max_len;
  *sumsq = b->sumsq;
}

// The input bytes read so far (decompressed for .gz) and the sequences
// that took a copy instead of a view of the scan buffer.
void fastx_parse_counters(void* h, int64_t* bytes, int64_t* carried) {
  Batcher* b = static_cast<Batcher*>(h);
  *bytes = b->reader.bytes();
  *carried = b->carried;
}

void fastx_close(void* h) { delete static_cast<Batcher*>(h); }

// Plain record interface (Sequence-level iteration): returns the length of
// the next sequence copied into `out` (capacity `cap`), -1 at EOF, -2 if the
// sequence exceeds cap (`*big` then points at it until the next call).
void* fastx_open_reader(const char* path) {
  FastxReader* r = new FastxReader(path);
  if (!r->ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

int64_t fastx_next_seq(void* h, char* out, int64_t cap, char** big) {
  static thread_local std::string seq;
  SeqView v;
  if (!static_cast<FastxReader*>(h)->next(v)) return -1;
  if ((int64_t)v.n <= cap) {
    if (v.n) std::memcpy(out, v.p, v.n);
    return (int64_t)v.n;
  }
  seq.assign((const char*)v.p, v.n);
  *big = const_cast<char*>(seq.data());
  return -2;
}

void fastx_reader_close(void* h) { delete static_cast<FastxReader*>(h); }

}

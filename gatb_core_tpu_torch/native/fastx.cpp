// Native host runtime: FASTA/FASTQ(.gz) reader + 2-bit encoder + batcher.
//
// Native counterpart of gatb-core's BankFasta parser
// (bank/impl/BankFasta.cpp:42,395 — zlib gzread with 256 KB buffers) fused
// with the device batch builder: instead of producing Sequence objects, it
// fills fixed-shape (B, L) code/validity/length batches ready for
// host->device transfer, splitting long reads into (k-1)-overlap pieces
// exactly like kmer/counting.py _BatchBuilder (itself mirroring the
// reference's streaming superkmer split, Sequence2SuperKmer.hpp:139-155).
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

namespace {

constexpr size_t kIoBuf = 1 << 18;  // 256 KB read chunks, like the reference

struct CodeTables {
  uint8_t code[256];
  uint8_t valid[256];
  CodeTables() {
    // every byte maps to (c >> 1) & 3 (ConvertASCII, misc/api/Data.hpp) —
    // A=0 C=1 T=2 G=3 fall out of the ASCII bit pattern; only ACGTacgt
    // are valid positions.
    std::memset(valid, 0, sizeof(valid));
    for (int c = 0; c < 256; c++) code[c] = (uint8_t)((c >> 1) & 3);
    for (const char* p = "ACGTacgt"; *p; p++) valid[(unsigned char)*p] = 1;
  }
};
const CodeTables kTables;

// Buffered line reader over gzFile (zlib transparently handles plain files).
class LineReader {
 public:
  explicit LineReader(const char* path) : f_(gzopen(path, "rb")) {
    buf_.resize(kIoBuf);
  }
  ~LineReader() {
    if (f_) gzclose(f_);
  }
  bool ok() const { return f_ != nullptr; }

  // Appends the next line (without terminator) to `line`; returns false at EOF.
  bool next_line(std::string& line) {
    line.clear();
    for (;;) {
      if (pos_ == len_) {
        if (eof_) return !line.empty();
        int n = gzread(f_, buf_.data(), (unsigned)buf_.size());
        if (n <= 0) {
          eof_ = true;
          return !line.empty();
        }
        len_ = (size_t)n;
        pos_ = 0;
      }
      char* start = buf_.data() + pos_;
      char* nl = (char*)memchr(start, '\n', len_ - pos_);
      if (nl) {
        size_t m = (size_t)(nl - start);
        line.append(start, m);
        pos_ += m + 1;
        if (!line.empty() && line.back() == '\r') line.pop_back();
        return true;
      }
      line.append(start, len_ - pos_);
      pos_ = len_;
    }
  }

 private:
  gzFile f_;
  std::vector<char> buf_;
  size_t pos_ = 0, len_ = 0;
  bool eof_ = false;
};

// Streaming FASTA/FASTQ record reader (format auto-detected per file, like
// BankFasta). Multiple comma-separated URIs are handled by the Python layer.
class FastxReader {
 public:
  explicit FastxReader(const char* path) : rd_(path) {}
  bool ok() const { return rd_.ok(); }

  // Next sequence payload into `seq`; returns false at EOF.
  bool next(std::string& seq) {
    seq.clear();
    std::string line;
    if (mode_ == kUnknown) {
      while (rd_.next_line(line)) {
        if (line.empty()) continue;
        if (line[0] == '>') {
          mode_ = kFasta;
          break;
        }
        if (line[0] == '@') {
          mode_ = kFastq;
          break;
        }
        return false;  // not FASTA/FASTQ
      }
      if (mode_ == kUnknown) return false;
      if (mode_ == kFasta) have_header_ = true;
    }
    if (mode_ == kFasta) {
      if (!have_header_) return false;
      // accumulate wrapped sequence lines until next header / EOF
      bool got = false;
      while (rd_.next_line(line)) {
        if (!line.empty() && line[0] == '>') {
          have_header_ = true;
          return true;  // seq may be empty (empty record) — still a record
        }
        seq += line;
        got = true;
      }
      have_header_ = false;
      return got || !seq.empty();
    }
    // FASTQ: @hdr / seq / + / qual, strictly 4 lines per record; the first
    // header is consumed during detection on the first record only.
    if (!first_fastq_done_) {
      first_fastq_done_ = true;
    } else if (!rd_.next_line(line)) {
      return false;  // expected @header
    }
    if (!rd_.next_line(seq)) return false;
    std::string plus, qual;
    rd_.next_line(plus);
    rd_.next_line(qual);
    return true;
  }

 private:
  enum Mode { kUnknown, kFasta, kFastq };
  LineReader rd_;
  Mode mode_ = kUnknown;
  bool have_header_ = false;
  bool first_fastq_done_ = false;
};

struct Batcher {
  FastxReader reader;
  int k, B, L;
  int64_t nb_seqs = 0, total_size = 0;
  int64_t min_len = -1, max_len = 0;
  double sumsq = 0.0;   // for seq_size_deviation (BankStats equivalent)
  std::string carry;    // current sequence being split
  size_t carry_pos = 0;
  bool carry_active = false, done = false;

  Batcher(const char* path, int k_, int B_, int L_)
      : reader(path), k(k_), B(B_), L(L_) {}

  // Next piece of the current sequence, starting a new sequence when the
  // current one is used up; false at EOF. Mirrors _BatchBuilder.add: at
  // least one piece even for empty / short sequences, later pieces only
  // while they contain a window, (k-1)-overlap between pieces.
  bool next_piece(const unsigned char** src, size_t* m) {
    for (;;) {
      if (!carry_active) {
        if (done || !reader.next(carry)) {
          done = true;
          return false;
        }
        const int64_t slen = (int64_t)carry.size();
        nb_seqs++;
        total_size += slen;
        if (min_len < 0 || slen < min_len) min_len = slen;
        if (slen > max_len) max_len = slen;
        sumsq += (double)slen * (double)slen;
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

  // Fills one batch; returns rows filled (0 = EOF). codes/valid are B*L
  // uint8 buffers (rows beyond the fill left untouched by contract: caller
  // zeroes them), lengths is B int32.
  int next_batch(uint8_t* codes, uint8_t* valid, int32_t* lengths) {
    int row = 0;
    const unsigned char* src;
    size_t m;
    for (; row < B && next_piece(&src, &m); row++) {
      uint8_t* crow = codes + (size_t)row * L;
      uint8_t* vrow = valid + (size_t)row * L;
      for (size_t i = 0; i < m; i++) {
        crow[i] = kTables.code[src[i]];
        vrow[i] = kTables.valid[src[i]];
      }
      lengths[row] = (int32_t)m;
    }
    return row;
  }

  // Packed-transfer variant: fills 2-bit code words (ceil(L/16) uint32 per
  // row, first base in the MSBs) + validity bitmasks (ceil(L/32) uint32,
  // first base at bit 31) — 2.25 bits/base over the host->device link
  // instead of 16. Layout matches ops/kmer_ops.pack_words / pack_valid
  // bit-for-bit.
  int next_batch_packed(uint32_t* words, uint32_t* vmask, int32_t* lengths) {
    const int nw = (L + 15) / 16, nv = (L + 31) / 32;
    int row = 0;
    const unsigned char* src;
    size_t m;
    for (; row < B && next_piece(&src, &m); row++) {
      uint32_t* wrow = words + (size_t)row * nw;
      uint32_t* vrow = vmask + (size_t)row * nv;
      uint32_t cw = 0, vw = 0;
      size_t i = 0;
      for (; i < m; i++) {
        const unsigned char ch = src[i];
        cw |= (uint32_t)kTables.code[ch] << (30 - 2 * (i & 15));
        vw |= (uint32_t)kTables.valid[ch] << (31 - (i & 31));
        if ((i & 15) == 15) {
          wrow[i >> 4] = cw;
          cw = 0;
        }
        if ((i & 31) == 31) {
          vrow[i >> 5] = vw;
          vw = 0;
        }
      }
      if (i & 15) wrow[i >> 4] = cw;
      if (i & 31) vrow[i >> 5] = vw;
      lengths[row] = (int32_t)m;
    }
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

int fastx_next_batch(void* h, uint8_t* codes, uint8_t* valid,
                     int32_t* lengths) {
  return static_cast<Batcher*>(h)->next_batch(codes, valid, lengths);
}

int fastx_next_batch_packed(void* h, uint32_t* words, uint32_t* vmask,
                            int32_t* lengths) {
  return static_cast<Batcher*>(h)->next_batch_packed(words, vmask, lengths);
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
  FastxReader* r = static_cast<FastxReader*>(h);
  if (!r->next(seq)) return -1;
  if ((int64_t)seq.size() <= cap) {
    std::memcpy(out, seq.data(), seq.size());
    return (int64_t)seq.size();
  }
  *big = const_cast<char*>(seq.data());
  return -2;
}

void fastx_reader_close(void* h) { delete static_cast<FastxReader*>(h); }

}

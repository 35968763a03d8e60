// ZSTD frame decoder (RFC 8878, Zstandard Compression and the
// 'application/zstd' Media Type), for the ZSTD bodies of Arrow IPC files.
//
// Handles what the format allows without a dictionary: concatenated and
// skippable frames; the frame header's window descriptor, dictionary id
// (a non-zero one is refused) and content size; raw, RLE and compressed
// blocks of at most 128 KB; literals stored raw, as one repeated byte or
// Huffman-coded in one or four streams, with a new tree (4-bit or
// FSE-compressed weights) or the previous block's ("treeless"); sequences
// whose literal-length, offset and match-length codes take the predefined
// distributions, one repeated symbol (RLE), an FSE table read from the
// block or the previous block's table; the three repeat offsets; and the
// XXH64 content checksum, verified where the frame header sets its flag.
//
// The whole output is one buffer, so a match may reach back to the start
// of its frame. Every read and write is bounds-checked: a corrupt or
// truncated frame returns a negative code, and never reads or writes out
// of range. utils/zstd.py is the same decoder in pure Python, step for
// step; the tests hold this one to it and both to pyarrow's encoder.
//
// Build: g++ -O3 -fPIC -shared (data/native_io.py::library)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum : int64_t {
  kTruncated = -1,
  kBadMagic = -2,
  kBadHeader = -3,
  kDictionary = -4,
  kCorrupt = -5,
  kOutputFull = -6,
  kChecksum = -7,
  kContentSize = -8,
  kBlockTooLarge = -9,
  kReservedBlock = -10,
};

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippable = 0x184D2A50u;
constexpr int64_t kBlockMax = 128 * 1024;
constexpr uint64_t kP1 = 0x9E3779B185EBCA87ull, kP2 = 0xC2B2AE3D27D4EB4Full,
                   kP3 = 0x165667B19E3779F9ull, kP4 = 0x85EBCA77C2B2AE63ull,
                   kP5 = 0x27D4EB2F165667C5ull;

inline uint32_t read32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

inline uint64_t read64(const uint8_t* p) {
  return uint64_t(read32(p)) | uint64_t(read32(p + 4)) << 32;
}

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh64_round(uint64_t acc, uint64_t lane) {
  return rotl64(acc + lane * kP2, 31) * kP1;
}

// XXH64 with seed 0, the checksum of the ZSTD frame format.
uint64_t xxh64(const uint8_t* p, int64_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0ull - kP1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh64_round(v1, read64(p));
      v2 = xxh64_round(v2, read64(p + 8));
      v3 = xxh64_round(v3, read64(p + 16));
      v4 = xxh64_round(v4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xxh64_round(0, v)) * kP1 + kP4;
  } else {
    h = kP5;
  }
  h += uint64_t(len);
  for (; p + 8 <= end; p += 8) h = rotl64(h ^ xxh64_round(0, read64(p)), 27) * kP1 + kP4;
  if (p + 4 <= end) {
    h = rotl64(h ^ uint64_t(read32(p)) * kP1, 23) * kP2 + kP3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl64(h ^ *p * kP5, 11) * kP1;
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

inline int highbit(uint32_t x) { return 31 - __builtin_clz(x); }  // x > 0

// The backward bitstream of Huffman and FSE data: read from the end,
// highest bits first, after the end marker (the last byte's highest set
// bit). p counts the bits left; reading past the start gives zeros and
// makes it negative.
struct Backward {
  const uint8_t* d = nullptr;
  int64_t n = 0;
  int64_t p = 0;

  bool init(const uint8_t* data, int64_t len) {
    if (len <= 0 || data[len - 1] == 0) return false;
    d = data;
    n = len;
    p = 8 * (len - 1) + highbit(data[len - 1]);
    return true;
  }

  // The next nb <= 32 bits, without consuming them.
  uint32_t peek(int nb) const {
    if (nb == 0) return 0;
    const int64_t lo = p - nb;
    const int64_t start = lo < 0 ? 0 : lo;
    const int64_t cnt = p - start;
    if (cnt <= 0) return 0;
    const int64_t b = start >> 3;
    uint64_t w = 0;
    if (b + 8 <= n) {
      std::memcpy(&w, d + b, 8);  // little endian
    } else {
      for (int64_t i = 0; b + i < n; ++i) w |= uint64_t(d[b + i]) << (8 * i);
    }
    w = (w >> (start & 7)) & ((1ull << cnt) - 1);
    return uint32_t(lo < 0 ? w << -lo : w);
  }

  uint32_t read(int nb) {
    const uint32_t v = peek(nb);
    p -= nb;
    return v;
  }
};

// An FSE decoding table: for each state its symbol, the bits it reads and
// the base of the next state. Accuracy logs up to 9.
struct FSE {
  int log = 0;
  uint8_t sym[512];
  uint8_t nb[512];
  uint16_t next[512];
};

// An FSE table description at data[pos, len): the normalized counts
// (-1: "less than one"), their number and the accuracy log. Returns the
// position after it, or a negative code.
int64_t read_ncount(const uint8_t* data, int64_t len, int64_t pos, int max_symbol,
                    int max_log, int16_t* norm, int* nsym, int* log_out) {
  int64_t bitpos = 8 * pos;
  auto peek = [&](int nb) -> uint32_t {
    const int64_t b = bitpos >> 3;
    uint64_t w = 0;
    for (int i = 0; i < 8 && b + i < len; ++i) w |= uint64_t(data[b + i]) << (8 * i);
    return uint32_t(w >> (bitpos & 7)) & ((1u << nb) - 1);
  };
  if (pos >= len) return kTruncated;
  const int log = int(peek(4)) + 5;
  bitpos += 4;
  if (log > max_log) return kCorrupt;
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int n = 0;
  bool prev0 = false;
  while (remaining > 1) {
    if (prev0) {
      for (;;) {
        const int rep = int(peek(2));
        bitpos += 2;
        if (n + rep > max_symbol + 1) return kCorrupt;
        for (int i = 0; i < rep; ++i) norm[n++] = 0;
        if (rep != 3) break;
      }
    }
    if (n > max_symbol) return kCorrupt;
    const int mx = (2 * threshold - 1) - remaining;
    const uint32_t v = peek(nbits);
    int count;
    if (int(v & uint32_t(threshold - 1)) < mx) {
      count = int(v & uint32_t(threshold - 1));
      bitpos += nbits - 1;
    } else {
      count = int(v & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= mx;
      bitpos += nbits;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) return kCorrupt;
    norm[n++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      nbits -= 1;
      threshold >>= 1;
    }
  }
  const int64_t after = (bitpos + 7) >> 3;
  if (after > len) return kTruncated;
  *nsym = n;
  *log_out = log;
  return after;
}

bool build_fse(const int16_t* norm, int nsym, int log, FSE* t) {
  const int size = 1 << log;
  int high = size - 1;
  uint16_t nxt[256];
  t->log = log;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t->sym[high--] = uint8_t(s);
      nxt[s] = 1;
    } else {
      nxt[s] = uint16_t(norm[s] < 0 ? 0 : norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int p = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t->sym[p] = uint8_t(s);
      p = (p + step) & mask;
      while (p > high) p = (p + step) & mask;
    }
  }
  if (p != 0) return false;
  for (int u = 0; u < size; ++u) {
    const int s = t->sym[u];
    const uint32_t x = nxt[s]++;
    const int nb = log - highbit(x);
    t->nb[u] = uint8_t(nb);
    t->next[u] = uint16_t((x << nb) - uint32_t(size));
  }
  return true;
}

void rle_fse(uint8_t symbol, FSE* t) {
  t->log = 0;
  t->sym[0] = symbol;
  t->nb[0] = 0;
  t->next[0] = 0;
}

// The predefined distributions (RFC 8878 3.1.1.3.2.2).
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int kMaxSymbol[3] = {35, 31, 52};  // literal lengths, offsets, match lengths
const int kMaxLog[3] = {9, 8, 9};

struct Huffman {
  int bits = 0;
  uint8_t sym[2048];
  uint8_t nb[2048];
};

struct FrameState {
  bool have_huffman = false;
  Huffman huffman;
  bool have[3] = {false, false, false};
  FSE tables[3];
  FSE predefined[3];
  uint32_t ll_base[36];
  uint32_t ml_base[53];
  uint64_t reps[3] = {1, 4, 8};
  std::vector<uint8_t> literals;

  FrameState() {
    build_fse(kLLNorm, 36, 6, &predefined[0]);
    build_fse(kOFNorm, 29, 5, &predefined[1]);
    build_fse(kMLNorm, 53, 6, &predefined[2]);
    uint32_t b = 0;
    for (int i = 0; i < 36; ++i) ll_base[i] = b, b += 1u << kLLBits[i];
    b = 3;
    for (int i = 0; i < 53; ++i) ml_base[i] = b, b += 1u << kMLBits[i];
    literals.resize(kBlockMax);
  }
};

// The Huffman tree description at blk[pos, end). Returns the position
// after it, or a negative code.
int64_t huffman_tree(const uint8_t* blk, int64_t pos, int64_t end, Huffman* h) {
  if (pos >= end) return kTruncated;
  const int head = blk[pos++];
  uint8_t w[256];
  int n = 0;
  if (head >= 128) {  // 4-bit weights, two a byte
    n = head - 127;
    if (pos + (n + 1) / 2 > end) return kTruncated;
    for (int i = 0; i < n; ++i) {
      const uint8_t byte = blk[pos + i / 2];
      w[i] = (i % 2 == 0) ? byte >> 4 : byte & 15;
    }
    pos += (n + 1) / 2;
  } else {  // FSE-compressed weights, two interleaved states
    if (pos + head > end) return kTruncated;
    const uint8_t* data = blk + pos;
    pos += head;
    int16_t norm[256];
    int nsym, log;
    const int64_t at = read_ncount(data, head, 0, 255, 6, norm, &nsym, &log);
    if (at < 0) return at;
    FSE t;
    if (!build_fse(norm, nsym, log, &t)) return kCorrupt;
    Backward br;
    if (!br.init(data + at, head - at)) return kCorrupt;
    uint32_t s1 = br.read(log), s2 = br.read(log);
    for (;;) {
      if (n >= 255) return kCorrupt;
      w[n++] = t.sym[s1];
      s1 = t.next[s1] + br.read(t.nb[s1]);
      if (br.p < 0) {
        w[n++] = t.sym[s2];
        break;
      }
      if (n >= 255) return kCorrupt;
      w[n++] = t.sym[s2];
      s2 = t.next[s2] + br.read(t.nb[s2]);
      if (br.p < 0) {
        w[n++] = t.sym[s1];
        break;
      }
    }
  }
  if (n > 255) return kCorrupt;
  uint32_t total = 0;
  for (int i = 0; i < n; ++i) {
    if (w[i] > 11) return kCorrupt;
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) return kCorrupt;
  const int bits = highbit(total) + 1;
  const uint32_t left = (1u << bits) - total;
  if (bits > 11 || (left & (left - 1))) return kCorrupt;
  w[n++] = uint8_t(highbit(left) + 1);
  h->bits = bits;
  int p = 0;
  for (int wt = 1; wt <= bits; ++wt) {
    for (int s = 0; s < n; ++s) {
      if (w[s] != wt) continue;
      const int cnt = 1 << (wt - 1);
      std::memset(h->sym + p, s, cnt);
      std::memset(h->nb + p, bits + 1 - wt, cnt);
      p += cnt;
    }
  }
  return pos;
}

bool huffman_stream(const uint8_t* stream, int64_t len, uint8_t* out, int64_t n,
                    const Huffman& h) {
  Backward br;
  if (!br.init(stream, len)) return false;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t v = br.peek(h.bits);
    out[i] = h.sym[v];
    br.p -= h.nb[v];
  }
  return br.p == 0;
}

// The literals section at blk[0, len) into st->literals: returns the
// position after it (its size in *size), or a negative code.
int64_t literals(const uint8_t* blk, int64_t len, FrameState* st, int64_t* size) {
  if (len < 1) return kTruncated;
  const int b0 = blk[0];
  const int kind = b0 & 3, fmt = (b0 >> 2) & 3;
  uint8_t* lit = st->literals.data();
  if (kind == 0 || kind == 1) {  // raw, RLE
    int64_t n, pos;
    if (fmt == 0 || fmt == 2) {
      n = b0 >> 3, pos = 1;
    } else if (fmt == 1) {
      if (len < 2) return kTruncated;
      n = (b0 >> 4) + (int64_t(blk[1]) << 4), pos = 2;
    } else {
      if (len < 3) return kTruncated;
      n = (b0 >> 4) + (int64_t(blk[1]) << 4) + (int64_t(blk[2]) << 12), pos = 3;
    }
    if (n > kBlockMax) return kCorrupt;
    *size = n;
    if (kind == 0) {
      if (pos + n > len) return kTruncated;
      std::memcpy(lit, blk + pos, n);
      return pos + n;
    }
    if (pos >= len) return kTruncated;
    std::memset(lit, blk[pos], n);
    return pos + 1;
  }
  // Huffman-coded (kind 2: with its tree; kind 3: the previous one).
  const int width = fmt == 2 ? 4 : fmt == 3 ? 5 : 3;
  const int field = width == 3 ? 10 : width == 4 ? 14 : 18;
  if (width > len) return kTruncated;
  uint64_t h = 0;
  for (int i = 0; i < width; ++i) h |= uint64_t(blk[i]) << (8 * i);
  const int64_t n = int64_t(h >> 4) & ((1 << field) - 1);
  const int64_t comp = int64_t(h >> (4 + field)) & ((1 << field) - 1);
  const int streams = fmt == 0 ? 1 : 4;
  int64_t pos = width;
  const int64_t end = width + comp;
  if (end > len) return kTruncated;
  if (n > kBlockMax) return kCorrupt;
  if (kind == 2) {
    pos = huffman_tree(blk, pos, end, &st->huffman);
    if (pos < 0) return pos;
    st->have_huffman = true;
  } else if (!st->have_huffman) {
    return kCorrupt;
  }
  *size = n;
  if (streams == 1) {
    if (!huffman_stream(blk + pos, end - pos, lit, n, st->huffman)) return kCorrupt;
    return end;
  }
  if (pos + 6 > end) return kTruncated;
  int64_t sizes[4];
  sizes[0] = blk[pos] | blk[pos + 1] << 8;
  sizes[1] = blk[pos + 2] | blk[pos + 3] << 8;
  sizes[2] = blk[pos + 4] | blk[pos + 5] << 8;
  pos += 6;
  sizes[3] = end - pos - sizes[0] - sizes[1] - sizes[2];
  const int64_t quarter = (n + 3) / 4;
  const int64_t last = n - 3 * quarter;
  if (sizes[3] < 0 || last < 0) return kCorrupt;
  int64_t op = 0;
  for (int i = 0; i < 4; ++i) {
    const int64_t count = i < 3 ? quarter : last;
    if (!huffman_stream(blk + pos, sizes[i], lit + op, count, st->huffman)) return kCorrupt;
    pos += sizes[i];
    op += count;
  }
  return end;
}

// The match offset of an offset value, updating the repeat offsets; 0 if
// the repeat offset would be 0.
uint64_t offset(uint64_t of_value, uint64_t ll, uint64_t* reps) {
  if (of_value > 3) {
    const uint64_t off = of_value - 3;
    reps[2] = reps[1], reps[1] = reps[0], reps[0] = off;
    return off;
  }
  const int idx = int(of_value) - 1 + (ll == 0);
  if (idx == 0) return reps[0];
  if (idx == 3) {
    const uint64_t off = reps[0] - 1;
    if (off == 0) return 0;
    reps[2] = reps[1], reps[1] = reps[0], reps[0] = off;
    return off;
  }
  const uint64_t off = reps[idx];
  if (idx == 2) reps[2] = reps[1];
  reps[1] = reps[0];
  reps[0] = off;
  return off;
}

// A compressed block blk[0, len) appended to dst at *op (the frame began
// at start). Returns 0 or a negative code.
int64_t compressed_block(const uint8_t* blk, int64_t len, uint8_t* dst, int64_t* op,
                         int64_t cap, int64_t start, FrameState* st) {
  int64_t nlit = 0;
  int64_t pos = literals(blk, len, st, &nlit);
  if (pos < 0) return pos;
  const uint8_t* lit = st->literals.data();
  if (pos >= len) return kTruncated;
  const int b0 = blk[pos];
  int64_t nseq;
  if (b0 == 0) {
    if (pos + 1 != len) return kCorrupt;
    nseq = 0;
    pos += 1;
  } else if (b0 < 128) {
    nseq = b0, pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > len) return kTruncated;
    nseq = (int64_t(b0 - 128) << 8) + blk[pos + 1], pos += 2;
  } else {
    if (pos + 3 > len) return kTruncated;
    nseq = blk[pos + 1] + (int64_t(blk[pos + 2]) << 8) + 0x7F00, pos += 3;
  }
  int64_t lp = 0;
  if (nseq > 0) {
    if (pos >= len) return kTruncated;
    const int modes = blk[pos++];
    if (modes & 3) return kCorrupt;
    for (int k = 0; k < 3; ++k) {
      const int mode = (modes >> (6 - 2 * k)) & 3;
      if (mode == 0) {
        st->tables[k] = st->predefined[k];
      } else if (mode == 1) {
        if (pos >= len) return kTruncated;
        if (blk[pos] > kMaxSymbol[k]) return kCorrupt;
        rle_fse(blk[pos++], &st->tables[k]);
      } else if (mode == 2) {
        int16_t norm[256];
        int nsym, log;
        pos = read_ncount(blk, len, pos, kMaxSymbol[k], kMaxLog[k], norm, &nsym, &log);
        if (pos < 0) return pos;
        if (!build_fse(norm, nsym, log, &st->tables[k])) return kCorrupt;
      } else if (!st->have[k]) {
        return kCorrupt;
      }
      st->have[k] = true;
    }
    const FSE& ll_t = st->tables[0];
    const FSE& of_t = st->tables[1];
    const FSE& ml_t = st->tables[2];
    Backward br;
    if (!br.init(blk + pos, len - pos)) return kCorrupt;
    uint32_t s_ll = br.read(ll_t.log), s_of = br.read(of_t.log), s_ml = br.read(ml_t.log);
    for (int64_t i = 0; i < nseq; ++i) {
      const int of_code = of_t.sym[s_of], ml_code = ml_t.sym[s_ml], ll_code = ll_t.sym[s_ll];
      if (of_code > 31 || ml_code > 52 || ll_code > 35) return kCorrupt;
      const uint64_t of_value = (uint64_t(1) << of_code) + br.read(of_code);
      const uint64_t ml = st->ml_base[ml_code] + br.read(kMLBits[ml_code]);
      const uint64_t ll = st->ll_base[ll_code] + br.read(kLLBits[ll_code]);
      if (i != nseq - 1) {
        s_ll = ll_t.next[s_ll] + br.read(ll_t.nb[s_ll]);
        s_ml = ml_t.next[s_ml] + br.read(ml_t.nb[s_ml]);
        s_of = of_t.next[s_of] + br.read(of_t.nb[s_of]);
      }
      if (uint64_t(nlit - lp) < ll) return kCorrupt;
      if (uint64_t(cap - *op) < ll + ml) return kOutputFull;
      std::memcpy(dst + *op, lit + lp, ll);
      *op += int64_t(ll);
      lp += int64_t(ll);
      const uint64_t off = offset(of_value, ll, st->reps);
      if (off == 0 || off > uint64_t(*op - start)) return kCorrupt;
      uint8_t* out = dst + *op;
      const uint8_t* from = out - off;
      if (off >= ml) {
        std::memcpy(out, from, ml);
      } else {
        for (uint64_t j = 0; j < ml; ++j) out[j] = from[j];  // overlapping
      }
      *op += int64_t(ml);
    }
    if (br.p != 0) return kCorrupt;
  }
  const int64_t rest = nlit - lp;
  if (cap - *op < rest) return kOutputFull;
  std::memcpy(dst + *op, lit + lp, rest);
  *op += rest;
  return 0;
}

// One frame whose header starts at src[*pos] (after the magic), appended
// to dst[op, cap). Returns the new output size or a negative code.
int64_t decode_frame(const uint8_t* src, int64_t n, int64_t* pos_io, uint8_t* dst,
                     int64_t op, int64_t cap) {
  int64_t pos = *pos_io;
  if (pos >= n) return kTruncated;
  const int desc = src[pos++];
  const int fcs_flag = desc >> 6, single = (desc >> 5) & 1;
  const int checksum = (desc >> 2) & 1, did_flag = desc & 3;
  if (desc & 8) return kBadHeader;
  if (!single) pos += 1;  // the window descriptor: every match is checked against the frame
  const int did_size = did_flag == 3 ? 4 : did_flag;
  const int fcs_size = fcs_flag == 0 ? single : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  if (pos + did_size + fcs_size > n) return kTruncated;
  uint64_t did = 0;
  for (int i = 0; i < did_size; ++i) did |= uint64_t(src[pos + i]) << (8 * i);
  pos += did_size;
  if (did != 0) return kDictionary;
  uint64_t fcs = 0;
  for (int i = 0; i < fcs_size; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
  if (fcs_size == 2) fcs += 256;
  pos += fcs_size;
  const int64_t start = op;
  FrameState st;
  for (;;) {
    if (n - pos < 3) return kTruncated;
    const uint32_t hdr = src[pos] | src[pos + 1] << 8 | src[pos + 2] << 16;
    pos += 3;
    const int last = hdr & 1, kind = (hdr >> 1) & 3;
    const int64_t size = hdr >> 3;
    if (size > kBlockMax) return kBlockTooLarge;
    if (kind == 0) {
      if (n - pos < size) return kTruncated;
      if (cap - op < size) return kOutputFull;
      std::memcpy(dst + op, src + pos, size);
      op += size;
      pos += size;
    } else if (kind == 1) {
      if (pos >= n) return kTruncated;
      if (cap - op < size) return kOutputFull;
      std::memset(dst + op, src[pos], size);
      op += size;
      pos += 1;
    } else if (kind == 2) {
      if (n - pos < size) return kTruncated;
      const int64_t e = compressed_block(src + pos, size, dst, &op, cap, start, &st);
      if (e < 0) return e;
      pos += size;
    } else {
      return kReservedBlock;
    }
    if (last) break;
  }
  if (fcs_size && uint64_t(op - start) != fcs) return kContentSize;
  if (checksum) {
    if (n - pos < 4) return kTruncated;
    if (uint32_t(xxh64(dst + start, op - start)) != read32(src + pos)) return kChecksum;
    pos += 4;
  }
  *pos_io = pos;
  return op;
}

}  // namespace

extern "C" {

// Decode the ZSTD frames of src[0, n) into dst[0, cap). Returns the
// number of bytes written, or a negative code (zstd_frame_error names it).
int64_t zstd_frame_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t pos = 0, op = 0;
  if (n == 0) return kTruncated;
  while (pos < n) {
    if (n - pos < 4) return kTruncated;
    const uint32_t magic = read32(src + pos);
    pos += 4;
    if ((magic & kSkippableMask) == kSkippable) {
      if (n - pos < 4) return kTruncated;
      const int64_t size = read32(src + pos);
      pos += 4;
      if (n - pos < size) return kTruncated;
      pos += size;
      continue;
    }
    if (magic != kMagic) return kBadMagic;
    op = decode_frame(src, n, &pos, dst, op, cap);
    if (op < 0) return op;
  }
  return op;
}

const char* zstd_frame_error(int64_t code) {
  switch (code) {
    case kTruncated: return "truncated frame";
    case kBadMagic: return "not a ZSTD frame (bad magic number)";
    case kBadHeader: return "bad frame header (reserved bit set)";
    case kDictionary: return "the frame needs a dictionary; none is supported";
    case kCorrupt: return "corrupt block";
    case kOutputFull: return "decoded data is larger than the expected size";
    case kChecksum: return "content checksum (XXH64) mismatch";
    case kContentSize: return "decoded size differs from the frame's content size";
    case kBlockTooLarge: return "block larger than 128 KB";
    case kReservedBlock: return "reserved block type";
    default: return "unknown error";
  }
}

}  // extern "C"

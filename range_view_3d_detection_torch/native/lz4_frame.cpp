// LZ4 frame decoder (https://github.com/lz4/lz4/blob/dev/doc/lz4_Frame_format.md
// and lz4_Block_format.md), for the LZ4_FRAME bodies of Arrow IPC files.
//
// Handles what the format allows: concatenated and skippable frames, the
// FLG and BD bytes, the optional content size, the header checksum, data
// blocks compressed or stored raw (high bit of the block size), linked
// blocks (LZ4F's default: a match may reach up to 64 KB back into the
// frame's earlier blocks) and independent ones, optional block checksums
// and the optional content checksum, all verified (xxHash32), and
// overlapping matches (offset < length), copied byte by byte. Frames that
// need a dictionary (the DictID flag) and the legacy format are refused.
//
// The whole output is one buffer, so a linked block's window is simply
// the frame's output so far. Every read and write is bounds-checked: a
// corrupt or truncated frame returns a negative code, never reads or
// writes out of range.
//
// Build: g++ -O3 -fPIC -shared (data/native_io.py::library)

#include <cstdint>
#include <cstring>

namespace {

enum : int64_t {
  kTruncated = -1,
  kBadMagic = -2,
  kBadHeader = -3,
  kHeaderChecksum = -4,
  kCorruptBlock = -5,
  kOutputFull = -6,
  kBlockChecksum = -7,
  kContentChecksum = -8,
  kContentSize = -9,
  kDictionary = -10,
  kBlockTooLarge = -11,
};

constexpr uint32_t kMagic = 0x184D2204u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippable = 0x184D2A50u;
constexpr uint32_t kP1 = 0x9E3779B1u, kP2 = 0x85EBCA77u, kP3 = 0xC2B2AE3Du,
                   kP4 = 0x27D4EB2Fu, kP5 = 0x165667B1u;

inline uint32_t read32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

inline uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t xxh_round(uint32_t acc, uint32_t input) {
  return rotl(acc + input * kP2, 13) * kP1;
}

// xxHash32 with seed 0, the checksum of the LZ4 frame format.
uint32_t xxh32(const uint8_t* p, int64_t len) {
  const uint8_t* end = p + len;
  uint32_t h;
  if (len >= 16) {
    uint32_t v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0u - kP1;
    const uint8_t* limit = end - 16;
    do {
      v1 = xxh_round(v1, read32(p));
      v2 = xxh_round(v2, read32(p + 4));
      v3 = xxh_round(v3, read32(p + 8));
      v4 = xxh_round(v4, read32(p + 12));
      p += 16;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
  } else {
    h = kP5;
  }
  h += uint32_t(len);
  for (; p + 4 <= end; p += 4) h = rotl(h + read32(p) * kP3, 17) * kP4;
  for (; p < end; ++p) h = rotl(h + *p * kP5, 11) * kP1;
  h ^= h >> 15;
  h *= kP2;
  h ^= h >> 13;
  h *= kP3;
  h ^= h >> 16;
  return h;
}

// One LZ4 block of n bytes into dst[op...], matches reaching back no
// further than dst[window]. Returns the new output position.
int64_t decode_block(const uint8_t* src, int64_t n, uint8_t* dst, int64_t op,
                     int64_t cap, int64_t window) {
  int64_t ip = 0;
  for (;;) {
    if (ip >= n) return kCorruptBlock;  // a block ends with literals
    const uint32_t token = src[ip++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint32_t b;
      do {
        if (ip >= n) return kCorruptBlock;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (lit > n - ip) return kCorruptBlock;
    if (lit > cap - op) return kOutputFull;
    std::memcpy(dst + op, src + ip, size_t(lit));
    ip += lit;
    op += lit;
    if (ip == n) return op;  // the last sequence has no match
    if (n - ip < 2) return kCorruptBlock;
    const int64_t offset = int64_t(src[ip]) | int64_t(src[ip + 1]) << 8;
    ip += 2;
    if (offset == 0 || offset > op - window) return kCorruptBlock;
    int64_t len = token & 15;
    if (len == 15) {
      uint32_t b;
      do {
        if (ip >= n) return kCorruptBlock;
        b = src[ip++];
        len += b;
      } while (b == 255);
    }
    len += 4;
    if (len > cap - op) return kOutputFull;
    uint8_t* out = dst + op;
    const uint8_t* match = out - offset;
    if (offset >= len) {
      std::memcpy(out, match, size_t(len));
    } else {  // overlapping: each byte may be one this match wrote
      for (int64_t i = 0; i < len; ++i) out[i] = match[i];
    }
    op += len;
  }
}

// One frame starting after its magic number at src[*pos]; appends to dst.
int64_t decode_frame(const uint8_t* src, int64_t n, int64_t* pos, uint8_t* dst,
                     int64_t op, int64_t cap) {
  int64_t p = *pos;
  if (n - p < 3) return kTruncated;
  const uint32_t flg = src[p], bd = src[p + 1];
  if ((flg >> 6) != 1 || (flg & 0x02) || (bd & 0x8F)) return kBadHeader;
  const bool independent = flg & 0x20, block_checksum = flg & 0x10,
             has_size = flg & 0x08, content_checksum = flg & 0x04;
  if (flg & 0x01) return kDictionary;
  const uint32_t bsid = (bd >> 4) & 7;
  if (bsid < 4) return kBadHeader;
  const int64_t max_block = int64_t(1) << (8 + 2 * bsid);
  const int64_t desc = 2 + (has_size ? 8 : 0);
  if (n - p < desc + 1) return kTruncated;
  if (((xxh32(src + p, desc) >> 8) & 0xFF) != src[p + desc]) return kHeaderChecksum;
  uint64_t content_size = 0;
  if (has_size) {
    content_size = uint64_t(read32(src + p + 2)) | uint64_t(read32(src + p + 6)) << 32;
  }
  p += desc + 1;
  const int64_t start = op;
  for (;;) {
    if (n - p < 4) return kTruncated;
    const uint32_t word = read32(src + p);
    p += 4;
    if (word == 0) break;  // end mark
    const bool raw = word & 0x80000000u;
    const int64_t size = word & 0x7FFFFFFFu;
    if (size > max_block) return kBlockTooLarge;
    if (n - p < size + (block_checksum ? 4 : 0)) return kTruncated;
    const uint8_t* data = src + p;
    p += size;
    if (block_checksum) {
      if (xxh32(data, size) != read32(src + p)) return kBlockChecksum;
      p += 4;
    }
    int64_t next;
    if (raw) {
      if (size > cap - op) return kOutputFull;
      std::memcpy(dst + op, data, size_t(size));
      next = op + size;
    } else {
      next = decode_block(data, size, dst, op, cap, independent ? op : start);
      if (next < 0) return next;
      if (next - op > max_block) return kBlockTooLarge;
    }
    op = next;
  }
  if (content_checksum) {
    if (n - p < 4) return kTruncated;
    if (xxh32(dst + start, op - start) != read32(src + p)) return kContentChecksum;
    p += 4;
  }
  if (has_size && uint64_t(op - start) != content_size) return kContentSize;
  *pos = p;
  return op;
}

}  // namespace

extern "C" {

// Decode the LZ4 frames of src[0, n) into dst[0, cap). Returns the
// number of bytes written, or a negative code (lz4_frame_error names it).
int64_t lz4_frame_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t cap) {
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

const char* lz4_frame_error(int64_t code) {
  switch (code) {
    case kTruncated: return "truncated frame";
    case kBadMagic: return "not an LZ4 frame (bad magic number)";
    case kBadHeader: return "bad frame descriptor (FLG or BD byte)";
    case kHeaderChecksum: return "frame descriptor checksum mismatch";
    case kCorruptBlock: return "corrupt block";
    case kOutputFull: return "decoded data is larger than the expected size";
    case kBlockChecksum: return "block checksum mismatch";
    case kContentChecksum: return "content checksum mismatch";
    case kContentSize: return "decoded size differs from the frame's content size";
    case kDictionary: return "frames that need a dictionary are not supported";
    case kBlockTooLarge: return "block larger than the frame's maximum block size";
    default: return "unknown error";
  }
}

}  // extern "C"

// A Zstandard decoder (RFC 8878) for the host, with a plain C interface.
//
// It reads the frames that tensorstore writes into an Orbax checkpoint: the
// frame header (window, frame content size, single segment, optional XXH64
// content checksum, which is checked), raw / RLE / compressed blocks, the
// literals section (raw, RLE, Huffman with one or four streams, and treeless
// literals reusing the previous table of the frame), Huffman weights coded by
// FSE or as direct 4-bit values, and the sequences section with predefined,
// RLE, FSE-coded and repeated tables and the three repeat offsets. Several
// frames may follow each other; skippable frames are skipped. Dictionaries
// are not supported (a frame that names one is an error).
//
// Entry points (loaded with ctypes by ckpt_format/zstd.py):
//   long long dgmr_zstd_decompress(src, src_size, dst, dst_capacity, size_t* at)
//       -> the decoded size, or -(error code); *at is the input offset of the error.
//   int dgmr_zstd_content_size(src, src_size, long long* total, size_t* at)
//       -> 0, with *total the sum of the frames' content sizes (-1 if a frame
//          does not declare its size), or an error code (*at as above).
//   const char* dgmr_zstd_error_string(int code)
//
// Build: c++ -O2 -std=c++17 -shared -fPIC -o libdgmr_zstd.so zstd.cpp

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

enum Code {
  kOk = 0,
  kTruncated = 1,
  kBadMagic = 2,
  kReserved = 3,
  kDictionary = 4,
  kDstTooSmall = 5,
  kBadBlock = 6,
  kBadLiterals = 7,
  kBadHuffman = 8,
  kBadFse = 9,
  kBadSequences = 10,
  kBadOffset = 11,
  kBadChecksum = 12,
  kSizeMismatch = 13,
  kEmpty = 14,
};

const char* const kMessages[] = {
    "ok",
    "input truncated",
    "not a zstd frame (bad magic number)",
    "reserved bit or value set",
    "frame needs a dictionary (not supported)",
    "output buffer too small",
    "corrupt block",
    "corrupt literals section",
    "corrupt Huffman table or stream",
    "corrupt FSE table or stream",
    "corrupt sequences section",
    "match offset beyond the decoded data",
    "content checksum mismatch",
    "decoded size differs from the frame content size",
    "empty input (no frame)",
};

struct Fail {
  int code;
  size_t at;
};

constexpr size_t kMaxBlock = 128 * 1024;

inline int highest_bit(uint64_t v) { return 63 - __builtin_clzll(v); }

inline uint32_t load_le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

inline uint64_t load_le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // the host is little-endian (x86-64, aarch64)
}

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, load_le64(p));
      v2 = xround(v2, load_le64(p + 8));
      v3 = xround(v3, load_le64(p + 16));
      v4 = xround(v4, load_le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= xround(0, load_le64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(load_le32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- bit readers
// Forward, least significant bit first (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t len;
  size_t bit = 0;
  size_t at;  // input offset of p, for errors

  // Bits past the end read as 0; bytes_used() says whether they were needed.
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++, bit++) {
      if ((bit >> 3) < len) v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward: the stream is read from its last bit down; the highest set bit
// of the last byte is the padding marker. Bits below position 0 read as 0.
struct BackwardBits {
  const uint8_t* s;
  size_t len;
  int64_t pos;  // bits not yet read

  void init(const uint8_t* src, size_t n, size_t at, int code) {
    if (n == 0 || src[n - 1] == 0) throw Fail{code, at + n};
    s = src;
    len = n;
    pos = int64_t(n - 1) * 8 + highest_bit(src[n - 1]);
  }
  // n <= 56 bits starting at bit b (0 <= b, b + n <= 8 * len).
  inline uint64_t get(int64_t b, int n) const {
    size_t byte = size_t(b >> 3);
    uint64_t w;
    if (byte + 8 <= len) {
      w = load_le64(s + byte);
    } else {
      w = 0;
      for (size_t i = byte; i < len; i++) w |= uint64_t(s[i]) << (8 * (i - byte));
    }
    return (w >> (b & 7)) & ((uint64_t(1) << n) - 1);
  }
  inline uint64_t peek(int n) const {
    if (n == 0) return 0;
    if (pos >= n) return get(pos - n, n);
    if (pos <= 0) return 0;
    return get(0, int(pos)) << (n - pos);
  }
  inline uint64_t read(int n) {
    uint64_t v = peek(n);
    pos -= n;
    return v;
  }
};

// ---------------------------------------------------------------- FSE
struct FseEntry {
  uint8_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  FseEntry t[1 << 9];
};

// Reads a table description (RFC 8878 4.1.1) of at most 2^max_log states
// over symbols [0, max_symbol]; returns the bytes it took.
size_t read_fse_description(const uint8_t* p, size_t len, size_t at, int max_log, int max_symbol,
                            int16_t* freq, int* nsym, int* log) {
  ForwardBits in{p, len, 0, at};
  int al = int(in.read(4)) + 5;
  if (al > max_log) throw Fail{kBadFse, at};
  int remaining = 1 << al;
  int sym = 0;
  while (remaining > 0) {
    if (sym > max_symbol) throw Fail{kBadFse, at + in.bytes_used()};
    int bits = highest_bit(uint64_t(remaining) + 1) + 1;
    size_t save = in.bit;
    uint32_t val = in.read(bits);
    uint32_t lower_mask = (1u << (bits - 1)) - 1;
    uint32_t threshold = (1u << bits) - 1 - (uint32_t(remaining) + 1);
    if ((val & lower_mask) < threshold) {
      in.bit = save + bits - 1;
      val &= lower_mask;
    } else if (val > lower_mask) {
      val -= threshold;
    }
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    freq[sym++] = int16_t(proba);
    if (proba == 0) {
      uint32_t repeat = in.read(2);
      for (;;) {
        for (uint32_t i = 0; i < repeat; i++) {
          if (sym > max_symbol) throw Fail{kBadFse, at + in.bytes_used()};
          freq[sym++] = 0;
        }
        if (repeat != 3) break;
        repeat = in.read(2);
      }
    }
  }
  if (remaining != 0 || in.bytes_used() > len) throw Fail{kBadFse, at + in.bytes_used()};
  *nsym = sym;
  *log = al;
  return in.bytes_used();
}

void build_fse(FseTable& T, const int16_t* freq, int nsym, int al, size_t at) {
  const int size = 1 << al;
  uint16_t next[256];
  int high = size;
  for (int s = 0; s < nsym; s++) {
    if (freq[s] == -1) {
      T.t[--high].symbol = uint8_t(s);
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; s++) {
    if (freq[s] <= 0) continue;
    next[s] = uint16_t(freq[s]);
    for (int i = 0; i < freq[s]; i++) {
      T.t[pos].symbol = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) throw Fail{kBadFse, at};
  for (int i = 0; i < size; i++) {
    int s = T.t[i].symbol;
    uint32_t state = next[s]++;
    int nb = al - highest_bit(state);
    T.t[i].nbits = uint8_t(nb);
    T.t[i].base = uint16_t((state << nb) - size);
  }
  T.log = al;
}

void rle_fse(FseTable& T, uint8_t symbol) {
  T.log = 0;
  T.t[0] = FseEntry{symbol, 0, 0};
}

// ---------------------------------------------------------------- Huffman
struct HufTable {
  bool valid = false;
  int maxbits = 0;
  uint8_t sym[1 << 11];
  uint8_t nbits[1 << 11];
};

// Reads a Huffman tree description; returns the bytes it took.
size_t read_huffman(HufTable& H, const uint8_t* p, size_t len, size_t at) {
  if (len < 1) throw Fail{kTruncated, at};
  uint8_t w[256];
  int n = 0;
  size_t used;
  const int hb = p[0];
  if (hb >= 128) {
    n = hb - 127;
    size_t bytes = (size_t(n) + 1) / 2;
    if (1 + bytes > len) throw Fail{kTruncated, at};
    for (int i = 0; i < n; i++) w[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
    used = 1 + bytes;
  } else {
    size_t csize = size_t(hb);
    if (csize == 0 || 1 + csize > len) throw Fail{kBadHuffman, at};
    int16_t freq[256];
    int nsym, al;
    size_t d = read_fse_description(p + 1, csize, at + 1, 6, 12, freq, &nsym, &al);
    if (d >= csize) throw Fail{kBadHuffman, at + 1 + d};
    static thread_local FseTable T;
    build_fse(T, freq, nsym, al, at + 1);
    BackwardBits b;
    b.init(p + 1 + d, csize - d, at + 1 + d, kBadHuffman);
    uint32_t s1 = uint32_t(b.read(al)), s2 = uint32_t(b.read(al));
    for (;;) {
      if (n >= 255) throw Fail{kBadHuffman, at};
      w[n++] = T.t[s1].symbol;
      s1 = T.t[s1].base + uint32_t(b.read(T.t[s1].nbits));
      if (b.pos < 0) {
        w[n++] = T.t[s2].symbol;
        break;
      }
      if (n >= 255) throw Fail{kBadHuffman, at};
      w[n++] = T.t[s2].symbol;
      s2 = T.t[s2].base + uint32_t(b.read(T.t[s2].nbits));
      if (b.pos < 0) {
        if (n >= 255) throw Fail{kBadHuffman, at};
        w[n++] = T.t[s1].symbol;
        break;
      }
    }
    used = 1 + csize;
  }
  uint32_t total = 0;
  for (int i = 0; i < n; i++) {
    if (w[i] > 11) throw Fail{kBadHuffman, at};
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) throw Fail{kBadHuffman, at};
  const int maxbits = highest_bit(total) + 1;
  const uint32_t rest = (1u << maxbits) - total;
  if (maxbits > 11 || (rest & (rest - 1)) != 0) throw Fail{kBadHuffman, at};
  w[n++] = uint8_t(highest_bit(rest) + 1);
  uint32_t pos = 0;
  for (int weight = 1; weight <= maxbits; weight++) {
    for (int s = 0; s < n; s++) {
      if (w[s] != weight) continue;
      uint32_t count = 1u << (weight - 1);
      std::memset(H.sym + pos, s, count);
      std::memset(H.nbits + pos, maxbits + 1 - weight, count);
      pos += count;
    }
  }
  if (pos != (1u << maxbits)) throw Fail{kBadHuffman, at};
  H.maxbits = maxbits;
  H.valid = true;
  return used;
}

void huffman_stream(const HufTable& H, const uint8_t* s, size_t len, uint8_t* out, size_t n,
                    size_t at) {
  BackwardBits b;
  b.init(s, len, at, kBadHuffman);
  const int mb = H.maxbits;
  size_t i = 0;
  // Four symbols (at most 44 bits) from each 8-byte load while 64 bits remain.
  while (i + 4 <= n && b.pos >= 64) {
    const size_t byte = size_t((b.pos + 7) >> 3) - 8;  // bits [8 byte, pos) hold 57 to 64
    uint64_t v = load_le64(s + byte) << (64 - (b.pos - 8 * int64_t(byte)));
    for (int k = 0; k < 4; k++) {
      const uint32_t idx = uint32_t(v >> (64 - mb));
      out[i++] = H.sym[idx];
      const int nb = H.nbits[idx];
      v <<= nb;
      b.pos -= nb;
    }
  }
  for (; i < n; i++) {
    uint32_t v = uint32_t(b.peek(mb));
    out[i] = H.sym[v];
    b.pos -= H.nbits[v];
  }
  if (b.pos != 0) throw Fail{kBadHuffman, at};
}

// ---------------------------------------------------------------- sequences
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct SeqTable {
  bool valid = false;
  FseTable t;
};

// One of the three tables of a sequences section header; returns the bytes it took.
size_t read_seq_table(SeqTable& S, int mode, const uint8_t* p, size_t len, size_t at,
                      const int16_t* def, int def_n, int def_log, int max_log, int max_symbol) {
  switch (mode) {
    case 0:
      build_fse(S.t, def, def_n, def_log, at);
      S.valid = true;
      return 0;
    case 1:
      if (len < 1) throw Fail{kTruncated, at};
      if (p[0] > max_symbol) throw Fail{kBadSequences, at};
      rle_fse(S.t, p[0]);
      S.valid = true;
      return 1;
    case 2: {
      int16_t freq[256];
      int nsym, al;
      size_t used = read_fse_description(p, len, at, max_log, max_symbol, freq, &nsym, &al);
      build_fse(S.t, freq, nsym, al, at);
      S.valid = true;
      return used;
    }
    default:
      if (!S.valid) throw Fail{kBadSequences, at};
      return 0;
  }
}

// ---------------------------------------------------------------- frames
struct FrameState {
  HufTable huf;
  SeqTable ll, of, ml;
  uint32_t rep[3];
  uint8_t lit[kMaxBlock];
};

struct Decoder {
  const uint8_t* src;
  uint8_t* dst;
  uint8_t* dst_end;

  size_t off(const uint8_t* p) const { return size_t(p - src); }

  // Decodes the literals section; returns bytes used, sets *lit_size.
  size_t literals(FrameState& F, const uint8_t* p, size_t len, size_t* lit_size) {
    const size_t at = off(p);
    if (len < 1) throw Fail{kTruncated, at};
    const int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    if (type < 2) {
      size_t regen, hsize;
      if (sf == 0 || sf == 2) {
        regen = p[0] >> 3;
        hsize = 1;
      } else if (sf == 1) {
        if (len < 2) throw Fail{kTruncated, at};
        regen = (p[0] >> 4) + (size_t(p[1]) << 4);
        hsize = 2;
      } else {
        if (len < 3) throw Fail{kTruncated, at};
        regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
        hsize = 3;
      }
      if (regen > kMaxBlock) throw Fail{kBadLiterals, at};
      if (type == 0) {
        if (hsize + regen > len) throw Fail{kTruncated, at};
        std::memcpy(F.lit, p + hsize, regen);
        *lit_size = regen;
        return hsize + regen;
      }
      if (hsize + 1 > len) throw Fail{kTruncated, at};
      std::memset(F.lit, p[hsize], regen);
      *lit_size = regen;
      return hsize + 1;
    }
    size_t regen, csize, hsize;
    int streams = sf == 0 ? 1 : 4;
    if (sf < 2) {
      if (len < 3) throw Fail{kTruncated, at};
      uint32_t h = p[0] | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
      regen = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
      hsize = 3;
    } else if (sf == 2) {
      if (len < 4) throw Fail{kTruncated, at};
      uint32_t h = load_le32(p);
      regen = (h >> 4) & 0x3FFF;
      csize = h >> 18;
      hsize = 4;
    } else {
      if (len < 5) throw Fail{kTruncated, at};
      uint64_t h = load_le32(p) | uint64_t(p[4]) << 32;
      regen = (h >> 4) & 0x3FFFF;
      csize = (h >> 22) & 0x3FFFF;
      hsize = 5;
    }
    if (regen > kMaxBlock) throw Fail{kBadLiterals, at};
    if (hsize + csize > len) throw Fail{kTruncated, at};
    const uint8_t* q = p + hsize;
    size_t qlen = csize;
    if (type == 2) {
      size_t used = read_huffman(F.huf, q, qlen, off(q));
      q += used;
      qlen -= used;
    } else if (!F.huf.valid) {
      throw Fail{kBadLiterals, at};
    }
    if (streams == 1) {
      huffman_stream(F.huf, q, qlen, F.lit, regen, off(q));
    } else {
      if (qlen < 6) throw Fail{kBadLiterals, off(q)};
      size_t s1 = q[0] | size_t(q[1]) << 8, s2 = q[2] | size_t(q[3]) << 8,
             s3 = q[4] | size_t(q[5]) << 8;
      if (6 + s1 + s2 + s3 > qlen) throw Fail{kBadLiterals, off(q)};
      size_t s4 = qlen - 6 - s1 - s2 - s3;
      size_t part = (regen + 3) / 4;
      if (3 * part > regen) throw Fail{kBadLiterals, off(q)};
      const uint8_t* r = q + 6;
      huffman_stream(F.huf, r, s1, F.lit, part, off(r));
      r += s1;
      huffman_stream(F.huf, r, s2, F.lit + part, part, off(r));
      r += s2;
      huffman_stream(F.huf, r, s3, F.lit + 2 * part, part, off(r));
      r += s3;
      huffman_stream(F.huf, r, s4, F.lit + 3 * part, regen - 3 * part, off(r));
    }
    *lit_size = regen;
    return hsize + csize;
  }

  // Decodes one compressed block into [op, ...); returns the new op.
  uint8_t* compressed_block(FrameState& F, const uint8_t* p, size_t len, uint8_t* op,
                            const uint8_t* frame_start) {
    size_t lit_size;
    size_t used = literals(F, p, len, &lit_size);
    const uint8_t* q = p + used;
    size_t qlen = len - used;
    const size_t at = off(q);
    if (qlen < 1) throw Fail{kTruncated, at};
    size_t nseq;
    size_t h;
    if (q[0] < 128) {
      nseq = q[0];
      h = 1;
    } else if (q[0] < 255) {
      if (qlen < 2) throw Fail{kTruncated, at};
      nseq = (size_t(q[0] - 128) << 8) + q[1];
      h = 2;
    } else {
      if (qlen < 3) throw Fail{kTruncated, at};
      nseq = q[1] + (size_t(q[2]) << 8) + 0x7F00;
      h = 3;
    }
    uint8_t* const block_start = op;
    if (nseq == 0) {
      if (h != qlen) throw Fail{kBadSequences, at};
      if (size_t(dst_end - op) < lit_size) throw Fail{kDstTooSmall, at};
      std::memcpy(op, F.lit, lit_size);
      return op + lit_size;
    }
    if (h + 1 > qlen) throw Fail{kTruncated, at};
    const uint8_t modes = q[h];
    if (modes & 3) throw Fail{kReserved, at + h};
    h += 1;
    h += read_seq_table(F.ll, modes >> 6, q + h, qlen - h, at + h, kLLDefault, 36, 6, 9, 35);
    h += read_seq_table(F.of, (modes >> 4) & 3, q + h, qlen - h, at + h, kOFDefault, 29, 5, 8, 31);
    h += read_seq_table(F.ml, (modes >> 2) & 3, q + h, qlen - h, at + h, kMLDefault, 53, 6, 9, 52);
    if (h > qlen) throw Fail{kTruncated, at};
    BackwardBits b;
    b.init(q + h, qlen - h, at + h, kBadSequences);
    const FseTable &LL = F.ll.t, &OF = F.of.t, &ML = F.ml.t;
    uint32_t sll = uint32_t(b.read(LL.log)), sof = uint32_t(b.read(OF.log)),
             sml = uint32_t(b.read(ML.log));
    size_t lit_pos = 0;
    for (size_t i = 0; i < nseq; i++) {
      const int of_code = OF.t[sof].symbol, ll_code = LL.t[sll].symbol, ml_code = ML.t[sml].symbol;
      uint64_t of_value = (uint64_t(1) << of_code) + b.read(of_code);
      size_t ml = kMLBase[ml_code] + b.read(kMLBits[ml_code]);
      size_t ll = kLLBase[ll_code] + b.read(kLLBits[ll_code]);
      uint64_t offset;
      if (of_value > 3) {
        offset = of_value - 3;
        F.rep[2] = F.rep[1];
        F.rep[1] = F.rep[0];
        F.rep[0] = uint32_t(offset);
      } else {
        uint64_t idx = of_value + (ll == 0 ? 1 : 0);
        if (idx == 1) {
          offset = F.rep[0];
        } else if (idx == 2) {
          offset = F.rep[1];
          F.rep[1] = F.rep[0];
          F.rep[0] = uint32_t(offset);
        } else {
          offset = idx == 3 ? F.rep[2] : uint64_t(F.rep[0]) - 1;
          if (offset == 0) throw Fail{kBadOffset, at + h};
          F.rep[2] = F.rep[1];
          F.rep[1] = F.rep[0];
          F.rep[0] = uint32_t(offset);
        }
      }
      if (i + 1 < nseq) {
        sll = LL.t[sll].base + uint32_t(b.read(LL.t[sll].nbits));
        sml = ML.t[sml].base + uint32_t(b.read(ML.t[sml].nbits));
        sof = OF.t[sof].base + uint32_t(b.read(OF.t[sof].nbits));
      }
      if (ll > lit_size - lit_pos) throw Fail{kBadSequences, at + h};
      if (size_t(dst_end - op) < ll + ml) throw Fail{kDstTooSmall, at + h};
      if (size_t(op - block_start) + ll + ml > kMaxBlock) throw Fail{kBadBlock, at};
      std::memcpy(op, F.lit + lit_pos, ll);
      op += ll;
      lit_pos += ll;
      if (offset > size_t(op - frame_start)) throw Fail{kBadOffset, at + h};
      const uint8_t* match = op - offset;
      if (offset >= ml) {
        std::memcpy(op, match, ml);
        op += ml;
      } else {
        for (size_t k = 0; k < ml; k++) *op++ = match[k];
      }
    }
    if (b.pos != 0) throw Fail{kBadSequences, at + h};
    size_t rest = lit_size - lit_pos;
    if (size_t(dst_end - op) < rest) throw Fail{kDstTooSmall, at};
    if (size_t(op - block_start) + rest > kMaxBlock) throw Fail{kBadBlock, at};
    std::memcpy(op, F.lit + lit_pos, rest);
    return op + rest;
  }

  struct Header {
    size_t size;  // header bytes after the magic number
    bool has_fcs, checksum;
    uint64_t fcs;
  };

  Header frame_header(const uint8_t* p, size_t len) {
    const size_t at = off(p);
    if (len < 1) throw Fail{kTruncated, at};
    const uint8_t fhd = p[0];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
    if (fhd & 8) throw Fail{kReserved, at};
    size_t h = 1;
    if (!single) h += 1;  // window descriptor: the whole output is in memory, so unused
    const size_t dict_bytes[4] = {0, 1, 2, 4};
    if (h + dict_bytes[dict_flag] > len) throw Fail{kTruncated, at};
    uint32_t dict = 0;
    for (size_t i = 0; i < dict_bytes[dict_flag]; i++) dict |= uint32_t(p[h + i]) << (8 * i);
    if (dict != 0) throw Fail{kDictionary, at};
    h += dict_bytes[dict_flag];
    const size_t fcs_bytes[4] = {size_t(single), 2, 4, 8};
    size_t nb = fcs_bytes[fcs_flag];
    if (h + nb > len) throw Fail{kTruncated, at};
    uint64_t fcs = 0;
    for (size_t i = 0; i < nb; i++) fcs |= uint64_t(p[h + i]) << (8 * i);
    if (nb == 2) fcs += 256;
    h += nb;
    return Header{h, nb > 0, ((fhd >> 2) & 1) != 0, fcs};
  }

  long long run(size_t n) {
    const uint8_t* p = src;
    const uint8_t* end = src + n;
    uint8_t* op = dst;
    if (n == 0) throw Fail{kEmpty, 0};
    static thread_local FrameState F;
    while (p < end) {
      if (end - p < 4) throw Fail{kTruncated, off(p)};
      const uint32_t magic = load_le32(p);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (end - p < 8) throw Fail{kTruncated, off(p)};
        size_t skip = load_le32(p + 4);
        if (size_t(end - p) - 8 < skip) throw Fail{kTruncated, off(p)};
        p += 8 + skip;
        continue;
      }
      if (magic != 0xFD2FB528u) throw Fail{kBadMagic, off(p)};
      p += 4;
      Header hd = frame_header(p, size_t(end - p));
      p += hd.size;
      uint8_t* const frame_start = op;
      F.huf.valid = F.ll.valid = F.of.valid = F.ml.valid = false;
      F.rep[0] = 1;
      F.rep[1] = 4;
      F.rep[2] = 8;
      for (bool last = false; !last;) {
        if (end - p < 3) throw Fail{kTruncated, off(p)};
        const uint32_t bh = p[0] | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
        const size_t at = off(p);
        p += 3;
        last = bh & 1;
        const int type = (bh >> 1) & 3;
        const size_t size = bh >> 3;
        if (type == 3) throw Fail{kBadBlock, at};
        if (size > kMaxBlock) throw Fail{kBadBlock, at};
        if (type == 1) {
          if (end - p < 1) throw Fail{kTruncated, off(p)};
          if (size_t(dst_end - op) < size) throw Fail{kDstTooSmall, at};
          std::memset(op, *p, size);
          op += size;
          p += 1;
          continue;
        }
        if (size_t(end - p) < size) throw Fail{kTruncated, at};
        if (type == 0) {
          if (size_t(dst_end - op) < size) throw Fail{kDstTooSmall, at};
          std::memcpy(op, p, size);
          op += size;
        } else {
          op = compressed_block(F, p, size, op, frame_start);
        }
        p += size;
      }
      const size_t produced = size_t(op - frame_start);
      if (hd.has_fcs && produced != hd.fcs) throw Fail{kSizeMismatch, off(p)};
      if (hd.checksum) {
        if (end - p < 4) throw Fail{kTruncated, off(p)};
        if (uint32_t(xxh64(frame_start, produced)) != load_le32(p)) throw Fail{kBadChecksum, off(p)};
        p += 4;
      }
    }
    return (long long)(op - dst);
  }

  long long content_size(size_t n) {
    const uint8_t* p = src;
    const uint8_t* end = src + n;
    if (n == 0) throw Fail{kEmpty, 0};
    long long total = 0;
    while (p < end) {
      if (end - p < 4) throw Fail{kTruncated, off(p)};
      const uint32_t magic = load_le32(p);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (end - p < 8) throw Fail{kTruncated, off(p)};
        size_t skip = load_le32(p + 4);
        if (size_t(end - p) - 8 < skip) throw Fail{kTruncated, off(p)};
        p += 8 + skip;
        continue;
      }
      if (magic != 0xFD2FB528u) throw Fail{kBadMagic, off(p)};
      p += 4;
      Header hd = frame_header(p, size_t(end - p));
      if (!hd.has_fcs) return -1;
      total += (long long)hd.fcs;
      p += hd.size;
      for (bool last = false; !last;) {  // skip the blocks
        if (end - p < 3) throw Fail{kTruncated, off(p)};
        const uint32_t bh = p[0] | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
        const size_t at = off(p);
        p += 3;
        last = bh & 1;
        const int type = (bh >> 1) & 3;
        size_t size = type == 1 ? 1 : bh >> 3;
        if (type == 3) throw Fail{kBadBlock, at};
        if (size_t(end - p) < size) throw Fail{kTruncated, at};
        p += size;
      }
      if (hd.checksum) {
        if (end - p < 4) throw Fail{kTruncated, off(p)};
        p += 4;
      }
    }
    return total;
  }
};

}  // namespace

extern "C" {

long long dgmr_zstd_decompress(const uint8_t* src, size_t src_size, uint8_t* dst, size_t dst_capacity,
                               size_t* err_at) {
  Decoder d{src, dst, dst + dst_capacity};
  try {
    return d.run(src_size);
  } catch (const Fail& f) {
    *err_at = f.at;
    return -(long long)f.code;
  }
}

int dgmr_zstd_content_size(const uint8_t* src, size_t src_size, long long* total, size_t* err_at) {
  Decoder d{src, nullptr, nullptr};
  try {
    *total = d.content_size(src_size);
    return kOk;
  } catch (const Fail& f) {
    *err_at = f.at;
    return f.code;
  }
}

const char* dgmr_zstd_error_string(int code) {
  if (code < 0 || code >= int(sizeof(kMessages) / sizeof(kMessages[0]))) return "unknown error";
  return kMessages[code];
}

}  // extern "C"

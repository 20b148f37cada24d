// Zstandard decompressor (RFC 8878) and CRC-32C, with a plain C interface
// for ctypes. It reads what the shipped orbax checkpoints hold: OCDBT
// manifests and B-tree nodes (zstd bodies under a CRC-32C) and zarr chunks
// (one zstd frame each).
//
// Covered: frames with and without Frame_Content_Size, single-segment or
// windowed; skippable frames; raw, RLE and compressed blocks; literals that
// are raw, RLE, Huffman-coded (weights sent directly or FSE-compressed, one or
// four streams) or treeless (the previous block's Huffman table); sequences in
// predefined, RLE, FSE-compressed and repeat modes; repeat offsets; and the
// XXH64 content checksum, verified when a frame carries one. Dictionaries are
// refused.
//
// Build: g++ -O2 -std=c++17 -fPIC -shared zstd_decode.cc -o libzstd_decode.so

#include <cstdint>
#include <cstring>

namespace {

enum Err : int64_t {
  kOk = 0,
  kTruncated = 1,
  kBadMagic,
  kReservedBit,
  kDictionary,
  kReservedBlock,
  kBlockTooLarge,
  kDstTooSmall,
  kBadLiterals,
  kBadHuffman,
  kBadFse,
  kBadSequences,
  kBadOffset,
  kBadBitstream,
  kNoPreviousTable,
  kChecksum,
  kContentSize,
  kNumErrors,
};

const char* kErrText[kNumErrors] = {
    "ok",
    "input truncated",
    "not a zstd frame (bad magic number)",
    "reserved bit set in the frame header",
    "frame needs a dictionary, which is not supported",
    "reserved block type",
    "block larger than 128 KiB",
    "output larger than the destination buffer",
    "corrupt literals section",
    "corrupt Huffman table",
    "corrupt FSE table description",
    "corrupt sequences section",
    "match offset beyond the start of the frame",
    "corrupt bitstream (bits left over or overread)",
    "repeat mode or treeless literals with no previous table",
    "content checksum mismatch",
    "frame content size does not match the decoded size",
};

constexpr int kBlockMax = 128 * 1024;

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xxmerge(uint64_t acc, uint64_t v) { return (acc ^ xxround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xxround(v1, rd64(p));
      v2 = xxround(v2, rd64(p + 8));
      v3 = xxround(v3, rd64(p + 16));
      v4 = xxround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxmerge(h, v1); h = xxmerge(h, v2); h = xxmerge(h, v3); h = xxmerge(h, v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xxround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) { h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3; p += 4; }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- bit readers
// Forward little-endian reader for FSE table descriptions.
struct FwdBits {
  const uint8_t* p; int64_t nbytes; int64_t bit = 0;
  uint32_t read(int n) {  // n <= 24
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++bit) {
      int64_t byte = bit >> 3;
      if (byte < nbytes && (p[byte] >> (bit & 7)) & 1) v |= 1u << i;
    }
    return v;
  }
  uint32_t peek(int n) { int64_t b = bit; uint32_t v = read(n); bit = b; return v; }
};

// Backward reader (RFC 8878 4.1.1): the stream is read from its last byte,
// whose highest set bit marks the start; each read takes the next n bits
// below the position, higher bits first. Bits below the stream's first byte
// read as zero, and `pos` goes negative when they are read.
struct BackBits {
  const uint8_t* p = nullptr; int64_t pos = 0;
  bool init(const uint8_t* src, int64_t n) {
    p = src;
    if (n <= 0 || src[n - 1] == 0) return false;
    pos = 8 * (n - 1) + highbit(src[n - 1]);
    return true;
  }
  uint64_t word_ending(int64_t byte_end) const {  // 8 bytes before byte_end, zeros below p
    if (byte_end >= 8) return rd64(p + byte_end - 8);
    uint64_t w = 0;
    for (int64_t i = 0; i < byte_end; ++i) w |= uint64_t(p[i]) << (8 * (i + 8 - byte_end));
    return w;
  }
  uint32_t peek(int n) const {  // n <= 32
    if (n == 0 || pos <= 0) return 0;
    int64_t be = (pos + 7) >> 3;
    uint64_t w = word_ending(be);
    int64_t sh = pos - n - (be - 8) * 8;
    uint64_t v = sh >= 0 ? (w >> sh) : (w << -sh);
    return uint32_t(v & ((uint64_t(1) << n) - 1));
  }
  uint32_t read(int n) { uint32_t v = peek(n); pos -= n; return v; }
};

// ---------------------------------------------------------------- FSE
struct FseEntry { uint8_t sym; uint8_t nbits; uint16_t base; };
constexpr int kFseMaxLog = 9;

struct FseTable {
  int log = 0;
  FseEntry t[1 << kFseMaxLog];
  bool valid = false;
};

// Normalized counts -> decoding table (RFC 8878 4.1.1).
bool fse_build(FseTable& tab, const int16_t* norm, int nsym, int log) {
  int size = 1 << log, high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) { tab.t[high--].sym = uint8_t(s); next[s] = 1; }
    else next[s] = uint16_t(norm[s]);
  }
  int pos = 0, step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      tab.t[pos].sym = uint8_t(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  if (pos != 0) return false;
  for (int u = 0; u < size; ++u) {
    int s = tab.t[u].sym;
    uint32_t x = next[s]++;
    int nb = log - highbit(x);
    tab.t[u].nbits = uint8_t(nb);
    tab.t[u].base = uint16_t((x << nb) - size);
  }
  tab.log = log;
  tab.valid = true;
  return true;
}

// Reads an FSE table description; returns the bytes it took, or -1.
int64_t fse_read(FseTable& tab, const uint8_t* src, int64_t n, int max_log, int max_sym) {
  if (n < 1) return -1;
  FwdBits br{src, n};
  int log = int(br.read(4)) + 5;
  if (log > max_log) return -1;
  int16_t norm[256] = {0};
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      int repeat;
      do {
        repeat = int(br.read(2));
        sym += repeat;
      } while (repeat == 3);
      if (sym > max_sym) return -1;
      prev0 = false;
      continue;
    }
    int maxv = 2 * threshold - 1 - remaining;
    int v;
    uint32_t low = br.peek(nbits - 1);
    if (int(low) < maxv) {
      v = int(low);
      br.bit += nbits - 1;
    } else {
      v = int(br.read(nbits));
      if (v >= threshold) v -= maxv;
    }
    int count = v - 1;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) { --nbits; threshold >>= 1; }
  }
  if (remaining != 1 || sym > max_sym + 1) return -1;
  int64_t used = (br.bit + 7) >> 3;
  if (used > n) return -1;
  if (!fse_build(tab, norm, sym, log)) return -1;
  return used;
}

void fse_rle(FseTable& tab, uint8_t sym) {
  tab.log = 0;
  tab.t[0] = {sym, 0, 0};
  tab.valid = true;
}

// ---------------------------------------------------------------- Huffman
constexpr int kHufMaxBits = 11;

struct HufTable {
  int maxbits = 0;
  uint16_t t[1 << kHufMaxBits];  // (symbol << 8) | nbits, indexed by the next maxbits bits
  bool valid = false;
};

bool huf_from_weights(HufTable& h, const uint8_t* w, int nsym) {
  // The last weight is implied: the others must leave a power of two to fill.
  uint32_t total = 0;
  for (int i = 0; i < nsym; ++i) {
    if (w[i] > kHufMaxBits) return false;
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) return false;
  int maxbits = highbit(total) + 1;
  if (maxbits > kHufMaxBits) return false;
  uint32_t rest = (1u << maxbits) - total;
  if (rest & (rest - 1)) return false;
  uint8_t weights[256];
  std::memcpy(weights, w, nsym);
  weights[nsym] = uint8_t(highbit(rest) + 1);
  int n = nsym + 1;
  // Codes in increasing weight, symbols in increasing order within a weight.
  int at = 0;
  for (int wt = 1; wt <= maxbits; ++wt) {
    for (int s = 0; s < n; ++s) {
      if (weights[s] != wt) continue;
      int len = 1 << (wt - 1), nb = maxbits + 1 - wt;
      for (int i = 0; i < len; ++i) h.t[at + i] = uint16_t((s << 8) | nb);
      at += len;
    }
  }
  if (at != (1 << maxbits)) return false;
  h.maxbits = maxbits;
  h.valid = true;
  return true;
}

// Huffman tree description (RFC 8878 4.2.1); returns the bytes it took, or -1.
int64_t huf_read(HufTable& h, const uint8_t* src, int64_t n) {
  if (n < 1) return -1;
  int hdr = src[0];
  uint8_t w[256];
  int nsym = 0;
  if (hdr >= 128) {  // weights sent directly, 4 bits each
    nsym = hdr - 127;
    int64_t bytes = (nsym + 1) / 2;
    if (1 + bytes > n) return -1;
    for (int i = 0; i < nsym; ++i) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    if (!huf_from_weights(h, w, nsym)) return -1;
    return 1 + bytes;
  }
  // FSE-compressed weights: two interleaved states over one table.
  int64_t csize = hdr;
  if (csize == 0 || 1 + csize > n) return -1;
  const uint8_t* p = src + 1;
  FseTable tab;
  int64_t used = fse_read(tab, p, csize, 6, 15);
  if (used < 0 || used >= csize) return -1;
  BackBits br;
  if (!br.init(p + used, csize - used)) return -1;
  uint32_t s1 = br.read(tab.log), s2 = br.read(tab.log);
  for (;;) {
    if (nsym > 253) return -1;
    const FseEntry& e1 = tab.t[s1];
    w[nsym++] = e1.sym;
    s1 = e1.base + br.read(e1.nbits);
    if (br.pos < 0) { w[nsym++] = tab.t[s2].sym; break; }
    const FseEntry& e2 = tab.t[s2];
    w[nsym++] = e2.sym;
    s2 = e2.base + br.read(e2.nbits);
    if (br.pos < 0) { w[nsym++] = tab.t[s1].sym; break; }
  }
  if (!huf_from_weights(h, w, nsym)) return -1;
  return 1 + csize;
}

bool huf_stream(const HufTable& h, const uint8_t* src, int64_t n, uint8_t* out, int64_t count) {
  BackBits br;
  if (!br.init(src, n)) return false;
  int mb = h.maxbits;
  for (int64_t i = 0; i < count; ++i) {
    uint16_t e = h.t[br.peek(mb)];
    out[i] = uint8_t(e >> 8);
    br.pos -= e & 0xff;
  }
  return br.pos == 0;
}

// ---------------------------------------------------------------- sequences
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,   10,   11,
                              12, 13, 14, 15, 16, 18, 20,  22,  24,  28,  32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ---------------------------------------------------------------- frames
struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
};

struct Out {
  uint8_t* dst; int64_t cap; int64_t n; int64_t frame_start;
};

// One sequence-table choice (Symbol_Compression_Modes); returns bytes used or -1.
int64_t seq_table(FseTable& tab, int mode, const uint8_t* p, int64_t n, const int16_t* def,
                  int ndef, int deflog, int maxlog, int maxsym) {
  switch (mode) {
    case 0: return fse_build(tab, def, ndef, deflog) ? 0 : -1;
    case 1:
      if (n < 1 || p[0] > maxsym) return -1;
      fse_rle(tab, p[0]);
      return 1;
    case 2: return fse_read(tab, p, n, maxlog, maxsym);
    default: return tab.valid ? 0 : -2;
  }
}

int64_t compressed_block(FrameState& st, const uint8_t* src, int64_t n, Out& o) {
  static thread_local uint8_t lit[kBlockMax + 64];
  if (n < 1) return kBadLiterals;
  // Literals section.
  int ltype = src[0] & 3, sfmt = (src[0] >> 2) & 3;
  int64_t regen = 0, csize = 0, hlen = 0;
  int streams = 1;
  if (ltype < 2) {
    if (sfmt == 0 || sfmt == 2) { hlen = 1; regen = src[0] >> 3; }
    else if (sfmt == 1) { hlen = 2; if (n < 2) return kTruncated; regen = (src[0] >> 4) + (uint32_t(src[1]) << 4); }
    else { hlen = 3; if (n < 3) return kTruncated; regen = (src[0] >> 4) + (uint32_t(src[1]) << 4) + (uint32_t(src[2]) << 12); }
  } else {
    if (sfmt == 0 || sfmt == 1) {
      hlen = 3; streams = sfmt == 0 ? 1 : 4;
      if (n < 3) return kTruncated;
      uint32_t c = rd24(src);
      regen = (c >> 4) & 0x3ff; csize = (c >> 14) & 0x3ff;
    } else if (sfmt == 2) {
      hlen = 4; streams = 4;
      if (n < 4) return kTruncated;
      uint32_t c = rd32(src);
      regen = (c >> 4) & 0x3fff; csize = (c >> 18) & 0x3fff;
    } else {
      hlen = 5; streams = 4;
      if (n < 5) return kTruncated;
      uint64_t c = rd32(src) | (uint64_t(src[4]) << 32);
      regen = (c >> 4) & 0x3ffff; csize = (c >> 22) & 0x3ffff;
    }
  }
  if (regen > kBlockMax) return kBadLiterals;
  const uint8_t* p = src + hlen;
  int64_t left = n - hlen;
  if (ltype == 0) {
    if (regen > left) return kTruncated;
    std::memcpy(lit, p, regen);
    p += regen; left -= regen;
  } else if (ltype == 1) {
    if (left < 1) return kTruncated;
    std::memset(lit, p[0], regen);
    p += 1; left -= 1;
  } else {
    if (csize > left) return kTruncated;
    const uint8_t* q = p;
    int64_t qn = csize;
    if (ltype == 2) {
      int64_t used = huf_read(st.huf, q, qn);
      if (used < 0) return kBadHuffman;
      q += used; qn -= used;
    } else if (!st.huf.valid) {
      return kNoPreviousTable;
    }
    if (streams == 1) {
      if (!huf_stream(st.huf, q, qn, lit, regen)) return kBadLiterals;
    } else {
      if (qn < 6) return kBadLiterals;
      int64_t s1 = rd16(q), s2 = rd16(q + 2), s3 = rd16(q + 4), s4 = qn - 6 - s1 - s2 - s3;
      if (s4 < 1) return kBadLiterals;
      int64_t seg = (regen + 3) / 4, last = regen - 3 * seg;
      if (last < 0) return kBadLiterals;
      const uint8_t* b = q + 6;
      if (!huf_stream(st.huf, b, s1, lit, seg) ||
          !huf_stream(st.huf, b + s1, s2, lit + seg, seg) ||
          !huf_stream(st.huf, b + s1 + s2, s3, lit + 2 * seg, seg) ||
          !huf_stream(st.huf, b + s1 + s2 + s3, s4, lit + 3 * seg, last))
        return kBadLiterals;
    }
    p += csize; left -= csize;
  }

  // Sequences section.
  if (left < 1) return kTruncated;
  int64_t nseq = p[0];
  if (nseq == 0) { p += 1; left -= 1; }
  else if (nseq < 128) { p += 1; left -= 1; }
  else if (nseq < 255) { if (left < 2) return kTruncated; nseq = ((nseq - 128) << 8) + p[1]; p += 2; left -= 2; }
  else { if (left < 3) return kTruncated; nseq = rd16(p + 1) + 0x7f00; p += 3; left -= 3; }

  int64_t lpos = 0;
  if (nseq > 0) {
    if (left < 1) return kTruncated;
    int modes = p[0];
    if (modes & 3) return kBadSequences;
    p += 1; left -= 1;
    int64_t u;
    if ((u = seq_table(st.ll, modes >> 6, p, left, kLLDefault, 36, 6, 9, 35)) < 0)
      return u == -2 ? kNoPreviousTable : kBadFse;
    p += u; left -= u;
    if ((u = seq_table(st.of, (modes >> 4) & 3, p, left, kOFDefault, 29, 5, 8, 31)) < 0)
      return u == -2 ? kNoPreviousTable : kBadFse;
    p += u; left -= u;
    if ((u = seq_table(st.ml, (modes >> 2) & 3, p, left, kMLDefault, 53, 6, 9, 52)) < 0)
      return u == -2 ? kNoPreviousTable : kBadFse;
    p += u; left -= u;

    BackBits br;
    if (!br.init(p, left)) return kBadBitstream;
    uint32_t sll = br.read(st.ll.log), sof = br.read(st.of.log), sml = br.read(st.ml.log);
    for (int64_t i = 0; i < nseq; ++i) {
      int ofc = st.of.t[sof].sym, mlc = st.ml.t[sml].sym, llc = st.ll.t[sll].sym;
      if (ofc > 31 || mlc > 52 || llc > 35) return kBadSequences;
      uint32_t ofv = (1u << ofc) + br.read(ofc);
      uint32_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
      uint32_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
      uint32_t off;
      if (ofv > 3) {
        off = ofv - 3;
        st.rep[2] = st.rep[1]; st.rep[1] = st.rep[0]; st.rep[0] = off;
      } else {
        int idx = int(ofv) - (ll == 0 ? 0 : 1);  // 0..3: rep[0], rep[1], rep[2], rep[0] - 1
        if (idx == 0) {
          off = st.rep[0];
        } else {
          off = idx == 3 ? st.rep[0] - 1 : st.rep[idx];
          if (off == 0) return kBadOffset;
          if (idx != 1) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = off;
        }
      }
      if (i + 1 < nseq) {
        const FseEntry& el = st.ll.t[sll];
        sll = el.base + br.read(el.nbits);
        const FseEntry& em = st.ml.t[sml];
        sml = em.base + br.read(em.nbits);
        const FseEntry& eo = st.of.t[sof];
        sof = eo.base + br.read(eo.nbits);
      }
      if (br.pos < 0) return kBadBitstream;
      // Execute: literals, then the match.
      if (lpos + ll > regen) return kBadSequences;
      if (o.n + ll + ml > o.cap) return kDstTooSmall;
      std::memcpy(o.dst + o.n, lit + lpos, ll);
      o.n += ll; lpos += ll;
      if (off > o.n - o.frame_start) return kBadOffset;
      uint8_t* d = o.dst + o.n;
      const uint8_t* s = d - off;
      if (off >= ml) std::memcpy(d, s, ml);
      else for (uint32_t k = 0; k < ml; ++k) d[k] = s[k];
      o.n += ml;
    }
    if (br.pos != 0) return kBadBitstream;
  } else if (left != 0) {
    return kBadSequences;
  }
  int64_t rest = regen - lpos;
  if (o.n + rest > o.cap) return kDstTooSmall;
  std::memcpy(o.dst + o.n, lit + lpos, rest);
  o.n += rest;
  return kOk;
}

// Decodes one frame at src; sets *used to the bytes it took.
int64_t frame(const uint8_t* src, int64_t n, Out& o, int64_t* used) {
  if (n < 4) return kTruncated;
  uint32_t magic = rd32(src);
  if ((magic & 0xfffffff0u) == 0x184d2a50u) {  // skippable frame
    if (n < 8) return kTruncated;
    int64_t len = rd32(src + 4);
    if (8 + len > n) return kTruncated;
    *used = 8 + len;
    return kOk;
  }
  if (magic != 0xfd2fb528u) return kBadMagic;
  int64_t i = 4;
  if (n < i + 1) return kTruncated;
  int fhd = src[i++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  if (fhd & 8) return kReservedBit;
  if (!single) i += 1;  // window descriptor: the whole output is addressable here
  static const int kDictBytes[4] = {0, 1, 2, 4};
  int64_t dict = 0;
  if (n < i + kDictBytes[dict_flag]) return kTruncated;
  for (int k = 0; k < kDictBytes[dict_flag]; ++k) dict |= int64_t(src[i + k]) << (8 * k);
  i += kDictBytes[dict_flag];
  if (dict != 0) return kDictionary;
  int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (n < i + fcs_bytes) return kTruncated;
  int64_t fcs = -1;
  if (fcs_bytes == 1) fcs = src[i];
  else if (fcs_bytes == 2) fcs = rd16(src + i) + 256;
  else if (fcs_bytes == 4) fcs = rd32(src + i);
  else if (fcs_bytes == 8) fcs = int64_t(rd64(src + i));
  i += fcs_bytes;

  FrameState* st = new FrameState();
  o.frame_start = o.n;
  int64_t err = kOk;
  for (;;) {
    if (n < i + 3) { err = kTruncated; break; }
    uint32_t bh = rd24(src + i);
    i += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    int64_t size = bh >> 3;
    if (type == 3) { err = kReservedBlock; break; }
    if (size > kBlockMax) { err = kBlockTooLarge; break; }
    if (type == 1) {
      if (n < i + 1) { err = kTruncated; break; }
      if (o.n + size > o.cap) { err = kDstTooSmall; break; }
      std::memset(o.dst + o.n, src[i], size);
      o.n += size;
      i += 1;
    } else {
      if (n < i + size) { err = kTruncated; break; }
      if (type == 0) {
        if (o.n + size > o.cap) { err = kDstTooSmall; break; }
        std::memcpy(o.dst + o.n, src + i, size);
        o.n += size;
      } else if ((err = compressed_block(*st, src + i, size, o)) != kOk) {
        break;
      }
      i += size;
    }
    if (last) break;
  }
  delete st;
  if (err != kOk) return err;
  if (fcs >= 0 && o.n - o.frame_start != fcs) return kContentSize;
  if (checksum) {
    if (n < i + 4) return kTruncated;
    uint32_t want = rd32(src + i);
    if (uint32_t(xxh64(o.dst + o.frame_start, o.n - o.frame_start)) != want) return kChecksum;
    i += 4;
  }
  *used = i;
  return kOk;
}

uint32_t kCrcTable[256];
bool crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82f63b78u & (0u - (c & 1)));
    kCrcTable[i] = c;
  }
  return true;
}
const bool kCrcReady = crc_init();

}  // namespace

extern "C" {

// Decodes every frame in src[0:n] back to back into dst[0:cap]. Returns the
// bytes written, or minus an error code (see vcp_zstd_error).
int64_t vcp_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  Out o{dst, cap, 0, 0};
  int64_t i = 0;
  if (n <= 0) return -kTruncated;
  while (i < n) {
    int64_t used = 0;
    int64_t err = frame(src + i, n - i, o, &used);
    if (err != kOk) return -err;
    i += used;
  }
  return o.n;
}

const char* vcp_zstd_error(int64_t code) {
  if (code < 0) code = -code;
  return code < kNumErrors ? kErrText[code] : "unknown error";
}

uint32_t vcp_crc32c(const uint8_t* p, int64_t n) {
  uint32_t c = 0xffffffffu;
  for (int64_t i = 0; i < n; ++i) c = kCrcTable[(c ^ p[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

}  // extern "C"

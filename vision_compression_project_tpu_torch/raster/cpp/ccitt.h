// CCITTFaxDecode (ITU-T T.4/T.6) for scanned-document PDFs.
//
// Scope: Group 4 (K < 0, pure 2-D MMR — what scanners and `tiffcp -c g4`
// emit and what PDF producers overwhelmingly use for bilevel scans) and
// Group 3 1-D (K = 0, MH run-lengths per row).  Output is the FILTER
// output the PDF imaging model expects: packed 1-bit rows, 0 = black
// (inverted when BlackIs1), so the caller's existing BitsPerComponent==1
// image path applies unchanged.  Reference counterpart: Poppler's
// CCITTFaxStream, reachable from the reference via pdf2image
// (reference backend/app/pipeline/pdf_extract.py:107-122).
//
// EncodedByteAlign and EndOfBlock/EOFB trailers are handled; uncompressed
// mode (rare, T.4 §4.2.1.3.5) is rejected -> decode fails cleanly and the
// caller skips the image.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace ccitt {

struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;  // bit position
  bool ok = true;

  int bit() {
    if (pos >= n * 8) {
      ok = false;
      return 0;
    }
    int b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  // Peek up to 32 bits without consuming (zero-padded past the end).
  uint32_t peek(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) {
      size_t p = pos + i;
      int b = p < n * 8 ? (d[p >> 3] >> (7 - (p & 7))) & 1 : 0;
      v = (v << 1) | b;
    }
    return v;
  }
  void skip(int k) { pos += k; }
  void align() { pos = (pos + 7) & ~size_t(7); }
  bool exhausted() const { return pos >= n * 8; }
};

struct RunCode {
  uint16_t len;   // code length in bits
  uint16_t code;  // MSB-first code value
  uint16_t run;   // run length
};

// T.4 white run codes: terminating (0-63) + makeup (64-1728).
static const RunCode kWhite[] = {
    {8, 0x35, 0},    {6, 0x07, 1},    {4, 0x07, 2},    {4, 0x08, 3},
    {4, 0x0B, 4},    {4, 0x0C, 5},    {4, 0x0E, 6},    {4, 0x0F, 7},
    {5, 0x13, 8},    {5, 0x14, 9},    {5, 0x07, 10},   {5, 0x08, 11},
    {6, 0x08, 12},   {6, 0x03, 13},   {6, 0x34, 14},   {6, 0x35, 15},
    {6, 0x2A, 16},   {6, 0x2B, 17},   {7, 0x27, 18},   {7, 0x0C, 19},
    {7, 0x08, 20},   {7, 0x17, 21},   {7, 0x03, 22},   {7, 0x04, 23},
    {7, 0x28, 24},   {7, 0x2B, 25},   {7, 0x13, 26},   {7, 0x24, 27},
    {7, 0x18, 28},   {8, 0x02, 29},   {8, 0x03, 30},   {8, 0x1A, 31},
    {8, 0x1B, 32},   {8, 0x12, 33},   {8, 0x13, 34},   {8, 0x14, 35},
    {8, 0x15, 36},   {8, 0x16, 37},   {8, 0x17, 38},   {8, 0x28, 39},
    {8, 0x29, 40},   {8, 0x2A, 41},   {8, 0x2B, 42},   {8, 0x2C, 43},
    {8, 0x2D, 44},   {8, 0x04, 45},   {8, 0x05, 46},   {8, 0x0A, 47},
    {8, 0x0B, 48},   {8, 0x52, 49},   {8, 0x53, 50},   {8, 0x54, 51},
    {8, 0x55, 52},   {8, 0x24, 53},   {8, 0x25, 54},   {8, 0x58, 55},
    {8, 0x59, 56},   {8, 0x5A, 57},   {8, 0x5B, 58},   {8, 0x4A, 59},
    {8, 0x4B, 60},   {8, 0x32, 61},   {8, 0x33, 62},   {8, 0x34, 63},
    // makeup
    {5, 0x1B, 64},   {5, 0x12, 128},  {6, 0x17, 192},  {7, 0x37, 256},
    {8, 0x36, 320},  {8, 0x37, 384},  {8, 0x64, 448},  {8, 0x65, 512},
    {8, 0x68, 576},  {8, 0x67, 640},  {9, 0xCC, 704},  {9, 0xCD, 768},
    {9, 0xD2, 832},  {9, 0xD3, 896},  {9, 0xD4, 960},  {9, 0xD5, 1024},
    {9, 0xD6, 1088}, {9, 0xD7, 1152}, {9, 0xD8, 1216}, {9, 0xD9, 1280},
    {9, 0xDA, 1344}, {9, 0xDB, 1408}, {9, 0x98, 1472}, {9, 0x99, 1536},
    {9, 0x9A, 1600}, {6, 0x18, 1664}, {9, 0x9B, 1728},
};

// T.4 black run codes: terminating (0-63) + makeup (64-1728).
static const RunCode kBlack[] = {
    {10, 0x37, 0},    {3, 0x02, 1},     {2, 0x03, 2},     {2, 0x02, 3},
    {3, 0x03, 4},     {4, 0x03, 5},     {4, 0x02, 6},     {5, 0x03, 7},
    {6, 0x05, 8},     {6, 0x04, 9},     {7, 0x04, 10},    {7, 0x05, 11},
    {7, 0x07, 12},    {8, 0x04, 13},    {8, 0x07, 14},    {9, 0x18, 15},
    {10, 0x17, 16},   {10, 0x18, 17},   {10, 0x08, 18},   {11, 0x67, 19},
    {11, 0x68, 20},   {11, 0x6C, 21},   {11, 0x37, 22},   {11, 0x28, 23},
    {11, 0x17, 24},   {11, 0x18, 25},   {12, 0xCA, 26},   {12, 0xCB, 27},
    {12, 0xCC, 28},   {12, 0xCD, 29},   {12, 0x68, 30},   {12, 0x69, 31},
    {12, 0x6A, 32},   {12, 0x6B, 33},   {12, 0xD2, 34},   {12, 0xD3, 35},
    {12, 0xD4, 36},   {12, 0xD5, 37},   {12, 0xD6, 38},   {12, 0xD7, 39},
    {12, 0x6C, 40},   {12, 0x6D, 41},   {12, 0xDA, 42},   {12, 0xDB, 43},
    {12, 0x54, 44},   {12, 0x55, 45},   {12, 0x56, 46},   {12, 0x57, 47},
    {12, 0x64, 48},   {12, 0x65, 49},   {12, 0x52, 50},   {12, 0x53, 51},
    {12, 0x24, 52},   {12, 0x37, 53},   {12, 0x38, 54},   {12, 0x27, 55},
    {12, 0x28, 56},   {12, 0x58, 57},   {12, 0x59, 58},   {12, 0x2B, 59},
    {12, 0x2C, 60},   {12, 0x5A, 61},   {12, 0x66, 62},   {12, 0x67, 63},
    // makeup
    {10, 0x0F, 64},   {12, 0xC8, 128},  {12, 0xC9, 192},  {12, 0x5B, 256},
    {12, 0x33, 320},  {12, 0x34, 384},  {12, 0x35, 448},  {13, 0x6C, 512},
    {13, 0x6D, 576},  {13, 0x4A, 640},  {13, 0x4B, 704},  {13, 0x4C, 768},
    {13, 0x4D, 832},  {13, 0x72, 896},  {13, 0x73, 960},  {13, 0x74, 1024},
    {13, 0x75, 1088}, {13, 0x76, 1152}, {13, 0x77, 1216}, {13, 0x52, 1280},
    {13, 0x53, 1344}, {13, 0x54, 1408}, {13, 0x55, 1472}, {13, 0x5A, 1536},
    {13, 0x5B, 1600}, {13, 0x64, 1664}, {13, 0x65, 1728},
};

// Extended makeup codes (shared by both colors), 1792-2560.
static const RunCode kExt[] = {
    {11, 0x08, 1792}, {11, 0x0C, 1856}, {11, 0x0D, 1920},
    {12, 0x12, 1984}, {12, 0x13, 2048}, {12, 0x14, 2112},
    {12, 0x15, 2176}, {12, 0x16, 2240}, {12, 0x17, 2304},
    {12, 0x1C, 2368}, {12, 0x1D, 2432}, {12, 0x1E, 2496},
    {12, 0x1F, 2560},
};

// Decode ONE run length for `black` color (makeup prefixes accumulate
// until a terminating code, per T.4).  Returns -1 on bad code.
inline long decode_run(BitReader* br, bool black) {
  long total = 0;
  for (int guard = 0; guard < 64; guard++) {
    const RunCode* tab = black ? kBlack : kWhite;
    size_t tab_n = black ? sizeof(kBlack) / sizeof(RunCode)
                         : sizeof(kWhite) / sizeof(RunCode);
    long run = -1;
    // Longest code is 13 bits (black makeup) / 12 (ext); match by length.
    uint32_t window = br->peek(13);
    for (size_t i = 0; i < tab_n && run < 0; i++) {
      if ((window >> (13 - tab[i].len)) == tab[i].code) {
        br->skip(tab[i].len);
        run = tab[i].run;
      }
    }
    for (size_t i = 0; i < sizeof(kExt) / sizeof(RunCode) && run < 0; i++) {
      if ((window >> (13 - kExt[i].len)) == kExt[i].code) {
        br->skip(kExt[i].len);
        run = kExt[i].run;
      }
    }
    if (run < 0) return -1;
    total += run;
    if (run < 64) return total;  // terminating code ends the run
    if (run >= 64 && run % 64 == 0 && run <= 2560) continue;  // makeup
    return total;
  }
  return -1;
}

// Group 4 (T.6) 2-D decode; also used for G3-2D rows.  `ref` and `cur`
// are per-pixel 0(white)/1(black) lines of width w.
inline bool decode_2d_row(BitReader* br, const std::vector<uint8_t>& ref,
                          std::vector<uint8_t>* cur, int w) {
  // Changing elements of the reference line (positions where color flips;
  // position w is the line end sentinel).
  std::vector<int> chg;
  uint8_t prev = 0;  // imaginary white before the line
  for (int i = 0; i < w; i++) {
    if (ref[i] != prev) {
      chg.push_back(i);
      prev = ref[i];
    }
  }
  chg.push_back(w);
  chg.push_back(w);

  int a0 = -1;
  uint8_t color = 0;  // current run color, white first
  std::fill(cur->begin(), cur->end(), 0);
  int guard = 0;  // corrupt streams could stall a0 (e.g. H with 0+0 runs)
  while (a0 < w) {
    if (++guard > 2 * w + 16) return false;
    // b1: first changing element of ref > a0 with color opposite to
    // `color` (i.e. the pixel AT b1 has color != color).
    int b1 = w, b2 = w;
    for (size_t k = 0; k < chg.size(); k++) {
      int c = chg[k];
      if (c <= a0) continue;
      // color of ref at position c (after the change)
      uint8_t cc = c < w ? ref[c] : 0;
      if (cc != color) {
        b1 = c;
        b2 = (k + 1 < chg.size()) ? chg[k + 1] : w;
        break;
      }
    }

    // Mode code.
    if (br->peek(1) == 1) {  // V0: 1
      br->skip(1);
      int a1 = b1;
      for (int i = std::max(a0, 0); i < a1 && i < w; i++) (*cur)[i] = color;
      a0 = a1;
      color ^= 1;
    } else if (br->peek(3) == 0x1) {  // H: 001
      br->skip(3);
      long r1 = decode_run(br, color);
      long r2 = decode_run(br, !color);
      if (r1 < 0 || r2 < 0) return false;
      int s = std::max(a0, 0);
      int a1 = std::min<long>(s + r1, w);
      int a2 = std::min<long>(a1 + r2, w);
      for (int i = s; i < a1; i++) (*cur)[i] = color;
      for (int i = a1; i < a2; i++) (*cur)[i] = color ^ 1;
      a0 = a2;
      // color unchanged (two runs = back to the same color)
    } else if (br->peek(3) == 0x3) {  // VR1: 011
      br->skip(3);
      int a1 = std::min(b1 + 1, w);
      for (int i = std::max(a0, 0); i < a1; i++) (*cur)[i] = color;
      a0 = a1;
      color ^= 1;
    } else if (br->peek(3) == 0x2) {  // VL1: 010
      br->skip(3);
      int a1 = std::max(b1 - 1, 0);
      for (int i = std::max(a0, 0); i < a1; i++) (*cur)[i] = color;
      a0 = a1;
      color ^= 1;
    } else if (br->peek(4) == 0x1) {  // Pass: 0001
      br->skip(4);
      for (int i = std::max(a0, 0); i < b2 && i < w; i++) (*cur)[i] = color;
      a0 = b2;
    } else if (br->peek(6) == 0x3) {  // VR2: 000011
      br->skip(6);
      int a1 = std::min(b1 + 2, w);
      for (int i = std::max(a0, 0); i < a1; i++) (*cur)[i] = color;
      a0 = a1;
      color ^= 1;
    } else if (br->peek(6) == 0x2) {  // VL2: 000010
      br->skip(6);
      int a1 = std::max(b1 - 2, 0);
      for (int i = std::max(a0, 0); i < a1; i++) (*cur)[i] = color;
      a0 = a1;
      color ^= 1;
    } else if (br->peek(7) == 0x3) {  // VR3: 0000011
      br->skip(7);
      int a1 = std::min(b1 + 3, w);
      for (int i = std::max(a0, 0); i < a1; i++) (*cur)[i] = color;
      a0 = a1;
      color ^= 1;
    } else if (br->peek(7) == 0x2) {  // VL3: 0000010
      br->skip(7);
      int a1 = std::max(b1 - 3, 0);
      for (int i = std::max(a0, 0); i < a1; i++) (*cur)[i] = color;
      a0 = a1;
      color ^= 1;
    } else {
      // EOL / EOFB (000000000001...) or garbage: stop.
      return false;
    }
    if (!br->ok) return false;
  }
  return true;
}

// G3 1-D row: alternating white/black MH runs.
inline bool decode_1d_row(BitReader* br, std::vector<uint8_t>* cur, int w) {
  std::fill(cur->begin(), cur->end(), 0);
  int x = 0;
  uint8_t color = 0;
  while (x < w) {
    long r = decode_run(br, color);
    if (r < 0) return false;
    int end = std::min<long>(x + r, w);
    for (int i = x; i < end; i++) (*cur)[i] = color;
    x = end;
    color ^= 1;
  }
  return true;
}

// Decode a CCITTFaxDecode stream into packed 1-bit rows (the standard
// filter output: 0 = black unless black_is_1).  k < 0: G4; k == 0: G3 1-D.
// Returns false on any coding error (caller skips the image).
inline bool decode(const std::string& data, int k, int columns, int rows,
                   bool black_is_1, bool byte_align, std::string* out) {
  if (columns <= 0 || rows <= 0 ||
      static_cast<long>(columns) * rows > 64L * 1024 * 1024)
    return false;
  BitReader br{reinterpret_cast<const uint8_t*>(data.data()), data.size()};
  std::vector<uint8_t> ref(columns, 0), cur(columns, 0);
  long row_bytes = (columns + 7) / 8;
  out->assign(static_cast<size_t>(row_bytes) * rows, 0);
  for (int y = 0; y < rows; y++) {
    if (byte_align) br.align();
    bool row_ok;
    if (k < 0) {
      row_ok = decode_2d_row(&br, ref, &cur, columns);
    } else if (k == 0) {
      // Optional EOL (000000000001) before each row.
      if (br.peek(12) == 0x001) br.skip(12);
      row_ok = decode_1d_row(&br, &cur, columns);
    } else {
      // G3 2-D (K > 0): EOL + 1 tag bit selects 1-D/2-D per row.
      if (br.peek(12) == 0x001) {
        br.skip(12);
        int is_1d = br.bit();
        row_ok = is_1d ? decode_1d_row(&br, &cur, columns)
                       : decode_2d_row(&br, ref, &cur, columns);
      } else {
        row_ok = decode_2d_row(&br, ref, &cur, columns);
      }
    }
    if (!row_ok) return false;
    uint8_t* orow = reinterpret_cast<uint8_t*>(&(*out)[0]) + y * row_bytes;
    for (int x = 0; x < columns; x++) {
      // Filter output convention: 0 bits = black by default.
      int bit = black_is_1 ? cur[x] : (cur[x] ^ 1);
      if (bit) orow[x >> 3] |= 0x80 >> (x & 7);
    }
    std::swap(ref, cur);
  }
  return true;
}

}  // namespace ccitt

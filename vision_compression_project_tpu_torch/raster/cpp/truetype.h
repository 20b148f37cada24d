// Embedded-TrueType (FontFile2) glyph rasterizer.
//
// Round 1 approximated every PDF font with a built-in bitmap atlas
// (font.h); real documents embed subset TrueType fonts whose glyphs that
// atlas cannot reproduce (the reference rendered them via Poppler's font
// stack).  This parses the tables needed to rasterize text: head (units,
// loca format), loca, glyf (simple + composite outlines), cmap (formats
// 0/4/6/12) for char->glyph, hmtx/hhea for advances, maxp for glyph count.
// Outlines (quadratic beziers) are flattened and filled with a non-zero
// winding scanline at the target pixel size.  Unsupported constructs fail
// per-glyph, never crash.

#ifndef VCPR_TRUETYPE_H_
#define VCPR_TRUETYPE_H_

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace vcpr {

class TtfFont {
 public:
  bool parse(const std::string& data) {
    d_ = reinterpret_cast<const uint8_t*>(data.data());
    n_ = data.size();
    if (n_ < 12) return false;
    uint32_t tag = u32(0);
    size_t base = 0;
    if (tag == 0x74746366) {  // 'ttcf': first font of a collection
      if (n_ < 16) return false;
      base = u32(12);
      if (base + 12 > n_) return false;
    }
    uint32_t sfnt = u32(base);
    if (sfnt != 0x00010000 && sfnt != 0x74727565) return false;  // 'true'
    int num_tables = u16(base + 4);
    for (int i = 0; i < num_tables; i++) {
      size_t rec = base + 12 + static_cast<size_t>(i) * 16;
      if (rec + 16 > n_) return false;
      uint32_t t = u32(rec);
      uint32_t off = u32(rec + 8), len = u32(rec + 12);
      if (off > n_ || static_cast<size_t>(off) + len > n_) continue;
      tables_[t] = {off, len};
    }
    auto head = tables_.find(0x68656164);  // 'head'
    auto maxp = tables_.find(0x6d617870);  // 'maxp'
    auto loca = tables_.find(0x6c6f6361);  // 'loca'
    auto glyf = tables_.find(0x676c7966);  // 'glyf'
    if (head == tables_.end() || maxp == tables_.end() ||
        loca == tables_.end() || glyf == tables_.end())
      return false;
    units_per_em_ = u16(head->second.off + 18);
    if (units_per_em_ == 0) units_per_em_ = 1000;
    loc_format_ = static_cast<int16_t>(u16(head->second.off + 50));
    num_glyphs_ = u16(maxp->second.off + 4);
    loca_off_ = loca->second.off;
    loca_len_ = loca->second.len;
    glyf_off_ = glyf->second.off;
    glyf_len_ = glyf->second.len;
    parse_cmap();
    parse_hmtx();
    return true;
  }

  bool ok() const { return num_glyphs_ > 0; }
  int units_per_em() const { return units_per_em_; }
  int num_glyphs() const { return num_glyphs_; }

  // Unicode codepoint -> glyph id (0 if unmapped / no cmap).
  int glyph_for_codepoint(uint32_t cp) const {
    auto it = cmap_.find(cp);
    return it == cmap_.end() ? 0 : it->second;
  }

  bool has_cmap() const { return !cmap_.empty(); }

  // Advance width in font units.
  int advance(int gid) const {
    if (advances_.empty()) return units_per_em_ / 2;
    if (gid < static_cast<int>(advances_.size())) return advances_[gid];
    return advances_.back();
  }

  // Rasterize glyph `gid` at `scale` px/unit with subpixel origin (ox, oy)
  // [device px, y down, baseline at oy].  Blends `gray` into the RGB8 image
  // wherever the glyph covers.
  void rasterize(int gid, double scale, double ox, double oy,
                 unsigned char* img, int W, int H, unsigned char gray) const {
    std::vector<Edge> edges;
    if (!collect_edges(gid, scale, ox, oy, 0, edges) || edges.empty()) return;
    fill_edges(edges, img, W, H, gray);
  }

 private:
  struct TableLoc { uint32_t off = 0, len = 0; };
  struct Edge { double x0, y0, x1, y1; };  // device px, y down

  uint16_t u16(size_t p) const {
    return p + 2 <= n_ ? (d_[p] << 8) | d_[p + 1] : 0;
  }
  int16_t s16(size_t p) const { return static_cast<int16_t>(u16(p)); }
  uint32_t u32(size_t p) const {
    return p + 4 <= n_ ? (static_cast<uint32_t>(d_[p]) << 24) |
                             (d_[p + 1] << 16) | (d_[p + 2] << 8) | d_[p + 3]
                       : 0;
  }

  void parse_cmap() {
    auto it = tables_.find(0x636d6170);  // 'cmap'
    if (it == tables_.end()) return;
    size_t cm = it->second.off;
    int ntab = u16(cm + 2);
    size_t best = 0;
    int best_score = -1;
    for (int i = 0; i < ntab; i++) {
      size_t rec = cm + 4 + static_cast<size_t>(i) * 8;
      int plat = u16(rec), enc = u16(rec + 2);
      uint32_t off = u32(rec + 4);
      int score = -1;
      if (plat == 3 && enc == 10) score = 5;       // UCS-4
      else if (plat == 3 && enc == 1) score = 4;   // BMP unicode
      else if (plat == 0) score = 3;               // unicode
      else if (plat == 3 && enc == 0) score = 2;   // symbol
      else if (plat == 1 && enc == 0) score = 1;   // mac roman
      if (score > best_score) { best_score = score; best = cm + off; }
    }
    if (best_score < 0) return;
    int fmt = u16(best);
    if (fmt == 4) {
      int segx2 = u16(best + 6);
      size_t ends = best + 14;
      size_t starts = ends + segx2 + 2;
      size_t deltas = starts + segx2;
      size_t ranges = deltas + segx2;
      for (int s = 0; s < segx2 / 2; s++) {
        uint32_t end = u16(ends + 2 * s), start = u16(starts + 2 * s);
        int16_t delta = s16(deltas + 2 * s);
        uint16_t ro = u16(ranges + 2 * s);
        if (start > end || end == 0xFFFF) { if (start == 0xFFFF) break; }
        for (uint32_t c = start; c <= end && c - start < 65536; c++) {
          int gid;
          if (ro == 0) {
            gid = (c + delta) & 0xFFFF;
          } else {
            size_t gp = ranges + 2 * s + ro + 2 * (c - start);
            gid = u16(gp);
            if (gid) gid = (gid + delta) & 0xFFFF;
          }
          if (gid) cmap_[c] = gid;
          if (c == 0xFFFF) break;
        }
      }
    } else if (fmt == 12) {
      uint32_t ngroups = u32(best + 12);
      for (uint32_t g = 0; g < ngroups && g < 100000; g++) {
        size_t rec = best + 16 + static_cast<size_t>(g) * 12;
        uint32_t s0 = u32(rec), e0 = u32(rec + 4), gid0 = u32(rec + 8);
        for (uint32_t c = s0; c <= e0 && c - s0 < 65536; c++)
          cmap_[c] = gid0 + (c - s0);
      }
    } else if (fmt == 6) {
      uint32_t first = u16(best + 6);
      int cnt = u16(best + 8);
      for (int i = 0; i < cnt; i++) {
        int gid = u16(best + 10 + 2 * i);
        if (gid) cmap_[first + i] = gid;
      }
    } else if (fmt == 0) {
      for (int c = 0; c < 256; c++) {
        int gid = d_[best + 6 + c];
        if (gid) cmap_[c] = gid;
      }
    }
  }

  void parse_hmtx() {
    auto hhea = tables_.find(0x68686561);
    auto hmtx = tables_.find(0x686d7478);
    if (hhea == tables_.end() || hmtx == tables_.end()) return;
    int num_h = u16(hhea->second.off + 34);
    advances_.resize(std::max(1, num_h));
    for (int i = 0; i < num_h; i++)
      advances_[i] = u16(hmtx->second.off + 4 * i);
  }

  bool glyph_range(int gid, size_t* off, size_t* len) const {
    if (gid < 0 || gid >= num_glyphs_) return false;
    uint32_t o0, o1;
    if (loc_format_ == 0) {
      if (loca_off_ + 2 * (gid + 1) + 2 > n_) return false;
      o0 = 2u * u16(loca_off_ + 2 * gid);
      o1 = 2u * u16(loca_off_ + 2 * (gid + 1));
    } else {
      if (loca_off_ + 4 * (gid + 1) + 4 > n_) return false;
      o0 = u32(loca_off_ + 4 * gid);
      o1 = u32(loca_off_ + 4 * (gid + 1));
    }
    if (o1 <= o0) { *off = 0; *len = 0; return true; }  // empty glyph
    if (static_cast<size_t>(glyf_off_) + o1 > n_) return false;
    *off = glyf_off_ + o0;
    *len = o1 - o0;
    return true;
  }

  // Flatten one glyph's outline (recursing into composites) into edges.
  bool collect_edges(int gid, double scale, double ox, double oy, int depth,
                     std::vector<Edge>& edges) const {
    if (depth > 5) return false;
    size_t off, len;
    if (!glyph_range(gid, &off, &len)) return false;
    if (len == 0) return true;  // whitespace glyph
    int ncont = s16(off);
    if (ncont < 0) {  // composite
      size_t p = off + 10;
      while (true) {
        uint16_t flags = u16(p), comp_gid = u16(p + 2);
        p += 4;
        double dx = 0, dy = 0;
        if (flags & 1) {  // ARG_1_AND_2_ARE_WORDS
          if (flags & 2) { dx = s16(p); dy = s16(p + 2); }
          p += 4;
        } else {
          if (flags & 2) {
            dx = static_cast<int8_t>(d_[p]);
            dy = static_cast<int8_t>(d_[p + 1]);
          }
          p += 2;
        }
        // Component scales (2x2 ignored for simplicity beyond uniform).
        double cs = 1.0;
        if (flags & 8) { cs = s16(p) / 16384.0; p += 2; }
        else if (flags & 0x40) { p += 4; }
        else if (flags & 0x80) { p += 8; }
        (void)cs;
        collect_edges(comp_gid, scale, ox + dx * scale, oy - dy * scale,
                      depth + 1, edges);
        if (!(flags & 0x20)) break;  // MORE_COMPONENTS
      }
      return true;
    }
    size_t p = off + 10;
    std::vector<int> cont_ends(ncont);
    for (int i = 0; i < ncont; i++) { cont_ends[i] = u16(p); p += 2; }
    int npts = ncont ? cont_ends.back() + 1 : 0;
    if (npts <= 0 || npts > 10000) return false;
    int ilen = u16(p);
    p += 2 + ilen;  // skip instructions
    // Flags (with repeats).
    std::vector<uint8_t> flags;
    flags.reserve(npts);
    while (static_cast<int>(flags.size()) < npts && p < n_) {
      uint8_t f = d_[p++];
      flags.push_back(f);
      if (f & 8) {
        int rep = d_[p++];
        for (int r = 0; r < rep && static_cast<int>(flags.size()) < npts; r++)
          flags.push_back(f);
      }
    }
    if (static_cast<int>(flags.size()) != npts) return false;
    // Coordinates.
    std::vector<double> xs(npts), ys(npts);
    int v = 0;
    for (int i = 0; i < npts; i++) {
      uint8_t f = flags[i];
      if (f & 2) { int dx = d_[p++]; v += (f & 16) ? dx : -dx; }
      else if (!(f & 16)) { v += s16(p); p += 2; }
      xs[i] = v;
    }
    v = 0;
    for (int i = 0; i < npts; i++) {
      uint8_t f = flags[i];
      if (f & 4) { int dy = d_[p++]; v += (f & 32) ? dy : -dy; }
      else if (!(f & 32)) { v += s16(p); p += 2; }
      ys[i] = v;
    }
    // Emit contours: on-curve / quadratic off-curve points.
    auto dev = [&](double fx, double fy, double* px, double* py) {
      *px = ox + fx * scale;
      *py = oy - fy * scale;  // y down
    };
    int start = 0;
    for (int ci = 0; ci < ncont; ci++) {
      int end = cont_ends[ci];
      int cn = end - start + 1;
      if (cn < 2) { start = end + 1; continue; }
      // Build the expanded on/off point sequence with implied midpoints.
      std::vector<std::pair<double, double>> pts;
      std::vector<bool> on;
      for (int i = 0; i < cn; i++) {
        int idx = start + i;
        bool is_on = flags[idx] & 1;
        if (!pts.empty() && !on.back() && !is_on) {
          pts.push_back({(pts.back().first + xs[idx]) / 2,
                         (pts.back().second + ys[idx]) / 2});
          on.push_back(true);
        }
        pts.push_back({xs[idx], ys[idx]});
        on.push_back(is_on);
      }
      // Rotate so sequence starts on-curve.
      if (!on.empty() && !on[0]) {
        if (on.back()) {
          pts.insert(pts.begin(), pts.back());
          on.insert(on.begin(), true);
          pts.pop_back();
          on.pop_back();
        } else {
          pts.insert(pts.begin(),
                     {(pts[0].first + pts.back().first) / 2,
                      (pts[0].second + pts.back().second) / 2});
          on.insert(on.begin(), true);
        }
      }
      size_t m = pts.size();
      auto add_line = [&](double x0, double y0, double x1, double y1) {
        double a, b, c2, d2;
        dev(x0, y0, &a, &b);
        dev(x1, y1, &c2, &d2);
        if (b != d2) edges.push_back({a, b, c2, d2});
      };
      auto add_quad = [&](double x0, double y0, double cx, double cy,
                          double x1, double y1) {
        int segs = 8;
        double px = x0, py = y0;
        for (int t = 1; t <= segs; t++) {
          double u = static_cast<double>(t) / segs, w = 1 - u;
          double qx = w * w * x0 + 2 * w * u * cx + u * u * x1;
          double qy = w * w * y0 + 2 * w * u * cy + u * u * y1;
          add_line(px, py, qx, qy);
          px = qx;
          py = qy;
        }
      };
      for (size_t i = 0; i < m;) {
        size_t nx = (i + 1) % m;
        if (on[nx]) {
          add_line(pts[i].first, pts[i].second, pts[nx].first, pts[nx].second);
          i++;
        } else {
          size_t nn = (i + 2) % m;
          add_quad(pts[i].first, pts[i].second, pts[nx].first, pts[nx].second,
                   pts[nn].first, pts[nn].second);
          i += 2;
        }
      }
      start = end + 1;
    }
    return true;
  }

  // Non-zero-winding scanline fill of device-space edges.
  static void fill_edges(std::vector<Edge>& edges, unsigned char* img, int W,
                         int H, unsigned char gray) {
    // Anti-aliased nonzero fill: 4 vertical subsamples per scanline with
    // exact horizontal coverage, blended over the framebuffer — small
    // glyphs (12pt text at model DPI) keep their shape instead of
    // thresholding to blobs, matching what standard rasterizers feed OCR.
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

  const uint8_t* d_ = nullptr;
  size_t n_ = 0;
  std::map<uint32_t, TableLoc> tables_;
  std::map<uint32_t, int> cmap_;
  std::vector<int> advances_;
  int units_per_em_ = 1000;
  int loc_format_ = 0;
  int num_glyphs_ = 0;
  uint32_t loca_off_ = 0, loca_len_ = 0, glyf_off_ = 0, glyf_len_ = 0;
};

}  // namespace vcpr

#endif  // VCPR_TRUETYPE_H_

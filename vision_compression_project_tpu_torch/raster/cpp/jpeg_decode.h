// JPEG (DCTDecode) decoder for image XObjects.
//
// The reference delegated all raster work to Poppler, which carries libjpeg
// (reference: backend/Dockerfile:4-6 poppler-utils); this engine is
// self-contained, so scanned-document PDFs need an in-tree decoder.  Scope:
// baseline (SOF0/SOF1) and PROGRESSIVE (SOF2) DCT, 8-bit, 1/3/4 components
// (grayscale / YCbCr / Adobe CMYK+YCCK), any H/V subsampling up to 2x2,
// restart intervals, interleaved and single-component scans, spectral
// selection and successive approximation.  Scans accumulate raw DCT
// coefficients; dequantization + IDCT run once at the end.  Arithmetic
// coding and 12-bit fail gracefully (caller leaves the region blank).
// ~zero-dependency, correctness over speed: images decode once per open.

#ifndef VCPR_JPEG_DECODE_H_
#define VCPR_JPEG_DECODE_H_

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace vcpr {

class JpegDecoder {
 public:
  // Decodes to 8-bit interleaved (gray or RGB).  Returns false on any
  // unsupported construct or corruption.
  bool decode(const std::string& data, std::vector<uint8_t>* out, int* width,
              int* height, int* comps) {
    d_ = reinterpret_cast<const uint8_t*>(data.data());
    n_ = data.size();
    p_ = 0;
    if (!expect_marker(0xD8)) return false;  // SOI
    while (p_ + 4 <= n_) {
      int m = next_marker();
      if (m < 0) return false;
      if (m == 0xD9) break;  // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // standalone
      size_t len = read_u16();
      size_t seg_end = p_ + len - 2;
      if (len < 2 || seg_end > n_) return false;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:  // progressive: scans accumulate, IDCT deferred
          if (!parse_sof()) return false;
          break;
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          return false;  // lossless / arithmetic frame types
        case 0xC4:
          if (!parse_dht(seg_end)) return false;
          break;
        case 0xDB:
          if (!parse_dqt(seg_end)) return false;
          break;
        case 0xDD:
          restart_interval_ = read_u16();
          break;
        case 0xDA:
          if (!parse_sos()) return false;
          if (!decode_scan()) return false;
          scans_++;
          continue;  // p_ sits at the next marker; more scans may follow
        case 0xEE:  // APP14 "Adobe": carries the CMYK/YCCK transform flag
          if (seg_end - p_ >= 11 && memcmp(d_ + p_, "Adobe", 5) == 0) {
            adobe_present_ = true;
            adobe_transform_ = d_[seg_end - 1];
          }
          break;
        default:
          break;  // APPn/COM/etc: skip
      }
      p_ = seg_end;
    }
    if (!scans_ || width_ <= 0) return false;
    idct_all();
    return finish(out, width, height, comps);
  }

 private:
  struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;
    int bx = 0, by = 0;          // blocks per MCU row/col over full image
    std::vector<int16_t> coef;   // decoded samples (post-IDCT), bx*8 x by*8
    std::vector<int> dct;        // raw coefficients, natural order, /block
    int pred = 0;                // DC predictor
  };

  struct Huff {
    // Canonical code table; decode bit-by-bit (fixtures are small).
    int mincode[17], maxcode[18], valptr[17];
    std::vector<uint8_t> vals;
    bool present = false;
  };

  const uint8_t* d_ = nullptr;
  size_t n_ = 0, p_ = 0;
  int width_ = 0, height_ = 0;
  int ncomp_ = 0;
  Component comp_[4];
  uint16_t qt_[4][64] = {};
  Huff hdc_[4], hac_[4];
  int restart_interval_ = 0;
  bool adobe_present_ = false;
  int adobe_transform_ = 0;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  // bit reader state
  uint32_t bitbuf_ = 0;
  int bitcnt_ = 0;

  static const int kZigZag[64];

  bool expect_marker(int code) {
    if (p_ + 2 > n_ || d_[p_] != 0xFF || d_[p_ + 1] != code) return false;
    p_ += 2;
    return true;
  }

  int next_marker() {
    while (p_ + 2 <= n_) {
      if (d_[p_] != 0xFF) { p_++; continue; }
      size_t q = p_ + 1;
      while (q < n_ && d_[q] == 0xFF) q++;
      if (q >= n_) return -1;
      if (d_[q] == 0) { p_ = q + 1; continue; }  // stuffed byte
      p_ = q + 1;
      return d_[q];
    }
    return -1;
  }

  int read_u16() {
    if (p_ + 2 > n_) return -1;
    int v = (d_[p_] << 8) | d_[p_ + 1];
    p_ += 2;
    return v;
  }

  bool parse_sof() {
    if (p_ + 6 > n_) return false;
    int prec = d_[p_++];
    if (prec != 8) return false;
    height_ = (d_[p_] << 8) | d_[p_ + 1];
    width_ = (d_[p_ + 2] << 8) | d_[p_ + 3];
    p_ += 4;
    ncomp_ = d_[p_++];
    // 4 components = Adobe CMYK / YCCK (scanned color documents).
    if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4) return false;
    for (int i = 0; i < ncomp_; i++) {
      if (p_ + 3 > n_) return false;
      comp_[i].id = d_[p_];
      comp_[i].h = d_[p_ + 1] >> 4;
      comp_[i].v = d_[p_ + 1] & 15;
      comp_[i].tq = d_[p_ + 2];
      if (comp_[i].h < 1 || comp_[i].h > 2 || comp_[i].v < 1 || comp_[i].v > 2)
        return false;
      hmax_ = std::max(hmax_, comp_[i].h);
      vmax_ = std::max(vmax_, comp_[i].v);
      p_ += 3;
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int i = 0; i < ncomp_; i++) {
      comp_[i].bx = mcux_ * comp_[i].h;
      comp_[i].by = mcuy_ * comp_[i].v;
      comp_[i].coef.assign(static_cast<size_t>(comp_[i].bx) * 8 *
                               comp_[i].by * 8,
                           0);
      comp_[i].dct.assign(
          static_cast<size_t>(comp_[i].bx) * comp_[i].by * 64, 0);
    }
    return width_ > 0 && height_ > 0;
  }

  bool parse_dqt(size_t seg_end) {
    while (p_ < seg_end) {
      int pq = d_[p_] >> 4, tq = d_[p_] & 15;
      p_++;
      if (tq > 3) return false;
      for (int i = 0; i < 64; i++) {
        if (pq) {
          qt_[tq][kZigZag[i]] = (d_[p_] << 8) | d_[p_ + 1];
          p_ += 2;
        } else {
          qt_[tq][kZigZag[i]] = d_[p_++];
        }
      }
    }
    return true;
  }

  bool parse_dht(size_t seg_end) {
    while (p_ < seg_end) {
      int tc = d_[p_] >> 4, th = d_[p_] & 15;
      p_++;
      if (th > 3 || tc > 1) return false;
      Huff* h = tc ? &hac_[th] : &hdc_[th];
      int counts[17] = {};
      int total = 0;
      for (int i = 1; i <= 16; i++) {
        counts[i] = d_[p_++];
        total += counts[i];
      }
      if (p_ + total > n_) return false;
      h->vals.assign(d_ + p_, d_ + p_ + total);
      p_ += total;
      int code = 0, k = 0;
      for (int l = 1; l <= 16; l++) {
        h->valptr[l] = k;
        h->mincode[l] = code;
        code += counts[l];
        k += counts[l];
        h->maxcode[l] = counts[l] ? code - 1 : -1;
        code <<= 1;
      }
      h->maxcode[17] = 0x7fffffff;
      h->present = true;
    }
    return true;
  }

  int scan_comp_[4], nscan_ = 0;
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;  // spectral/approx params
  int scans_ = 0;
  unsigned eobrun_ = 0;

  bool parse_sos() {
    if (p_ >= n_) return false;
    nscan_ = d_[p_++];
    if (nscan_ < 1 || nscan_ > ncomp_) return false;
    for (int i = 0; i < nscan_; i++) {
      int cid = d_[p_], tables = d_[p_ + 1];
      p_ += 2;
      int ci = -1;
      for (int j = 0; j < ncomp_; j++)
        if (comp_[j].id == cid) ci = j;
      if (ci < 0) return false;
      scan_comp_[i] = ci;
      comp_[ci].td = tables >> 4;
      comp_[ci].ta = tables & 15;
    }
    if (p_ + 3 > n_) return false;
    ss_ = d_[p_];
    se_ = d_[p_ + 1];
    ah_ = d_[p_ + 2] >> 4;
    al_ = d_[p_ + 2] & 15;
    p_ += 3;
    if (ss_ > 63 || se_ > 63 || se_ < ss_) return false;
    // AC scans are single-component by spec.
    if (ss_ > 0 && nscan_ != 1) return false;
    return true;
  }

  // -- entropy-coded segment ------------------------------------------------

  int next_bit() {
    if (bitcnt_ == 0) {
      if (p_ >= n_) return -1;
      uint8_t b = d_[p_++];
      if (b == 0xFF) {
        if (p_ < n_ && d_[p_] == 0x00) {
          p_++;  // stuffed
        } else {
          // Marker inside ECS: back up, signal end.
          p_--;
          return -1;
        }
      }
      bitbuf_ = b;
      bitcnt_ = 8;
    }
    bitcnt_--;
    return (bitbuf_ >> bitcnt_) & 1;
  }

  int decode_huff(const Huff& h) {
    if (!h.present) return -1;
    int code = 0;
    for (int l = 1; l <= 16; l++) {
      int b = next_bit();
      if (b < 0) return -1;
      code = (code << 1) | b;
      if (h.maxcode[l] >= 0 && code <= h.maxcode[l] && code >= h.mincode[l])
        return h.vals[h.valptr[l] + code - h.mincode[l]];
    }
    return -1;
  }

  int receive_extend(int ssss) {
    if (ssss == 0) return 0;
    int v = 0;
    for (int i = 0; i < ssss; i++) {
      int b = next_bit();
      if (b < 0) return 0;
      v = (v << 1) | b;
    }
    if (v < (1 << (ssss - 1))) v += -(1 << ssss) + 1;
    return v;
  }

  void idct_block(const int* in, int16_t* out, int out_stride) {
    // Separable float IDCT; correctness-first (images decode once).
    static float cs[8][8];
    static bool init = false;
    if (!init) {
      for (int x = 0; x < 8; x++)
        for (int u = 0; u < 8; u++)
          cs[x][u] = static_cast<float>(
              (u == 0 ? 0.353553390593f : 0.5f) *
              cos((2 * x + 1) * u * M_PI / 16.0));
      init = true;
    }
    float tmp[64];
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) {
        float s = 0;
        for (int u = 0; u < 8; u++) s += cs[x][u] * in[y * 8 + u];
        tmp[y * 8 + x] = s;
      }
    for (int x = 0; x < 8; x++)
      for (int y = 0; y < 8; y++) {
        float s = 0;
        for (int v = 0; v < 8; v++) s += cs[y][v] * tmp[v * 8 + x];
        int val = static_cast<int>(lrintf(s)) + 128;
        out[y * out_stride + x] =
            static_cast<int16_t>(val < 0 ? 0 : (val > 255 ? 255 : val));
      }
  }

  int receive_raw(int nbits) {
    int v = 0;
    for (int i = 0; i < nbits; i++) {
      int b = next_bit();
      if (b < 0) return v;
      v = (v << 1) | b;
    }
    return v;
  }

  // One block of the CURRENT scan (spectral window ss_..se_, approximation
  // ah_/al_) into the block's raw-coefficient slot.  Baseline is the
  // special case ss_=0, se_=63, ah_=al_=0.
  bool decode_block_spectral(Component* c, int* blk) {
    if (ss_ == 0) {
      if (ah_ == 0) {  // DC first pass
        int t = decode_huff(hdc_[c->td]);
        if (t < 0) return false;
        c->pred += receive_extend(t);
        blk[0] = c->pred << al_;
      } else {  // DC refinement: one bit
        int b = next_bit();
        if (b < 0) return false;
        if (b) blk[0] |= 1 << al_;
      }
      if (se_ == 0) return true;
    }
    int kstart = std::max(ss_, 1);
    if (ah_ == 0) {  // AC first pass
      if (eobrun_ > 0) {
        eobrun_--;
        return true;
      }
      for (int k = kstart; k <= se_;) {
        int rs = decode_huff(hac_[c->ta]);
        if (rs < 0) return false;
        int r = rs >> 4, sz = rs & 15;
        if (sz == 0) {
          if (r == 15) {
            k += 16;
            continue;
          }
          eobrun_ = (1u << r) - 1;
          if (r) eobrun_ += receive_raw(r);
          return true;
        }
        k += r;
        if (k > se_) return false;
        blk[kZigZag[k]] = receive_extend(sz) << al_;
        k++;
      }
      return true;
    }
    // AC refinement (successive approximation, libjpeg algorithm).
    int p1 = 1 << al_, m1 = -(1 << al_);
    int k = kstart;
    if (eobrun_ == 0) {
      while (k <= se_) {
        int rs = decode_huff(hac_[c->ta]);
        if (rs < 0) return false;
        int r = rs >> 4, sz = rs & 15;
        int val = 0;
        if (sz == 0) {
          if (r != 15) {
            eobrun_ = (1u << r);
            if (r) eobrun_ += receive_raw(r);
            break;
          }
          // ZRL: skip 16 zero-history coefficients (with corrections).
        } else {
          int b = next_bit();
          if (b < 0) return false;
          val = b ? p1 : m1;
        }
        while (k <= se_) {
          int zz = kZigZag[k];
          if (blk[zz] != 0) {
            int b = next_bit();
            if (b < 0) return false;
            if (b && (blk[zz] & p1) == 0)
              blk[zz] += blk[zz] >= 0 ? p1 : m1;
          } else {
            if (r == 0) {
              if (val) blk[zz] = val;
              k++;
              break;
            }
            r--;
          }
          k++;
        }
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se_; k++) {
        int zz = kZigZag[k];
        if (blk[zz] != 0) {
          int b = next_bit();
          if (b < 0) return false;
          if (b && (blk[zz] & p1) == 0)
            blk[zz] += blk[zz] >= 0 ? p1 : m1;
        }
      }
      eobrun_--;
    }
    return true;
  }

  void restart_state() {
    bitcnt_ = 0;
    eobrun_ = 0;
    if (p_ + 2 <= n_ && d_[p_] == 0xFF && d_[p_ + 1] >= 0xD0 &&
        d_[p_ + 1] <= 0xD7)
      p_ += 2;
    for (int i = 0; i < ncomp_; i++) comp_[i].pred = 0;
  }

  int* block_ptr(Component* c, int byi, int bxi) {
    return &c->dct[(static_cast<size_t>(byi) * c->bx + bxi) * 64];
  }

  bool decode_scan() {
    bitcnt_ = 0;
    eobrun_ = 0;
    for (int i = 0; i < nscan_; i++) comp_[scan_comp_[i]].pred = 0;
    if (nscan_ == 1) {
      // Non-interleaved: the component's own block grid in raster order.
      Component* c = &comp_[scan_comp_[0]];
      int cw = (width_ * c->h + 8 * hmax_ - 1) / (8 * hmax_);
      int ch = (height_ * c->v + 8 * vmax_ - 1) / (8 * vmax_);
      int unit = 0;
      for (int byi = 0; byi < ch; byi++)
        for (int bxi = 0; bxi < cw; bxi++) {
          if (!decode_block_spectral(c, block_ptr(c, byi, bxi)))
            return false;
          unit++;
          if (restart_interval_ && unit % restart_interval_ == 0 &&
              unit < cw * ch)
            restart_state();
        }
      return true;
    }
    int mcu = 0, total_mcu = mcux_ * mcuy_;
    while (mcu < total_mcu) {
      for (int s = 0; s < nscan_; s++) {
        Component* c = &comp_[scan_comp_[s]];
        for (int by = 0; by < c->v; by++)
          for (int bx = 0; bx < c->h; bx++) {
            int bxi = (mcu % mcux_) * c->h + bx;
            int byi = (mcu / mcux_) * c->v + by;
            if (!decode_block_spectral(c, block_ptr(c, byi, bxi)))
              return false;
          }
      }
      mcu++;
      if (restart_interval_ && mcu % restart_interval_ == 0 &&
          mcu < total_mcu)
        restart_state();
    }
    return true;
  }

  void idct_all() {
    int tmp[64];
    for (int i = 0; i < ncomp_; i++) {
      Component& c = comp_[i];
      int stride = c.bx * 8;
      for (int byi = 0; byi < c.by; byi++)
        for (int bxi = 0; bxi < c.bx; bxi++) {
          const int* blk = block_ptr(&c, byi, bxi);
          for (int k = 0; k < 64; k++) tmp[k] = blk[k] * qt_[c.tq][k];
          idct_block(tmp,
                     &c.coef[static_cast<size_t>(byi) * 8 * stride + bxi * 8],
                     stride);
        }
    }
  }

  static uint8_t clamp8(int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }

  bool finish(std::vector<uint8_t>* out, int* width, int* height, int* comps) {
    *width = width_;
    *height = height_;
    *comps = ncomp_ == 1 ? 1 : 3;
    out->resize(static_cast<size_t>(width_) * height_ * *comps);
    for (int y = 0; y < height_; y++) {
      for (int x = 0; x < width_; x++) {
        int vals[4] = {0, 0, 0, 0};
        for (int i = 0; i < ncomp_; i++) {
          Component& c = comp_[i];
          int sx = x * c.h / hmax_;
          int sy = y * c.v / vmax_;
          vals[i] = c.coef[static_cast<size_t>(sy) * c.bx * 8 + sx];
        }
        uint8_t* px = out->data() + (static_cast<size_t>(y) * width_ + x) * *comps;
        if (ncomp_ == 1) {
          px[0] = static_cast<uint8_t>(vals[0]);
        } else if (ncomp_ == 3) {
          double Y = vals[0], Cb = vals[1] - 128.0, Cr = vals[2] - 128.0;
          px[0] = clamp8(static_cast<int>(lrint(Y + 1.402 * Cr)));
          px[1] = clamp8(
              static_cast<int>(lrint(Y - 0.344136 * Cb - 0.714136 * Cr)));
          px[2] = clamp8(static_cast<int>(lrint(Y + 1.772 * Cb)));
        } else {
          // CMYK (Adobe transform 0) or YCCK (transform 2).  Adobe writers
          // store the CMYK channels INVERTED (libjpeg convention).
          int c = vals[0], m = vals[1], yy = vals[2], k = vals[3];
          if (adobe_transform_ == 2) {
            double Y = vals[0], Cb = vals[1] - 128.0, Cr = vals[2] - 128.0;
            c = clamp8(static_cast<int>(lrint(Y + 1.402 * Cr)));
            m = clamp8(
                static_cast<int>(lrint(Y - 0.344136 * Cb - 0.714136 * Cr)));
            yy = clamp8(static_cast<int>(lrint(Y + 1.772 * Cb)));
          }
          if (adobe_present_) {
            c = 255 - c;
            m = 255 - m;
            yy = 255 - yy;
            k = 255 - k;
          }
          px[0] = clamp8(255 - c - k);
          px[1] = clamp8(255 - m - k);
          px[2] = clamp8(255 - yy - k);
        }
      }
    }
    return true;
  }
};

inline const int JpegDecoder::kZigZag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

}  // namespace vcpr

#endif  // VCPR_JPEG_DECODE_H_

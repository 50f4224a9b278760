// A JPEG decoder that gives what libjpeg(-turbo) gives through
// cv2.imdecode(buf, IMREAD_UNCHANGED): 8-bit sequential (SOF0, SOF1) and
// progressive (SOF2, spectral selection and successive approximation, EOB
// runs) Huffman JPEG of 1 or 3 components with sampling factors 1 or 2,
// restart intervals, APPn / COM segments skipped. The arithmetic is
// libjpeg's: the integer "islow" IDCT (jidctint.c) with its range-limit
// table, the fancy upsampling of jdsample.c (h2v1, h2v2, h1v2; box
// replication where the chroma is at most 2 samples wide) with the
// context rows jdmainct.c gives it, and the fixed-point YCbCr -> RGB
// tables of jdcolor.c. Colour comes out BGR, as cv2 gives it. The EXIF
// orientation is not applied (IMREAD_UNCHANGED does not apply it).
//
// Refused (return code 1): arithmetic coding, 12-bit samples, lossless and
// hierarchical processes, component counts other than 1 and 3 (Adobe CMYK
// / YCCK) and sampling ratios other than 1 and 2. Malformed data (return
// code 2) is refused where libjpeg would stop; inside the entropy-coded
// data a missing or bad code reads as zeros, as libjpeg reads it.
//
// C interface:
//   pd_jpeg_header(data, size, out[3], err, err_size): height, width,
//     components of the output (1 grey, 3 BGR);
//   pd_jpeg_decode(data, size, out, out_size, err, err_size): the pixels,
//     row-major, interleaved.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct JpegError {
  int code;  // 1: a kind the decoder refuses; 2: malformed
  std::string msg;
};

[[noreturn]] void refuse(const std::string& msg) { throw JpegError{1, msg}; }
[[noreturn]] void corrupt(const std::string& msg) { throw JpegError{2, msg}; }

// Zigzag order to natural order, with libjpeg's 16 extra entries so that a
// corrupt run past 63 lands on 63.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t mincode[18] = {};
  int32_t maxcode[18] = {};
  int32_t valptr[18] = {};

  void build(const uint8_t* bits, const uint8_t* values, int count) {
    std::memcpy(vals, values, count);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l - 1];
      k += bits[l - 1];
      maxcode[l] = bits[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0;        // downsampled size in samples
  int bw = 0, bh = 0;               // blocks, padded to whole MCUs
  std::vector<int16_t> coef;        // bw * bh blocks of 64, natural order
  uint16_t quant[64] = {};          // latched at the first scan
  bool seen = false;
  std::vector<uint8_t> plane;       // bw*8 x bh*8 samples after the IDCT
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}

  size_t pos() const { return pos_; }

  int bit() {
    if (bits_ == 0) fill();
    --bits_;
    return (acc_ >> bits_) & 1;
  }

  int bits(int k) {
    int v = 0;
    for (int i = 0; i < k; ++i) v = (v << 1) | bit();
    return v;
  }

  int decode(const Huffman& h) {
    int code = bit();
    int l = 1;
    while (code > h.maxcode[l]) {
      code = (code << 1) | bit();
      if (++l > 16) return 0;  // libjpeg: a bad code decodes as 0
    }
    return h.vals[h.valptr[l] + code - h.mincode[l]];
  }

  // At a restart: drop the partial byte and consume RSTn if it is there.
  void restart() {
    bits_ = 0;
    marker_ = false;
    if (pos_ + 1 < n_ && d_[pos_] == 0xFF && d_[pos_ + 1] >= 0xD0 &&
        d_[pos_ + 1] <= 0xD7) {
      pos_ += 2;
    }
  }

  // After a scan: the position of the next marker.
  size_t end_of_scan() {
    size_t p = pos_;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0 &&
                           !(d_[p + 1] >= 0xD0 && d_[p + 1] <= 0xD7))) {
      ++p;
    }
    return p;
  }

 private:
  void fill() {
    int c = 0;
    if (!marker_ && pos_ < n_) {
      c = d_[pos_];
      if (c == 0xFF) {
        int next = pos_ + 1 < n_ ? d_[pos_ + 1] : 0xD9;
        if (next == 0) {
          pos_ += 2;
        } else {
          marker_ = true;  // entropy data ends: zeros from here
          c = 0;
        }
      } else {
        ++pos_;
      }
    }
    acc_ = c;
    bits_ = 8;
  }

  const uint8_t* d_;
  size_t n_, pos_;
  uint32_t acc_ = 0;
  int bits_ = 0;
  bool marker_ = false;
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// --- jidctint.c: jpeg_idct_islow -------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F_0_298631336 = 2446, F_0_390180644 = 3196,
                  F_0_541196100 = 4433, F_0_765366865 = 6270,
                  F_0_899976223 = 7373, F_1_175875602 = 9633,
                  F_1_501321110 = 12299, F_1_847759065 = 15137,
                  F_1_961570560 = 16069, F_2_053119869 = 16819,
                  F_2_562915447 = 20995, F_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// The post-IDCT range limit: (x & 1023) read through libjpeg's table.
inline uint8_t range_limit_idct(int64_t x) {
  int w = int(x & 1023);
  if (w >= 512) w -= 1024;
  w += 128;
  return uint8_t(w < 0 ? 0 : (w > 255 ? 255 : w));
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = int(ip[0]) * int(qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, n));
    wp[56] = int(descale(tmp10 - tmp3, n));
    wp[8] = int(descale(tmp11 + tmp2, n));
    wp[48] = int(descale(tmp11 - tmp2, n));
    wp[16] = int(descale(tmp12 + tmp1, n));
    wp[40] = int(descale(tmp12 - tmp1, n));
    wp[24] = int(descale(tmp13 + tmp0, n));
    wp[32] = int(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t dc = range_limit_idct(descale(wp[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    op[0] = range_limit_idct(descale(tmp10 + tmp3, n));
    op[7] = range_limit_idct(descale(tmp10 - tmp3, n));
    op[1] = range_limit_idct(descale(tmp11 + tmp2, n));
    op[6] = range_limit_idct(descale(tmp11 - tmp2, n));
    op[2] = range_limit_idct(descale(tmp12 + tmp1, n));
    op[5] = range_limit_idct(descale(tmp12 - tmp1, n));
    op[3] = range_limit_idct(descale(tmp13 + tmp0, n));
    op[4] = range_limit_idct(descale(tmp13 - tmp0, n));
  }
}

// --- the decoder -------------------------------------------------------------

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  void header_only() { parse(false); }
  void decode() { parse(true); }

  int width = 0, height = 0, out_channels = 0;
  std::vector<uint8_t> pixels;

 private:
  int u16(size_t p) const {
    if (p + 1 >= n_) corrupt("JPEG data ends inside a segment");
    return (d_[p] << 8) | d_[p + 1];
  }

  void parse(bool full) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) corrupt("not a JPEG (no SOI)");
    size_t p = 2;
    bool frame = false;
    while (true) {
      // Markers may be padded with 0xFF fill bytes.
      while (p < n_ && d_[p] != 0xFF) ++p;
      while (p < n_ && d_[p] == 0xFF) ++p;
      if (p >= n_) {
        if (!scans_) corrupt("JPEG data ends before any scan");
        break;  // libjpeg: a missing EOI is only a warning
      }
      int m = d_[p++];
      if (m == 0xD9) break;                       // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;       // stray RSTn
      if (m == 0x01) continue;                    // TEM
      int len = u16(p);
      if (len < 2 || p + len > n_) corrupt("JPEG segment runs past the data");
      const uint8_t* s = d_ + p + 2;
      int sl = len - 2;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          if (frame) corrupt("JPEG with two frames");
          sof(s, sl, m == 0xC2);
          frame = true;
          if (!full) return;
          break;
        case 0xC3:
          refuse("lossless JPEG (SOF3)");
        case 0xC5: case 0xC6: case 0xC7:
          refuse("hierarchical JPEG (SOF5-7)");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        case 0xCC:
          refuse("arithmetic-coded JPEG");
        case 0xC4: dht(s, sl); break;
        case 0xDB: dqt(s, sl); break;
        case 0xDD:
          if (sl < 2) corrupt("short DRI segment");
          restart_interval_ = (s[0] << 8) | s[1];
          break;
        case 0xDA: {
          if (!frame) corrupt("JPEG scan before its frame");
          size_t next = sos(s, sl, p + len);
          p = next;
          ++scans_;
          continue;
        }
        case 0xEE: adobe(s, sl); break;
        case 0xE0:
          if (sl >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) jfif_ = true;
          break;
        default:
          break;  // APPn, COM and anything else: skipped
      }
      p += len;
    }
    if (!frame) corrupt("JPEG without a frame header");
    finish();
  }

  void sof(const uint8_t* s, int sl, bool progressive) {
    if (sl < 6) corrupt("short SOF segment");
    if (s[0] != 8) refuse(std::to_string(s[0]) + "-bit JPEG");
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    int nc = s[5];
    if (height == 0 || width == 0) corrupt("JPEG with an empty frame");
    if (nc != 1 && nc != 3) {
      refuse(std::to_string(nc) + "-component JPEG (CMYK / YCCK or other)");
    }
    if (sl < 6 + 3 * nc) corrupt("short SOF segment");
    progressive_ = progressive;
    comps_.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps_[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) {
        corrupt("bad JPEG sampling factors or table");
      }
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (Component& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v || hmax_ / c.h > 2 || vmax_ / c.v > 2) {
        refuse("JPEG sampling factors other than 1:1 and 2:1 ratios");
      }
      c.width = (width * c.h + hmax_ - 1) / hmax_;
      c.height = (height * c.v + vmax_ - 1) / vmax_;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
    }
    out_channels = nc == 1 ? 1 : 3;
  }

  void dht(const uint8_t* s, int sl) {
    int p = 0;
    while (p < sl) {
      if (p + 17 > sl) corrupt("short DHT segment");
      int tc = s[p] >> 4, th = s[p] & 15;
      if (tc > 1 || th > 3) corrupt("bad Huffman table class or id");
      int count = 0;
      for (int i = 0; i < 16; ++i) count += s[p + 1 + i];
      if (count > 256 || p + 17 + count > sl) corrupt("bad DHT segment");
      (tc == 0 ? dc_ : ac_)[th].build(s + p + 1, s + p + 17, count);
      p += 17 + count;
    }
  }

  void dqt(const uint8_t* s, int sl) {
    int p = 0;
    while (p < sl) {
      int pq = s[p] >> 4, tq = s[p] & 15;
      if (tq > 3 || pq > 1) corrupt("bad quantisation table");
      int size = pq ? 128 : 64;
      if (p + 1 + size > sl) corrupt("short DQT segment");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (s[p + 1 + 2 * k] << 8) | s[p + 2 + 2 * k] : s[p + 1 + k];
        quant_[tq][kNatural[k]] = uint16_t(v);
      }
      quant_defined_[tq] = true;
      p += 1 + size;
    }
  }

  void adobe(const uint8_t* s, int sl) {
    if (sl >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
      adobe_ = true;
      adobe_transform_ = s[11];
    }
  }

  // Decodes one scan; returns the position of the marker after it.
  size_t sos(const uint8_t* s, int sl, size_t data) {
    if (sl < 1) corrupt("short SOS segment");
    int ns = s[0];
    if (ns < 1 || ns > 4 || sl < 4 + 2 * ns) corrupt("bad SOS segment");
    std::vector<Component*> sc;
    std::vector<int> td, ta;
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i];
      Component* c = nullptr;
      for (Component& k : comps_) if (k.id == id) c = &k;
      if (c == nullptr) corrupt("JPEG scan names an unknown component");
      if (!c->seen) {
        if (!quant_defined_[c->tq]) corrupt("JPEG component without a table");
        std::memcpy(c->quant, quant_[c->tq], sizeof(c->quant));
        c->coef.assign(size_t(c->bw) * c->bh * 64, 0);
        c->seen = true;
      }
      sc.push_back(c);
      td.push_back(s[2 + 2 * i] >> 4);
      ta.push_back(s[2 + 2 * i] & 15);
    }
    int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
    int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    if (!progressive_) {
      ss = 0;
      se = 63;
      ah = al = 0;
    } else if (ss > se || se > 63 || (ss == 0 && se != 0) ||
               (ss > 0 && ns != 1) || al > 13) {
      corrupt("bad progressive scan parameters");
    }
    for (int i = 0; i < ns; ++i) {
      bool need_dc = ss == 0 && ah == 0;
      bool need_ac = se > 0;
      if ((need_dc && (td[i] > 3 || !dc_[td[i]].defined)) ||
          (need_ac && (ta[i] > 3 || !ac_[ta[i]].defined))) {
        corrupt("JPEG scan uses an undefined Huffman table");
      }
    }
    BitReader br(d_, n_, data);
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    auto block_of = [](Component* c, int bx, int by) {
      return c->coef.data() + (size_t(by) * c->bw + bx) * 64;
    };
    auto decode_block = [&](int i, int16_t* blk) {
      if (!progressive_) {
        baseline_block(br, dc_[td[i]], ac_[ta[i]], pred[i], blk);
      } else if (ss == 0) {
        if (ah == 0) {
          int t = br.decode(dc_[td[i]]);
          int diff = t ? extend(br.bits(t), t) : 0;
          pred[i] += diff;
          blk[0] = int16_t(pred[i] * (1 << al));
        } else if (br.bit()) {
          blk[0] = int16_t(blk[0] | (1 << al));
        }
      } else if (ah == 0) {
        ac_first(br, ac_[ta[i]], ss, se, al, eobrun, blk);
      } else {
        ac_refine(br, ac_[ta[i]], ss, se, al, eobrun, blk);
      }
    };
    int units = 0;
    auto restart_check = [&]() {
      if (restart_interval_ && units == restart_interval_) {
        br.restart();
        for (int& v : pred) v = 0;
        eobrun = 0;
        units = 0;
      }
    };
    if (ns == 1) {
      Component* c = sc[0];
      int bw = (c->width + 7) / 8, bh = (c->height + 7) / 8;
      for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
          restart_check();
          decode_block(0, block_of(c, bx, by));
          ++units;
        }
      }
    } else {
      for (int my = 0; my < mcuy_; ++my) {
        for (int mx = 0; mx < mcux_; ++mx) {
          restart_check();
          for (int i = 0; i < ns; ++i) {
            Component* c = sc[i];
            for (int v = 0; v < c->v; ++v) {
              for (int h = 0; h < c->h; ++h) {
                decode_block(i, block_of(c, mx * c->h + h, my * c->v + v));
              }
            }
          }
          ++units;
        }
      }
    }
    return br.end_of_scan();
  }

  static void baseline_block(BitReader& br, const Huffman& dc,
                             const Huffman& ac, int& pred, int16_t* blk) {
    int t = br.decode(dc);
    int diff = t ? extend(br.bits(t), t) : 0;
    pred += diff;
    blk[0] = int16_t(pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void ac_first(BitReader& br, const Huffman& ac, int ss, int se,
                       int al, int& eobrun, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.bits(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        --eobrun;
        break;
      }
    }
  }

  static void ac_refine(BitReader& br, const Huffman& ac, int ss, int se,
                        int al, int& eobrun, int16_t* blk) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (br.bit() && (coef & p1) == 0) {
        coef = int16_t(coef >= 0 ? coef + p1 : coef + m1);
      }
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  void finish() {
    for (Component& c : comps_) {
      if (!c.seen) corrupt("JPEG component never appears in a scan");
      int pw = c.bw * 8;
      c.plane.assign(size_t(pw) * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
          idct_islow(c.coef.data() + (size_t(by) * c.bw + bx) * 64, c.quant,
                     c.plane.data() + size_t(by) * 8 * pw + bx * 8, pw);
        }
      }
      c.coef.clear();
      c.coef.shrink_to_fit();
    }
    std::vector<std::vector<uint8_t>> full(comps_.size());
    for (size_t i = 0; i < comps_.size(); ++i) upsample(comps_[i], full[i]);
    pixels.resize(size_t(width) * height * out_channels);
    if (out_channels == 1) {
      pixels = std::move(full[0]);
      return;
    }
    if (!is_ycc()) {  // RGB stored as is; out in BGR order
      for (size_t p = 0; p < size_t(width) * height; ++p) {
        pixels[3 * p] = full[2][p];
        pixels[3 * p + 1] = full[1][p];
        pixels[3 * p + 2] = full[0][p];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16.
    const int kScale = 16;
    const int64_t half = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t p = 0; p < size_t(width) * height; ++p) {
      int y = full[0][p], cb = full[1][p], cr = full[2][p];
      pixels[3 * p + 2] = clamp(y + cr_r[cr]);
      pixels[3 * p + 1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> kScale));
      pixels[3 * p] = clamp(y + cb_b[cb]);
    }
  }

  // libjpeg's colour-space guess for 3 components (jdapimin.c).
  bool is_ycc() const {
    if (jfif_) return true;
    if (adobe_) return adobe_transform_ != 0;
    int a = comps_[0].id, b = comps_[1].id, c = comps_[2].id;
    if (a == 'R' && b == 'G' && c == 'B') return false;
    return true;
  }

  // jdsample.c with jdmainct.c's context rows: rows above the first and
  // below the last real row repeat them.
  void upsample(const Component& c, std::vector<uint8_t>& out) const {
    const int rh = hmax_ / c.h, rv = vmax_ / c.v;
    const int pw = c.bw * 8;
    const int w = c.width;
    out.assign(size_t(width) * height, 0);
    std::vector<uint8_t> row(size_t(2 * w + 2));
    auto in_row = [&](int y) {
      y = std::max(0, std::min(y, c.height - 1));
      return c.plane.data() + size_t(y) * pw;
    };
    const bool fancy_h = w > 2;
    for (int y = 0; y < height; ++y) {
      uint8_t* op = out.data() + size_t(y) * width;
      if (rh == 1 && rv == 1) {
        std::memcpy(op, in_row(y), width);
        continue;
      }
      if (rh == 1) {  // h1v2
        const uint8_t* a = in_row(y / 2);
        const uint8_t* b = in_row(y % 2 ? y / 2 + 1 : y / 2 - 1);
        int bias = y % 2 ? 2 : 1;
        for (int x = 0; x < width; ++x) op[x] = uint8_t((a[x] * 3 + b[x] + bias) >> 2);
        continue;
      }
      if (rv == 1 || !fancy_h) {
        const uint8_t* a = in_row(rv == 1 ? y : y / 2);
        if (!fancy_h) {  // box replication (h2v1 / h2v2 at width <= 2)
          for (int x = 0; x < width; ++x) op[x] = a[x / 2];
          continue;
        }
        // h2v1 fancy
        uint8_t* o = row.data();
        int v = a[0];
        *o++ = uint8_t(v);
        *o++ = uint8_t((v * 3 + a[1] + 2) >> 2);
        for (int i = 1; i < w - 1; ++i) {
          v = a[i] * 3;
          *o++ = uint8_t((v + a[i - 1] + 1) >> 2);
          *o++ = uint8_t((v + a[i + 1] + 2) >> 2);
        }
        v = a[w - 1];
        *o++ = uint8_t((v * 3 + a[w - 2] + 1) >> 2);
        *o++ = uint8_t(v);
        std::memcpy(op, row.data(), width);
        continue;
      }
      // h2v2 fancy
      const uint8_t* a = in_row(y / 2);
      const uint8_t* b = in_row(y % 2 ? y / 2 + 1 : y / 2 - 1);
      uint8_t* o = row.data();
      int this_sum = a[0] * 3 + b[0];
      int next_sum = a[1] * 3 + b[1];
      *o++ = uint8_t((this_sum * 4 + 8) >> 4);
      *o++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int i = 2; i < w; ++i) {
        next_sum = a[i] * 3 + b[i];
        *o++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *o++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = uint8_t((this_sum * 4 + 7) >> 4);
      std::memcpy(op, row.data(), width);
    }
  }

  const uint8_t* d_;
  size_t n_;
  std::vector<Component> comps_;
  Huffman dc_[4], ac_[4];
  uint16_t quant_[4][64] = {};
  bool quant_defined_[4] = {false, false, false, false};
  bool progressive_ = false, jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int scans_ = 0;
};

void set_error(const JpegError& e, char* err, uint64_t err_size) {
  if (err && err_size) std::snprintf(err, err_size, "%s", e.msg.c_str());
}

}  // namespace

extern "C" int pd_jpeg_header(const uint8_t* data, uint64_t size,
                              int32_t* out, char* err, uint64_t err_size) {
  try {
    Decoder dec(data, size);
    dec.header_only();
    if (dec.out_channels == 0) corrupt("JPEG without a frame header");
    out[0] = dec.height;
    out[1] = dec.width;
    out[2] = dec.out_channels;
    return 0;
  } catch (const JpegError& e) {
    set_error(e, err, err_size);
    return e.code;
  }
}

extern "C" int pd_jpeg_decode(const uint8_t* data, uint64_t size,
                              uint8_t* out, uint64_t out_size, char* err,
                              uint64_t err_size) {
  try {
    Decoder dec(data, size);
    dec.decode();
    if (dec.pixels.size() != out_size) corrupt("output size mismatch");
    std::memcpy(out, dec.pixels.data(), out_size);
    return 0;
  } catch (const JpegError& e) {
    set_error(e, err, err_size);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_error(JpegError{2, "out of memory"}, err, err_size);
    return 2;
  }
}

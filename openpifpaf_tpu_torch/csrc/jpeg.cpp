// JPEG decoder and encoder without libjpeg, for hosts without PIL.
//
// The decoder reproduces libjpeg-turbo's default decompression (what
// PIL's Image.open(path).convert('RGB') gives): the islow integer IDCT of
// jidctint.c with its range-limit table, fancy upsampling for h2v1, h1v2
// and h2v2 components (jdsample.c) and replication for other integral
// factors, and jdcolor.c's table-based YCbCr->RGB.  It reads baseline,
// extended (8-bit Huffman) and progressive files, 1, 3 or 4 components
// with sampling factors 1..4, restart intervals, 8- and 16-bit
// quantisation tables, and skips APPn and COM segments.  Four components
// are CMYK, or YCCK under an Adobe marker with transform 2 (jdcolor.c's
// ycck_cmyk_convert); Pillow reads them as inverted "CMYK;I" and
// convert('RGB') applies its cmyk2rgb.  It refuses, by message:
// arithmetic coding, 12-bit, lossless and hierarchical files, DNL, a
// progressive file whose last scans leave coefficients approximate
// (libjpeg smooths those blocks), and truncated or corrupt data.
//
// The encoder reproduces libjpeg-turbo's default compression as Pillow
// calls it (save(buf, 'JPEG', quality=q)): a JFIF header, jccolor.c's
// RGB->YCbCr, 4:2:0 by jcsample.c's h2v2_downsample (alternating bias,
// edges replicated), the islow FDCT of jfdctint.c, jcdctmgr.c's
// reciprocal quantisation, the standard tables scaled by
// jpeg_quality_scaling with baseline forced, and the standard Huffman
// tables.  A one-channel image gets one component.
//
// Plain C interface (ctypes): jpeg_info, jpeg_decode (with a colour mode:
// the file's, the components as they are, or YCbCr, as libtiff reads
// JPEG-in-TIFF; or the raw components repeated over their blocks, as it
// reads old-style JPEG), jpeg_encode; each returns a negative value and
// writes a message on failure.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

using u8 = uint8_t;

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string &what) { throw JpegError(what); }

// zigzag position -> natural (row-major) position; 16 extra entries as in
// libjpeg, so that a run past 63 lands on 63
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jidctint.c / jfdctint.c constants, CONST_BITS 13
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433,
                  F_0_765 = 6270, F_0_899 = 7373, F_1_175 = 9633,
                  F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
                  F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

// (x + 2^(n-1)) >> n in libjpeg's JLONG (64 bits here)
inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// ---------------------------------------------------------------- decoder

// jdmaster.c's post-IDCT range limit: the 10 bits of x as a signed value,
// plus 128, clamped to [0, 255]
inline u8 idct_limit(int64_t x) {
  int v = int(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return u8(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jpeg_idct_islow on one dequantised block, into 8 rows of `out`
void idct_islow(const int32_t *in, u8 *out, long stride) {
  int32_t ws[64];  // int, as jidctint.c's workspace
  for (int c = 0; c < 8; ++c) {
    const int32_t *p = in + c;
    int64_t z2 = p[16], z3 = p[48];
    int64_t z1 = (z2 + z3) * F_0_541;
    int64_t tmp2 = z1 + z3 * -F_1_847;
    int64_t tmp3 = z1 + z2 * F_0_765;
    z2 = p[0];
    z3 = p[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = p[56];
    tmp1 = p[40];
    tmp2 = p[24];
    tmp3 = p[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175;
    tmp0 *= F_0_298;
    tmp1 *= F_2_053;
    tmp2 *= F_3_072;
    tmp3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    ws[c] = int32_t(descale(tmp10 + tmp3, n));
    ws[56 + c] = int32_t(descale(tmp10 - tmp3, n));
    ws[8 + c] = int32_t(descale(tmp11 + tmp2, n));
    ws[48 + c] = int32_t(descale(tmp11 - tmp2, n));
    ws[16 + c] = int32_t(descale(tmp12 + tmp1, n));
    ws[40 + c] = int32_t(descale(tmp12 - tmp1, n));
    ws[24 + c] = int32_t(descale(tmp13 + tmp0, n));
    ws[32 + c] = int32_t(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t *w = ws + 8 * r;
    u8 *o = out + r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F_0_541;
    int64_t tmp2 = z1 + z3 * -F_1_847;
    int64_t tmp3 = z1 + z2 * F_0_765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175;
    tmp0 *= F_0_298;
    tmp1 *= F_2_053;
    tmp2 *= F_3_072;
    tmp3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, n));
    o[7] = idct_limit(descale(tmp10 - tmp3, n));
    o[1] = idct_limit(descale(tmp11 + tmp2, n));
    o[6] = idct_limit(descale(tmp11 - tmp2, n));
    o[2] = idct_limit(descale(tmp12 + tmp1, n));
    o[5] = idct_limit(descale(tmp12 - tmp1, n));
    o[3] = idct_limit(descale(tmp13 + tmp0, n));
    o[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

struct Huffman {
  bool defined = false;
  // 16 bits of the stream -> (code length << 8) | symbol; 0: no code
  std::vector<uint16_t> lookup;
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;    // stored blocks per row and column (MCU padded)
  int wib = 0, hib = 0;  // blocks of a non-interleaved scan
  int dw = 0, dh = 0;    // downsampled width and height
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  int32_t qt[64] = {};        // latched at the component's first scan
  bool latched = false;
  int coef_bits[64];  // progressive: Al of each coefficient so far, -1 none
  int dc_pred = 0;
  int dc_tbl = 0, ac_tbl = 0;
};

// jdcolor.c build_ycc_rgb_table, SCALEBITS 16
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = int((91881 * x + 32768) >> 16);
      cb_b[i] = int((116130 * x + 32768) >> 16);
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + 32768;
    }
  }
};
const YccTables kYcc;

class Decoder {
 public:
  Decoder(const u8 *data, size_t size) : d_(data), n_(size) {}

  void read_header() {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file");
    pos_ = 2;
    while (!frame_) {
      int m = next_marker();
      if (m == 0xDA || m == 0xD9) fail("corrupt JPEG data: no frame header");
      segment(m);
    }
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int components() const { return int(comps_.size()); }

  // `colour`: 0 as the file says, 1 the components as they are (libjpeg's
  // JCS_UNKNOWN in and out, as libtiff reads JPEG-in-TIFF other than
  // YCbCr), 2 YCbCr -> RGB whatever the markers say (libtiff's
  // JPEGCOLORMODE_RGB for photometric YCbCr), 3 the components as they
  // are, each downsampled one repeated over its block (libtiff's old-style
  // JPEG, raw data, read through its RGBA interface)
  void decode(u8 *out, int colour = 0) {
    colour_ = colour;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      segment(m);
    }
    if (!scanned_) fail("corrupt JPEG data: no scan");
    if (progressive_ && smoothing_applies())
      fail("progressive JPEG whose scans leave coefficients approximate "
           "(libjpeg's block smoothing) is not supported");
    output(out);
  }

 private:
  const u8 *d_;
  size_t n_;
  size_t pos_ = 0;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  int restart_interval_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1, colour_ = 0;
  bool frame_ = false, progressive_ = false, scanned_ = false;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  std::vector<Component> comps_;
  // bit reader
  uint64_t acc_ = 0;
  int bits_ = 0, fake_ = 0;
  bool marker_hit_ = false;
  int eobrun_ = 0;

  int byte() {
    if (pos_ >= n_) fail("truncated JPEG data");
    return d_[pos_++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // the next marker code; skips bytes that are not markers, as libjpeg
  int next_marker() {
    for (;;) {
      int c = byte();
      if (c != 0xFF) continue;
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // a marker segment's body; `pos_` moves past it
  std::pair<const u8 *, int> body() {
    int length = word();
    if (length < 2 || pos_ + (length - 2) > n_)
      fail(length < 2 ? "corrupt JPEG data: bad segment length"
                      : "truncated JPEG data");
    const u8 *p = d_ + pos_;
    pos_ += length - 2;
    return {p, length - 2};
  }

  void segment(int m) {
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) return frame(m);
    if (m == 0xC4) return dht();
    if (m == 0xDB) return dqt();
    if (m == 0xDD) return dri();
    if (m == 0xDA) return sos();
    if (m == 0xDC) fail("JPEG DNL marker (height after the scan) is not supported");
    if (m >= 0xC9 && m <= 0xCF)  // SOF9..15 and DAC
      fail("arithmetic-coded JPEG is not supported");
    if (m == 0xC3) fail("lossless JPEG is not supported");
    if (m >= 0xC5 && m <= 0xC7) fail("hierarchical (differential) JPEG is not supported");
    if (m == 0xDE || m == 0xDF) fail("hierarchical (differential) JPEG is not supported");
    if (m >= 0xE0 && m <= 0xEF) return app(m);
    if (m == 0xFE) { body(); return; }
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) return;  // parameterless
    if (m == 0xD8) fail("corrupt JPEG data: SOI inside the file");
    fail("corrupt JPEG data: unknown marker 0x" +
         std::string(1, "0123456789ABCDEF"[m >> 4]) +
         std::string(1, "0123456789ABCDEF"[m & 15]));
  }

  void app(int m) {
    auto [p, len] = body();
    if (m == 0xE0 && len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0)
      jfif_ = true;
    if (m == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe_ = true;
      adobe_transform_ = p[11];
    }
  }

  void dqt() {
    auto [p, len] = body();
    int i = 0;
    while (i < len) {
      int pq = p[i] >> 4, tq = p[i] & 15;
      ++i;
      if (tq > 3 || pq > 1) fail("corrupt JPEG data: bad quantisation table");
      int need = pq ? 128 : 64;
      if (i + need > len) fail("corrupt JPEG data: short quantisation table");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (p[i + 2 * k] << 8 | p[i + 2 * k + 1]) : p[i + k];
        qt_[tq][kNatural[k]] = uint16_t(v);
      }
      qt_defined_[tq] = true;
      i += need;
    }
  }

  void dht() {
    auto [p, len] = body();
    int i = 0;
    while (i < len) {
      if (i + 17 > len) fail("corrupt JPEG data: short Huffman table");
      int tc = p[i] >> 4, th = p[i] & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG data: bad Huffman table");
      int counts[17] = {0}, total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = p[i + l];
      i += 17;
      if (total > 256 || i + total > len)
        fail("corrupt JPEG data: bad Huffman table");
      Huffman &t = tc ? ac_[th] : dc_[th];
      t.lookup.assign(65536, 0);
      int code = 0, k = 0;
      for (int l = 1; l <= 16; ++l) {
        for (int j = 0; j < counts[l]; ++j, ++k, ++code) {
          int sym = p[i + k];
          if (tc == 0 && sym > 15) fail("corrupt JPEG data: bad Huffman table");
          int lo = code << (16 - l), hi = (code + 1) << (16 - l);
          for (int e = lo; e < hi; ++e) t.lookup[e] = uint16_t(l << 8 | sym);
        }
        // jdhuff.c: a code of all ones is not allowed
        if (code >= (1 << l)) fail("corrupt JPEG data: bad Huffman table");
        code <<= 1;
      }
      t.defined = true;
      i += total;
    }
  }

  void dri() {
    auto [p, len] = body();
    if (len != 2) fail("corrupt JPEG data: bad DRI segment");
    restart_interval_ = p[0] << 8 | p[1];
  }

  void frame(int m) {
    if (frame_) fail("corrupt JPEG data: two frame headers");
    auto [p, len] = body();
    if (len < 6) fail("corrupt JPEG data: short frame header");
    int precision = p[0];
    height_ = p[1] << 8 | p[2];
    width_ = p[3] << 8 | p[4];
    int nc = p[5];
    if (precision == 12) fail("12-bit JPEG is not supported");
    if (precision != 8) fail("corrupt JPEG data: sample precision " + std::to_string(precision));
    if (height_ == 0) fail("JPEG DNL marker (height after the scan) is not supported");
    if (width_ == 0) fail("corrupt JPEG data: empty image");
    if (nc != 1 && nc != 3 && nc != 4)
      fail(std::to_string(nc) + "-component JPEG is not supported");
    if (len != 6 + 3 * nc) fail("corrupt JPEG data: bad frame header length");
    progressive_ = m == 0xC2;
    comps_.resize(nc);
    for (int c = 0; c < nc; ++c) {
      Component &k = comps_[c];
      k.id = p[6 + 3 * c];
      k.h = p[7 + 3 * c] >> 4;
      k.v = p[7 + 3 * c] & 15;
      k.tq = p[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        fail("corrupt JPEG data: bad component parameters");
      hmax_ = std::max(hmax_, k.h);
      vmax_ = std::max(vmax_, k.v);
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (Component &k : comps_) {
      if (hmax_ % k.h || vmax_ % k.v)
        fail("JPEG with fractional sampling factors is not supported");
      k.dw = int((long(width_) * k.h + hmax_ - 1) / hmax_);
      k.dh = int((long(height_) * k.v + vmax_ - 1) / vmax_);
      k.wib = (k.dw + 7) / 8;
      k.hib = (k.dh + 7) / 8;
      k.bw = mcux_ * k.h;
      k.bh = mcuy_ * k.v;
      k.coef.assign(size_t(k.bw) * k.bh * 64, 0);
      std::fill(k.coef_bits, k.coef_bits + 64, -1);
    }
    frame_ = true;
  }

  // ------------------------------------------------------------ bit reader
  void reset_bits() {
    acc_ = 0;
    bits_ = fake_ = 0;
    marker_hit_ = false;
  }

  void fill() {
    while (bits_ <= 56) {
      uint64_t b = 0;
      if (!marker_hit_) {
        if (pos_ >= n_) {
          marker_hit_ = true;
        } else if (d_[pos_] != 0xFF) {
          b = d_[pos_++];
        } else {
          size_t q = pos_ + 1;
          while (q < n_ && d_[q] == 0xFF) ++q;
          if (q < n_ && d_[q] == 0) {
            b = 0xFF;
            pos_ = q + 1;
          } else {
            marker_hit_ = true;
            pos_ = q - 1;
          }
        }
      }
      if (marker_hit_) fake_ += 8;
      acc_ |= b << (56 - bits_);
      bits_ += 8;
    }
  }

  void consumed() {
    if (bits_ < fake_) fail("truncated or corrupt JPEG data");
  }

  int get_bits(int k) {
    if (k == 0) return 0;
    if (bits_ < k) fill();
    int v = int(acc_ >> (64 - k));
    acc_ <<= k;
    bits_ -= k;
    consumed();
    return v;
  }

  int decode(const Huffman &t) {
    if (bits_ < 16) fill();
    uint16_t e = t.lookup[acc_ >> 48];
    if (!e) fail("corrupt JPEG data: bad Huffman code");
    int l = e >> 8;
    acc_ <<= l;
    bits_ -= l;
    consumed();
    return e & 0xFF;
  }

  static int extend(int v, int t) {
    return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
  }

  // after a scan or restart interval: drop the bits left and go to the
  // next marker
  void to_marker() {
    acc_ = 0;
    bits_ = fake_ = 0;
    if (marker_hit_) {
      marker_hit_ = false;
      return;
    }
    while (pos_ < n_) {
      if (d_[pos_] == 0xFF) {
        size_t q = pos_ + 1;
        while (q < n_ && d_[q] == 0xFF) ++q;
        if (q < n_ && d_[q] != 0) {
          pos_ = q - 1;
          return;
        }
        pos_ = q;
      }
      ++pos_;
    }
  }

  void restart(int &next) {
    to_marker();
    if (pos_ + 1 >= n_) fail("truncated JPEG data");
    if (d_[pos_ + 1] != 0xD0 + next)
      fail("corrupt JPEG data: missing restart marker");
    pos_ += 2;
    next = (next + 1) & 7;
    eobrun_ = 0;
    for (Component &k : comps_) k.dc_pred = 0;
  }

  // ---------------------------------------------------------------- scans
  void sos() {
    if (!frame_) fail("corrupt JPEG data: scan before the frame header");
    auto [p, len] = body();
    int ns = len > 0 ? p[0] : 0;
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns)
      fail("corrupt JPEG data: bad scan header");
    std::vector<int> sc;
    for (int i = 0; i < ns; ++i) {
      int id = p[1 + 2 * i], c = 0;
      while (c < int(comps_.size()) && comps_[c].id != id) ++c;
      if (c == int(comps_.size()) || std::find(sc.begin(), sc.end(), c) != sc.end())
        fail("corrupt JPEG data: bad scan component");
      comps_[c].dc_tbl = p[2 + 2 * i] >> 4;
      comps_[c].ac_tbl = p[2 + 2 * i] & 15;
      if (comps_[c].dc_tbl > 3 || comps_[c].ac_tbl > 3)
        fail("corrupt JPEG data: bad scan tables");
      sc.push_back(c);
    }
    int ss = p[1 + 2 * ns], se = p[2 + 2 * ns];
    int ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;
    if (ns > 1) {
      int blocks = 0;
      for (int c : sc) blocks += comps_[c].h * comps_[c].v;
      if (blocks > 10) fail("corrupt JPEG data: MCU of more than 10 blocks");
    }
    for (int c : sc) {
      Component &k = comps_[c];
      if (!k.latched) {
        if (!qt_defined_[k.tq]) fail("corrupt JPEG data: quantisation table not defined");
        for (int i = 0; i < 64; ++i) k.qt[i] = int16_t(qt_[k.tq][i]);
        k.latched = true;
      }
    }
    if (progressive_) {
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if (bad || (ah != 0 && al != ah - 1) || al > 13)
        fail("corrupt JPEG data: bad progressive scan parameters");
      for (int c : sc)
        for (int k = ss; k <= se; ++k) comps_[c].coef_bits[k] = al;
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    const bool need_dc = !progressive_ || (ss == 0 && ah == 0);
    const bool need_ac = !progressive_ || ss > 0;
    for (int c : sc)
      if ((need_dc && !dc_[comps_[c].dc_tbl].defined) ||
          (need_ac && !ac_[comps_[c].ac_tbl].defined))
        fail("corrupt JPEG data: Huffman table not defined");
    scan(sc, ss, se, ah, al);
    scanned_ = true;
  }

  void block(Component &k, int16_t *b, int ss, int se, int ah, int al) {
    if (!progressive_) {
      int s = decode(dc_[k.dc_tbl]);
      if (s) s = extend(get_bits(s), s);
      k.dc_pred += s;
      b[0] = int16_t(k.dc_pred);
      const Huffman &t = ac_[k.ac_tbl];
      for (int i = 1; i < 64; ++i) {
        int rs = decode(t), r = rs >> 4;
        s = rs & 15;
        if (s) {
          i += r;
          if (i > 63) fail("corrupt JPEG data: coefficient run past the block");
          b[kNatural[i]] = int16_t(extend(get_bits(s), s));
        } else {
          if (r != 15) break;
          i += 15;
        }
      }
      return;
    }
    if (ss == 0) {
      if (ah == 0) {
        int s = decode(dc_[k.dc_tbl]);
        if (s) s = extend(get_bits(s), s);
        k.dc_pred += s;
        b[0] = int16_t(uint32_t(k.dc_pred) << al);
      } else if (get_bits(1)) {
        b[0] = int16_t(b[0] | (1 << al));
      }
      return;
    }
    const Huffman &t = ac_[k.ac_tbl];
    if (ah == 0) {
      if (eobrun_ > 0) {
        --eobrun_;
        return;
      }
      for (int i = ss; i <= se; ++i) {
        int rs = decode(t), r = rs >> 4, s = rs & 15;
        if (s) {
          i += r;
          if (i > se) fail("corrupt JPEG data: coefficient run past the band");
          b[kNatural[i]] = int16_t(uint32_t(extend(get_bits(s), s)) << al);
        } else if (r == 15) {
          i += 15;
        } else {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          --eobrun_;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int i = ss;
    auto refine = [&](int16_t &coef) {
      if (get_bits(1) && (coef & p1) == 0)
        coef = int16_t(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun_ == 0) {
      for (; i <= se; ++i) {
        int rs = decode(t), r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt JPEG data: bad refinement code");
          s = get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          break;
        }
        do {
          int16_t &coef = b[kNatural[i]];
          if (coef != 0) {
            refine(coef);
          } else if (--r < 0) {
            break;
          }
          ++i;
        } while (i <= se);
        if (s) {
          if (i > se) fail("corrupt JPEG data: refinement run past the band");
          b[kNatural[i]] = int16_t(s);
        }
      }
    }
    if (eobrun_ > 0) {
      for (; i <= se; ++i) {
        int16_t &coef = b[kNatural[i]];
        if (coef != 0) refine(coef);
      }
      --eobrun_;
    }
  }

  void scan(const std::vector<int> &sc, int ss, int se, int ah, int al) {
    reset_bits();
    eobrun_ = 0;
    for (Component &k : comps_) k.dc_pred = 0;
    int togo = restart_interval_, next = 0;
    auto mcu_start = [&](bool first) {
      if (!restart_interval_) return;
      if (!first && togo == 0) {
        restart(next);
        togo = restart_interval_;
      }
      --togo;
    };
    if (sc.size() == 1) {
      Component &k = comps_[sc[0]];
      for (int by = 0; by < k.hib; ++by)
        for (int bx = 0; bx < k.wib; ++bx) {
          mcu_start(by == 0 && bx == 0);
          block(k, &k.coef[(size_t(by) * k.bw + bx) * 64], ss, se, ah, al);
        }
    } else {
      for (int my = 0; my < mcuy_; ++my)
        for (int mx = 0; mx < mcux_; ++mx) {
          mcu_start(my == 0 && mx == 0);
          for (int c : sc) {
            Component &k = comps_[c];
            for (int y = 0; y < k.v; ++y)
              for (int x = 0; x < k.h; ++x) {
                size_t at = size_t(my * k.v + y) * k.bw + (mx * k.h + x);
                block(k, &k.coef[at * 64], ss, se, ah, al);
              }
          }
        }
    }
    to_marker();
  }

  // jdcoefct.c smoothing_ok: libjpeg smooths a progressive image's blocks
  // when, for every component, the DC is known and the quantisers of the
  // first ten coefficients are not 0, and some of coefficients 1..9 are
  // approximate or missing
  bool smoothing_applies() const {
    static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const Component &k : comps_) {
      for (int q : kQ)
        if (k.qt[q] == 0) return false;
      if (k.coef_bits[0] < 0) return false;
      for (int i = 1; i < 10; ++i)
        if (k.coef_bits[i] != 0) useful = true;
    }
    return useful;
  }

  // ---------------------------------------------------------------- output
  // one component's samples at full size (width_ x height_)
  // one component at full size: fancy upsampling as libjpeg's, or with
  // `replicate` each sample repeated over its block (libtiff's RGBA
  // interface on raw, downsampled data)
  std::vector<u8> plane(const Component &k, bool replicate = false) const {
    const long pw = long(k.bw) * 8, ph = long(k.bh) * 8;
    std::vector<u8> s(size_t(pw * ph));
    int32_t in[64];
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx) {
        const int16_t *c = &k.coef[(size_t(by) * k.bw + bx) * 64];
        for (int i = 0; i < 64; ++i) in[i] = int32_t(c[i]) * k.qt[i];
        idct_islow(in, &s[size_t(by * 8 * pw + bx * 8)], pw);
      }
    const int hr = hmax_ / k.h, vr = vmax_ / k.v;
    std::vector<u8> out(size_t(width_) * height_);
    const int dw = k.dw, dh = k.dh;
    auto at = [&](int y, int x) -> int {
      y = std::min(std::max(y, 0), dh - 1);
      return s[size_t(y) * pw + x];
    };
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < height_; ++y)
        std::memcpy(&out[size_t(y) * width_], &s[size_t(y) * pw], width_);
      return out;
    }
    if (replicate) {
      hr_vr_replicate(s, pw, hr, vr, out);
      return out;
    }
    // each output row y of the h2v* methods: its nearest input row and
    // the next nearest (above for even y, below for odd), clamped
    std::vector<int> row(size_t(2 * dw));
    if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < height_; ++y) {
        const u8 *in0 = &s[size_t(y) * pw];
        int *o = row.data();
        o[0] = in0[0];
        o[1] = (in0[0] * 3 + in0[1] + 2) >> 2;
        for (int x = 1; x < dw - 1; ++x) {
          int v = in0[x] * 3;
          o[2 * x] = (v + in0[x - 1] + 1) >> 2;
          o[2 * x + 1] = (v + in0[x + 1] + 2) >> 2;
        }
        o[2 * dw - 2] = (in0[dw - 1] * 3 + in0[dw - 2] + 1) >> 2;
        o[2 * dw - 1] = in0[dw - 1];
        for (int x = 0; x < width_; ++x) out[size_t(y) * width_ + x] = u8(o[x]);
      }
      return out;
    }
    if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < height_; ++y) {
        int r = y >> 1, near = (y & 1) ? r + 1 : r - 1, bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width_; ++x)
          out[size_t(y) * width_ + x] = u8((at(r, x) * 3 + at(near, x) + bias) >> 2);
      }
      return out;
    }
    if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      std::vector<int> sum(static_cast<size_t>(dw));
      for (int y = 0; y < height_; ++y) {
        int r = y >> 1, near = (y & 1) ? r + 1 : r - 1;
        for (int x = 0; x < dw; ++x) sum[x] = at(r, x) * 3 + at(near, x);
        int *o = row.data();
        o[0] = (sum[0] * 4 + 8) >> 4;
        o[1] = (sum[0] * 3 + sum[1] + 7) >> 4;
        for (int x = 1; x < dw - 1; ++x) {
          o[2 * x] = (sum[x] * 3 + sum[x - 1] + 8) >> 4;
          o[2 * x + 1] = (sum[x] * 3 + sum[x + 1] + 7) >> 4;
        }
        o[2 * dw - 2] = (sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4;
        o[2 * dw - 1] = (sum[dw - 1] * 4 + 7) >> 4;
        for (int x = 0; x < width_; ++x) out[size_t(y) * width_ + x] = u8(o[x]);
      }
      return out;
    }
    // replication (int_upsample, h2v1_upsample, h2v2_upsample)
    hr_vr_replicate(s, pw, hr, vr, out);
    return out;
  }

  void hr_vr_replicate(const std::vector<u8> &s, long pw, int hr, int vr,
                       std::vector<u8> &out) const {
    for (int y = 0; y < height_; ++y)
      for (int x = 0; x < width_; ++x)
        out[size_t(y) * width_ + x] = s[size_t(y / vr) * pw + x / hr];
  }

  void output(u8 *out) const {
    const size_t npix = size_t(width_) * height_;
    if (colour_ == 1 || colour_ == 3) {
      const size_t nc = comps_.size();
      for (size_t c = 0; c < nc; ++c) {
        if (colour_ == 1 && (comps_[c].h != comps_[0].h || comps_[c].v != comps_[0].v))
          fail("JPEG-in-TIFF with subsampled components outside YCbCr is not supported");
        std::vector<u8> p = plane(comps_[c], colour_ == 3);
        for (size_t i = 0; i < npix; ++i) out[nc * i + c] = p[i];
      }
      return;
    }
    if (comps_.size() == 1) {
      std::vector<u8> g = plane(comps_[0]);
      for (size_t i = 0; i < npix; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
      return;
    }
    std::vector<u8> p0 = plane(comps_[0]), p1 = plane(comps_[1]), p2 = plane(comps_[2]);
    if (comps_.size() == 4) return output_cmyk(out, p0, p1, p2, plane(comps_[3]));
    bool rgb;
    if (colour_ == 2) {
      rgb = false;
    } else if (jfif_) {
      rgb = false;
    } else if (adobe_) {
      rgb = adobe_transform_ == 0;
    } else {
      rgb = comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
    }
    if (rgb) {
      for (size_t i = 0; i < npix; ++i) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return;
    }
    auto clamp = [](int v) { return u8(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < npix; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp(y + kYcc.cr_r[cr]);
      out[3 * i + 1] = clamp(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp(y + kYcc.cb_b[cb]);
    }
  }

  // four components: CMYK, or YCCK (Adobe transform 2, or any transform
  // but 0, as libjpeg assumes) through jdcolor.c's ycck_cmyk_convert; then
  // Pillow's "CMYK;I" unpacking (each channel inverted) and Convert.c's
  // cmyk2rgb
  void output_cmyk(u8 *out, const std::vector<u8> &p0, const std::vector<u8> &p1,
                   const std::vector<u8> &p2, const std::vector<u8> &p3) const {
    const size_t npix = size_t(width_) * height_;
    const bool ycck = adobe_ && adobe_transform_ != 0;
    auto clamp = [](int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); };
    auto muldiv255 = [](int a, int b) {
      const int t = a * b + 128;
      return ((t >> 8) + t) >> 8;
    };
    for (size_t i = 0; i < npix; ++i) {
      int c = p0[i], m = p1[i], y = p2[i];
      if (ycck) {
        const int luma = p0[i], cb = p1[i], cr = p2[i];
        c = clamp(255 - (luma + kYcc.cr_r[cr]));
        m = clamp(255 - (luma + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
        y = clamp(255 - (luma + kYcc.cb_b[cb]));
      }
      const int nk = p3[i];  // 255 - (255 - K)
      out[3 * i] = u8(clamp(nk - muldiv255(255 - c, nk)));
      out[3 * i + 1] = u8(clamp(nk - muldiv255(255 - m, nk)));
      out[3 * i + 2] = u8(clamp(nk - muldiv255(255 - y, nk)));
    }
  }
};

// ---------------------------------------------------------------- encoder

constexpr u8 kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr u8 kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: code counts by length 1..16, then the symbols
constexpr u8 kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr u8 kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
constexpr u8 kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr u8 kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr u8 kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr u8 kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr u8 kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Codes {
  uint16_t code[256] = {};
  u8 size[256] = {};
  Codes(const u8 *bits, const u8 *vals) {
    int code_ = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int j = 0; j < bits[l - 1]; ++j, ++k, ++code_) {
        code[vals[k]] = uint16_t(code_);
        size[vals[k]] = u8(l);
      }
      code_ <<= 1;
    }
  }
};

// jcdctmgr.c compute_reciprocal for 16-bit DCTELEM (libjpeg-turbo with
// SIMD): quantising x by `divisor` is ((|x| + corr) * recip) >> shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

// jpeg_fdct_islow on one block of centred samples, in place
void fdct_islow(int32_t *data) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    for (int ctr = 0; ctr < 8; ++ctr) {
      int32_t *p = data + ctr * next;
      int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int32_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int32_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int n = pass ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
      if (pass) {
        p[0] = descale(tmp10 + tmp11, kPass1Bits);
        p[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      } else {
        p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        p[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * F_0_541;
      p[2 * step] = descale(z1 + tmp13 * F_0_765, n);
      p[6 * step] = descale(z1 + tmp12 * -F_1_847, n);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * F_1_175;
      tmp4 *= F_0_298;
      tmp5 *= F_2_053;
      tmp6 *= F_3_072;
      tmp7 *= F_1_501;
      z1 *= -F_0_899;
      z2 *= -F_2_562;
      z3 *= -F_1_961;
      z4 *= -F_0_390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, n);
      p[5 * step] = descale(tmp5 + z2 + z4, n);
      p[3 * step] = descale(tmp6 + z2 + z3, n);
      p[step] = descale(tmp7 + z1 + z4, n);
    }
  }
}

class BitWriter {
 public:
  std::vector<u8> out;
  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    bits_ += size;
    while (bits_ >= 8) {
      u8 b = u8(acc_ >> (bits_ - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      bits_ -= 8;
    }
  }
  // pad the last byte with ones (jchuff.c flush_bits)
  void flush() {
    if (bits_) put((1u << (8 - bits_)) - 1, 8 - bits_);
  }

 private:
  uint64_t acc_ = 0;
  int bits_ = 0;
};

struct Plane {
  std::vector<u8> s;
  long w = 0, h = 0;  // padded size
  u8 at(long y, long x) const { return s[size_t(y * w + x)]; }
};

std::vector<u8> encode(const u8 *px, long height, long width, int channels,
                       int quality) {
  if (height < 1 || width < 1 || height > 65535 || width > 65535)
    fail("JPEG encoder: image size out of range");
  if (channels != 1 && channels != 3)
    fail("JPEG encoder: 1 or 3 channels expected");
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t q[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      long v = ((t ? kChromaQuant[i] : kLumaQuant[i]) * long(scale) + 50) / 100;
      q[t][i] = uint16_t(std::min(std::max(v, 1L), 255L));
    }
  const int nc = channels;
  const int hmax = nc == 3 ? 2 : 1, vmax = hmax;
  const long mcux = (width + 8 * hmax - 1) / (8 * hmax);
  const long mcuy = (height + 8 * vmax - 1) / (8 * vmax);

  // the components' samples, edge-expanded as jcprepct.c / jcsample.c do
  std::vector<Plane> planes(nc);
  if (nc == 1) {
    Plane &p = planes[0];
    p.w = mcux * 8;
    p.h = mcuy * 8;
    p.s.resize(size_t(p.w * p.h));
    for (long y = 0; y < p.h; ++y)
      for (long x = 0; x < p.w; ++x)
        p.s[size_t(y * p.w + x)] =
            px[std::min(y, height - 1) * width + std::min(x, width - 1)];
  } else {
    // jccolor.c rgb_ycc_convert, SCALEBITS 16
    const long fw = mcux * 16, fh = mcuy * 16;
    std::vector<u8> full[3];
    for (auto &f : full) f.resize(size_t(fw * fh));
    for (long y = 0; y < height; ++y)
      for (long x = 0; x < width; ++x) {
        const u8 *c = px + 3 * (y * width + x);
        int32_t r = c[0], g = c[1], b = c[2];
        size_t i = size_t(y * fw + x);
        full[0][i] = u8((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
        full[1][i] = u8((-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16);
        full[2][i] = u8((32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16);
      }
    // rows: the last image row repeated (to the row group, then to the
    // iMCU); columns: the last image column repeated
    for (auto &f : full) {
      for (long y = 0; y < height; ++y)
        for (long x = width; x < fw; ++x) f[size_t(y * fw + x)] = f[size_t(y * fw + width - 1)];
      for (long y = height; y < fh; ++y)
        std::memcpy(&f[size_t(y * fw)], &f[size_t((height - 1) * fw)], size_t(fw));
    }
    Plane &luma = planes[0];
    luma.w = fw;
    luma.h = fh;
    luma.s = std::move(full[0]);
    // h2v2_downsample: rows beyond the image's row groups are the last
    // downsampled row repeated
    const long rows = (height + 1) / 2;
    for (int c = 1; c < 3; ++c) {
      Plane &p = planes[c];
      p.w = mcux * 8;
      p.h = mcuy * 8;
      p.s.resize(size_t(p.w * p.h));
      const std::vector<u8> &f = full[c];
      for (long y = 0; y < p.h; ++y) {
        long sy = std::min(y, rows - 1) * 2;
        for (long x = 0; x < p.w; ++x) {
          int bias = (x & 1) ? 2 : 1;
          int v = f[size_t(sy * fw + 2 * x)] + f[size_t(sy * fw + 2 * x + 1)] +
                  f[size_t((sy + 1) * fw + 2 * x)] + f[size_t((sy + 1) * fw + 2 * x + 1)];
          p.s[size_t(y * p.w + x)] = u8((v + bias) >> 2);
        }
      }
    }
  }

  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(uint32_t(q[t][i]) << 3);
  auto quantised = [&](const Plane &p, long by, long bx, int t, int16_t *out) {
    int32_t blk[64];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) blk[8 * y + x] = int32_t(p.at(by * 8 + y, bx * 8 + x)) - 128;
    fdct_islow(blk);
    for (int i = 0; i < 64; ++i) {
      int32_t v = blk[i];
      const Divisor &d = div[t][i];
      uint32_t a = uint32_t(v < 0 ? -v : v);
      int32_t r = int32_t((uint64_t(a + d.corr) * d.recip) >> d.shift);
      out[i] = int16_t(v < 0 ? -r : r);
    }
  };

  const Codes dc_codes[2] = {Codes(kDcLumaBits, kDcVals), Codes(kDcChromaBits, kDcVals)};
  const Codes ac_codes[2] = {Codes(kAcLumaBits, kAcLumaVals), Codes(kAcChromaBits, kAcChromaVals)};
  BitWriter bw;
  int pred[3] = {0, 0, 0};
  auto emit = [&](const int16_t *b, int c) {
    const int t = c ? 1 : 0;
    int diff = b[0] - pred[c];
    pred[c] = b[0];
    auto put_value = [&](int v, const Codes &codes, int run) {
      int a = v < 0 ? -v : v, nbits = 0;
      while (a) {
        ++nbits;
        a >>= 1;
      }
      int sym = (run << 4) + nbits;
      bw.put(codes.code[sym], codes.size[sym]);
      if (nbits) bw.put(uint32_t(v < 0 ? v - 1 : v), nbits);
    };
    put_value(diff, dc_codes[t], 0);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = b[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(ac_codes[t].code[0xF0], ac_codes[t].size[0xF0]);
        run -= 16;
      }
      put_value(v, ac_codes[t], run);
      run = 0;
    }
    if (run > 0) bw.put(ac_codes[t].code[0], ac_codes[t].size[0]);
  };

  int16_t blk[64];
  if (nc == 1) {
    const long wib = (width + 7) / 8, hib = (height + 7) / 8;
    for (long by = 0; by < hib; ++by)
      for (long bx = 0; bx < wib; ++bx) {
        quantised(planes[0], by, bx, 0, blk);
        emit(blk, 0);
      }
  } else {
    // jccoefct.c compress_data: luma blocks past the component's width or
    // height in blocks are dummies, zero but for the DC of the block before
    const long wib = (width + 7) / 8, hib = (height + 7) / 8;
    int16_t mcu[4][64];
    for (long my = 0; my < mcuy; ++my)
      for (long mx = 0; mx < mcux; ++mx) {
        for (int y = 0; y < 2; ++y)
          for (int x = 0; x < 2; ++x) {
            long by = my * 2 + y, bx = mx * 2 + x;
            int16_t *b = mcu[2 * y + x];
            if (by < hib && bx < wib) {
              quantised(planes[0], by, bx, 0, b);
            } else {
              std::memset(b, 0, sizeof(mcu[0]));
              b[0] = mcu[2 * y + x - 1][0];
            }
          }
        for (int i = 0; i < 4; ++i) emit(mcu[i], 0);
        for (int c = 1; c < 3; ++c) {
          quantised(planes[c], my, mx, 1, blk);
          emit(blk, c);
        }
      }
  }
  bw.flush();

  std::vector<u8> f;
  auto put2 = [&](int v) {
    f.push_back(u8(v >> 8));
    f.push_back(u8(v));
  };
  f.insert(f.end(), {0xFF, 0xD8, 0xFF, 0xE0});
  put2(16);
  f.insert(f.end(), {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < (nc == 3 ? 2 : 1); ++t) {
    f.insert(f.end(), {0xFF, 0xDB});
    put2(67);
    f.push_back(u8(t));
    for (int k = 0; k < 64; ++k) f.push_back(u8(q[t][kNatural[k]]));
  }
  f.insert(f.end(), {0xFF, 0xC0});
  put2(8 + 3 * nc);
  f.push_back(8);
  put2(int(height));
  put2(int(width));
  f.push_back(u8(nc));
  for (int c = 0; c < nc; ++c) {
    f.push_back(u8(c + 1));
    f.push_back(u8(c == 0 ? (hmax << 4 | vmax) : 0x11));
    f.push_back(u8(c ? 1 : 0));
  }
  auto dht = [&](int index, const u8 *bits, const u8 *vals) {
    int total = 0;
    for (int l = 0; l < 16; ++l) total += bits[l];
    f.insert(f.end(), {0xFF, 0xC4});
    put2(2 + 1 + 16 + total);
    f.push_back(u8(index));
    f.insert(f.end(), bits, bits + 16);
    f.insert(f.end(), vals, vals + total);
  };
  dht(0x00, kDcLumaBits, kDcVals);
  dht(0x10, kAcLumaBits, kAcLumaVals);
  if (nc == 3) {
    dht(0x01, kDcChromaBits, kDcVals);
    dht(0x11, kAcChromaBits, kAcChromaVals);
  }
  f.insert(f.end(), {0xFF, 0xDA});
  put2(6 + 2 * nc);
  f.push_back(u8(nc));
  for (int c = 0; c < nc; ++c) {
    f.push_back(u8(c + 1));
    f.push_back(u8(c ? 0x11 : 0x00));
  }
  f.insert(f.end(), {0, 63, 0});
  f.insert(f.end(), bw.out.begin(), bw.out.end());
  f.insert(f.end(), {0xFF, 0xD9});
  return f;
}

void message(char *err, long cap, const char *what) {
  if (cap <= 0) return;
  std::strncpy(err, what, size_t(cap - 1));
  err[cap - 1] = 0;
}

}  // namespace

extern "C" {

// the image's height, width and components; 0, or -1 with `err` written
int jpeg_info(const u8 *data, long size, long *dims, char *err, long errcap) {
  try {
    Decoder d(data, size_t(size));
    d.read_header();
    dims[0] = d.height();
    dims[1] = d.width();
    dims[2] = d.components();
    return 0;
  } catch (const std::exception &e) {
    message(err, errcap, e.what());
    return -1;
  }
}

// decode into `out`, (height, width, 3) uint8 RGB, or (height, width,
// components) for `colour` 1 (see Decoder::decode); 0, or -1 with `err`
int jpeg_decode(const u8 *data, long size, u8 *out, int colour, char *err,
                long errcap) {
  try {
    Decoder d(data, size_t(size));
    d.read_header();
    d.decode(out, colour);
    return 0;
  } catch (const std::exception &e) {
    message(err, errcap, e.what());
    return -1;
  }
}

// encode (height, width, channels) uint8 at `quality` into `out`: the
// file's size, its negated size when `cap` is too small, or -1 with `err`
// (a size of 1 is never negated: a file holds at least 2 bytes)
long jpeg_encode(const u8 *pixels, long height, long width, int channels,
                 int quality, u8 *out, long cap, char *err, long errcap) {
  try {
    std::vector<u8> f = encode(pixels, height, width, channels, quality);
    long n = long(f.size());
    if (n > cap) return -n;
    std::memcpy(out, f.data(), f.size());
    return n;
  } catch (const std::exception &e) {
    message(err, errcap, e.what());
    return -1;
  }
}

}  // extern "C"

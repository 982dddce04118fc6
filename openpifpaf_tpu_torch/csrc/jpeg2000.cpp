// JPEG 2000 codestream decoder, for hosts without PIL.
//
// It gives what PIL 12 gives through openjpeg 2.5 (Pillow's
// Jpeg2KDecode.c): ISO 15444-1 part 1 codestreams with the main and tile
// headers (SIZ, COD, COC, QCD, QCC, SOT, SOD; COM, TLM, PLM, PLT and CRG
// skipped), tiles in any number of tile-parts, tier-2 packets with tag
// trees in the five progression orders (position-driven ones as
// openjpeg's pi.c walks them), SOP and EPH markers, precincts, quality
// layers, tier-1 with the MQ decoder and its three coding passes (the
// code-block styles RESET, VSC, ERTERM and SEGSYM), the reversible 5/3
// and the irreversible 9/7 inverse wavelet (the 9/7 in openjpeg's float
// operations, in its order: its lifting constants and its "two_invK"
// scaling with the matching step sizes; built without contracting
// multiply-adds), the RCT and the ICT, the DC level shift and clamping,
// and components subsampled by (dx, dy) and at any precision up to 16
// bits.  The tiles then go through Pillow's unpackers, quirks kept: each
// tile's components are read at (w / dx) samples a row, values above 8
// bits are rounded and shifted into a byte that may wrap.  It refuses,
// by message: the BYPASS and TERMALL code-block styles, HT code-blocks,
// POC, PPM and PPT (packed packet headers), RGN (region of interest),
// and truncated or corrupt data.
//
// Plain C interface (ctypes): j2k_info reads the size and components;
// j2k_decode writes (height, width, 3) uint8 RGB for Pillow's mode
// (0 L, 1 I;16, 2 LA, 3 RGB, 4 RGBA, 5 CMYK) and openjpeg's colour space
// (0 unspecified, 1 sRGB, 2 greyscale, 3 sYCC, 5 CMYK; Pillow reads three
// unspecified components with subsampled chroma as sYCC and converts by
// its own YCbCr tables); both return -1 with a message on failure.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

using u8 = uint8_t;

struct J2kError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string &what) {
  throw J2kError("JPEG 2000: " + what);
}

inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, int e) { return (a + (int64_t(1) << e) - 1) >> e; }
inline int floorlog2(uint32_t v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

// ------------------------------------------------------------ MQ decoder

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

// ISO 15444-1 table C.2
constexpr MqState kMq[47] = {
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
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// contexts as openjpeg numbers them: zero coding 0-8, sign 9-13,
// magnitude refinement 14-16, run length 17, uniform 18
constexpr int kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18;
constexpr int kNumCtx = 19;

struct Mq {
  const u8 *bp = nullptr;  // the data is followed by two 0xFF bytes
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[kNumCtx], mps[kNumCtx];

  void reset() {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[0] = 4;
    state[kCtxAgg] = 3;
    state[kCtxUni] = 46;
  }
  void bytein() {  // ISO 15444-1 C.3.4, as openjpeg's opj_mqc_bytein
    const uint32_t next = bp[1];
    if (*bp == 0xFF) {
      if (next > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += next << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += next << 8;
      ct = 8;
    }
  }
  void init(const u8 *data) {  // INITDEC
    bp = data;
    c = uint32_t(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {  // DECODE, openjpeg's opj_mqc_decode_macro
    const MqState &s = kMq[state[cx]];
    const uint32_t qe = s.qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        a = qe;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = qe;
        d = 1 - mps[cx];
        if (s.sw) mps[cx] ^= 1;
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] ^= 1;
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// -------------------------------------------------------------- tier 1

constexpr int kStyleBypass = 1, kStyleReset = 2, kStyleTermAll = 4,
              kStyleVsc = 8, kStyleSegSym = 32, kStyleHt = 64;

// Zero-coding contexts (ISO 15444-1 table D.1) by orientation and the
// packed neighbour counts: horizontal (bits 0-1), vertical (2-3) and
// diagonal (4-6) significant neighbours.
struct ZcTable {
  u8 ctx[4][128];
  ZcTable() {
    for (int orient = 0; orient < 4; ++orient)
      for (int packed = 0; packed < 128; ++packed) {
        int hh = packed & 3, vv = (packed >> 2) & 3;
        const int dd = packed >> 4;
        if (orient == 1) std::swap(hh, vv);
        int c;
        if (orient == 3) {
          const int hv = hh + vv;
          if (dd >= 3) c = 8;
          else if (dd == 2) c = hv >= 1 ? 7 : 6;
          else if (dd == 1) c = hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
          else c = hv >= 2 ? 2 : hv;
        } else if (hh == 2) {
          c = 8;
        } else if (hh == 1) {
          c = vv >= 1 ? 7 : (dd >= 1 ? 6 : 5);
        } else if (vv == 2) {
          c = 4;
        } else if (vv == 1) {
          c = 3;
        } else {
          c = dd >= 2 ? 2 : dd;
        }
        ctx[orient][packed] = u8(c);
      }
  }
};
const ZcTable kZc;

// Decode one code-block: `data` (with two spare bytes), `passes` coding
// passes from bit-plane `numbps`; coefficients (twice the magnitude, the
// half bit of openjpeg's reconstruction) into `out` (w * h).
void decode_block(const u8 *data, int passes, int numbps, int w, int h,
                  int orient, int style, int32_t *out) {
  std::fill(out, out + size_t(w) * h, 0);
  if (passes <= 0 || numbps <= 0) return;
  const int W = w + 2;
  // per sample (with a border of one): significant, negative, coded in
  // this bit-plane's significance pass, refined before; and the packed
  // counts of significant neighbours
  thread_local std::vector<u8> state, counts;
  state.assign(size_t(W) * (h + 2), 0);
  counts.assign(state.size(), 0);
  enum : u8 { kSig = 1, kNeg = 2, kVisited = 4, kRefined = 8 };
  const u8 *zc = kZc.ctx[orient];
  auto at = [W](int x, int y) { return size_t(y + 1) * W + size_t(x + 1); };
  const bool vsc = style & kStyleVsc;
  Mq mq;
  mq.reset();
  mq.init(data);

  auto decode_sign = [&](int x, int y) {
    const size_t i = at(x, y);
    // in VSC mode the stripe below does not count
    const bool below = !(vsc && (y & 3) == 3);
    auto contribution = [&](size_t j) {
      return (state[j] & kSig) ? ((state[j] & kNeg) ? -1 : 1) : 0;
    };
    const int hc = std::clamp(contribution(i - 1) + contribution(i + 1), -1, 1);
    const int vc = std::clamp(contribution(i - W) + (below ? contribution(i + W) : 0), -1, 1);
    // ISO 15444-1 table D.3, by (1 - H, 1 - V)
    static const int ctx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
    static const int flip[3][3] = {{0, 0, 0}, {0, 0, 1}, {1, 1, 1}};
    return mq.decode(kCtxSc + ctx[1 - hc][1 - vc] - 9) ^ flip[1 - hc][1 - vc];
  };
  auto make_significant = [&](int x, int y, int value) {
    const size_t i = at(x, y);
    const int s = decode_sign(x, y);
    state[i] |= u8(kSig | (s ? kNeg : 0));
    out[size_t(y) * w + x] = s ? -value : value;
    counts[i - 1] += 1;
    counts[i + 1] += 1;
    counts[i + W] += 4;
    counts[i + W - 1] += 16;
    counts[i + W + 1] += 16;
    if (!(vsc && (y & 3) == 0)) {  // the stripe above sees it unless VSC
      counts[i - W] += 4;
      counts[i - W - 1] += 16;
      counts[i - W + 1] += 16;
    }
  };

  int pass_type = 2, bp1 = numbps;
  for (int p = 0; p < passes && bp1 >= 1; ++p) {
    const int one = 1 << bp1, half = one >> 1, oneplushalf = one | half;
    if (pass_type == 0) {  // significance propagation
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; ++x)
          for (int y = y0; y < std::min(y0 + 4, h); ++y) {
            const size_t i = at(x, y);
            if ((state[i] & kSig) || !counts[i]) continue;
            if (mq.decode(zc[counts[i]])) make_significant(x, y, oneplushalf);
            state[i] |= kVisited;
          }
    } else if (pass_type == 1) {  // magnitude refinement
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; ++x)
          for (int y = y0; y < std::min(y0 + 4, h); ++y) {
            const size_t i = at(x, y);
            if ((state[i] & (kSig | kVisited)) != kSig) continue;
            const int cx = (state[i] & kRefined) ? kCtxMag + 2
                                                 : (counts[i] ? kCtxMag + 1 : kCtxMag);
            const int v = mq.decode(cx);
            int32_t &d = out[size_t(y) * w + x];
            d += (v ^ (d < 0)) ? half : -half;
            state[i] |= kRefined;
          }
    } else {  // cleanup
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; ++x) {
          int y = y0;
          const int y1 = std::min(y0 + 4, h);
          if (y1 - y0 == 4) {
            bool run = true;
            for (int k = y0; k < y1 && run; ++k) {
              const size_t i = at(x, k);
              run = !(state[i] & (kSig | kVisited)) && !counts[i];
            }
            if (run) {
              if (!mq.decode(kCtxAgg)) {
                y = y1;
              } else {
                int r = mq.decode(kCtxUni) << 1;
                r |= mq.decode(kCtxUni);
                y = y0 + r;
                make_significant(x, y, oneplushalf);
                ++y;
              }
            }
          }
          for (; y < y1; ++y) {
            const size_t i = at(x, y);
            if (state[i] & (kSig | kVisited)) continue;
            if (mq.decode(zc[counts[i]])) make_significant(x, y, oneplushalf);
          }
          for (int k = y0; k < y1; ++k) state[at(x, k)] &= u8(~kVisited);
        }
      if (style & kStyleSegSym)
        for (int k = 0; k < 4; ++k) mq.decode(kCtxUni);
    }
    if (style & kStyleReset) mq.reset();
    if (++pass_type == 3) {
      pass_type = 0;
      --bp1;
    }
  }
}

// ---------------------------------------------------------------- headers

struct Comp {
  int prec = 8;
  bool sgnd = false;
  int dx = 1, dy = 1;
};

struct Coding {
  int levels = 5, xcb = 6, ycb = 6, style = 0, reversible = 1;
  int ppx[33], ppy[33];
  Coding() {
    std::fill(ppx, ppx + 33, 15);
    std::fill(ppy, ppy + 33, 15);
  }
};

struct Quant {
  int guard = 2, style = 0;
  std::vector<std::pair<int, int>> steps;  // (exponent, mantissa)
  std::pair<int, int> step(int band) const {
    if (style == 1) {  // derived from the LL band's
      const int e = steps[0].first - (band - 1 < 0 ? 0 : (band - 1) / 3);
      return {band == 0 ? steps[0].first : std::max(e, 0), steps[0].second};
    }
    if (band >= int(steps.size())) fail("a quantisation step is missing");
    return steps[size_t(band)];
  }
};

struct Params {  // what COD/COC/QCD/QCC set, main or tile
  int progression = 0, layers = 1, mct = 0, scod = 0;
  std::vector<Coding> coding;
  std::vector<Quant> quant;
  std::vector<int> coding_level, quant_level;  // who set each component's
};

struct Reader {
  const u8 *d;
  size_t n, pos = 0;
  int byte() {
    if (pos >= n) fail("truncated data");
    return d[pos++];
  }
  int word() {
    int hi = byte();
    return hi << 8 | byte();
  }
  uint32_t dword() {
    uint32_t hi = uint32_t(word());
    return hi << 16 | uint32_t(word());
  }
};

void read_spcod(Reader &r, Coding &c, bool precincts) {
  c.levels = r.byte();
  if (c.levels > 32) fail("more than 32 decomposition levels");
  c.xcb = (r.byte() & 15) + 2;
  c.ycb = (r.byte() & 15) + 2;
  if (c.xcb + c.ycb > 12) fail("code-blocks larger than 4096 samples");
  c.style = r.byte();
  c.reversible = r.byte();
  if (c.reversible > 1) fail("a wavelet transform other than 5/3 and 9/7");
  if (c.style & kStyleHt) fail("HT (high-throughput) code-blocks are not supported");
  if (c.style & kStyleBypass)
    fail("the BYPASS (lazy) code-block style is not supported");
  if (c.style & kStyleTermAll)
    fail("the TERMALL code-block style is not supported");
  for (int i = 0; i <= c.levels; ++i) {
    int v = precincts ? r.byte() : 0xFF;
    c.ppx[i] = precincts ? (v & 15) : 15;
    c.ppy[i] = precincts ? (v >> 4) : 15;
    if (precincts && i > 0 && (c.ppx[i] == 0 || c.ppy[i] == 0))
      fail("a precinct of size 1 above resolution 0");
  }
}

void read_quant(Reader &r, Quant &q, size_t end) {
  const int s = r.byte();
  q.guard = s >> 5;
  q.style = s & 31;
  q.steps.clear();
  if (q.style == 0) {
    while (r.pos < end) q.steps.push_back({r.byte() >> 3, 0});
  } else if (q.style == 1 || q.style == 2) {
    while (r.pos + 1 < end) {
      const int v = r.word();
      q.steps.push_back({v >> 11, v & 0x7FF});
    }
  } else {
    fail("quantisation style " + std::to_string(q.style));
  }
  if (q.steps.empty()) fail("a quantisation segment without steps");
  r.pos = end;
}

struct Image {
  int64_t x1 = 0, y1 = 0, x0 = 0, y0 = 0, tw = 0, th = 0, tx0 = 0, ty0 = 0;
  std::vector<Comp> comps;
  int tiles_x = 0, tiles_y = 0;
};

// ---------------------------------------------------------- tile model

struct TagTree {
  struct Node {
    int parent = -1, value = 999, low = 0;
  };
  std::vector<Node> nodes;
  TagTree() = default;
  TagTree(int w, int h) {
    if (w <= 0 || h <= 0) return;
    std::vector<std::pair<int, int>> levels;
    int lw = w, lh = h;
    for (;;) {
      levels.push_back({lw, lh});
      if (lw == 1 && lh == 1) break;
      lw = (lw + 1) / 2;
      lh = (lh + 1) / 2;
    }
    size_t total = 0;
    for (auto &l : levels) total += size_t(l.first) * l.second;
    nodes.resize(total);
    size_t start = 0;
    for (size_t k = 0; k + 1 < levels.size(); ++k) {
      const int cw = levels[k].first, ch = levels[k].second;
      const size_t next = start + size_t(cw) * ch;
      const int pw = levels[k + 1].first;
      for (int j = 0; j < ch; ++j)
        for (int i = 0; i < cw; ++i)
          nodes[start + size_t(j) * cw + i].parent = int(next + size_t(j / 2) * pw + i / 2);
      start = next;
    }
  }
};

struct BitReader {  // openjpeg's opj_bio: a byte after 0xFF holds 7 bits
  const u8 *p, *end;
  uint32_t buf = 0;
  int ct = 0;
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (p < end) buf |= *p++;
  }
  int bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= uint32_t(bit()) << i;
    return v;
  }
  void align() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
};

int tag_decode(BitReader &b, TagTree &t, int leaf, int threshold) {
  int stack[64], depth = 0;
  int node = leaf;
  while (t.nodes[size_t(node)].parent >= 0) {
    stack[depth++] = node;
    node = t.nodes[size_t(node)].parent;
  }
  int low = 0;
  for (;;) {
    TagTree::Node &n = t.nodes[size_t(node)];
    if (low > n.low) {
      n.low = low;
    } else {
      low = n.low;
    }
    while (low < threshold && low < n.value) {
      if (b.bit()) {
        n.value = low;
      } else {
        ++low;
      }
    }
    n.low = low;
    if (depth == 0) break;
    node = stack[--depth];
  }
  return t.nodes[size_t(node)].value < threshold;
}

struct Block {
  int64_t x0, y0, x1, y1;
  bool included = false;
  int numbps = 0, lblock = 3, passes = 0;
  std::vector<u8> data;
};

struct Precinct {
  int cw = 0, ch = 0;
  std::vector<Block> blocks;
  TagTree incl, zero;
};

struct Band {
  int orient = 0;  // 0 LL, 1 HL, 2 LH, 3 HH
  int64_t x0, y0, x1, y1;
  int numbps = 0;
  float stepsize = 0;
  std::vector<Precinct> precincts;
  bool empty() const { return x0 >= x1 || y0 >= y1; }
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int ppx, ppy, pw = 0, ph = 0;
  std::vector<Band> bands;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  std::vector<Resolution> res;
  std::vector<int32_t> ints;    // reversible coefficients, then samples
  std::vector<float> floats;    // irreversible coefficients
};

float band_stepsize(const Quant &q, int band_index, int prec, bool reversible,
                    int orient) {
  const auto [expn, mant] = q.step(band_index);
  const int gain = reversible ? (orient == 0 ? 0 : (orient == 3 ? 2 : 1)) : 0;
  const int rb = prec + gain;
  return float((1.0 + mant / 2048.0) * std::pow(2.0, double(rb - expn)));
}

// ------------------------------------------------------------- wavelets

// 5/3 synthesis of one line: `low` (sn) and `high` (dn) into `out`
// (sn + dn samples starting at parity `cas`), ISO 15444-1 F.3.8
void idwt53(const int32_t *low, const int32_t *high, int sn, int dn, int cas,
            int32_t *out) {
  const int n = sn + dn;
  if (n == 0) return;
  if (n == 1) {
    out[0] = cas ? high[0] / 2 : low[0];
    return;
  }
  std::vector<int32_t> x(static_cast<size_t>(n));
  for (int i = 0; i < sn; ++i) x[size_t(cas + 2 * i)] = low[i];
  for (int i = 0; i < dn; ++i) x[size_t(1 - cas + 2 * i)] = high[i];
  auto mirror = [n](int i) {
    while (i < 0 || i >= n) i = i < 0 ? -i : 2 * (n - 1) - i;
    return i;
  };
  // position p stands for the coordinate i0 + p, i0 % 2 == cas: even
  // coordinates hold the low samples
  std::vector<int32_t> y = x;
  for (int p = 0; p < n; ++p)
    if (((p + cas) & 1) == 0)
      x[size_t(p)] = y[size_t(p)] -
                     ((y[size_t(mirror(p - 1))] + y[size_t(mirror(p + 1))] + 2) >> 2);
  for (int p = 0; p < n; ++p)
    if ((p + cas) & 1)
      x[size_t(p)] = y[size_t(p)] + ((x[size_t(mirror(p - 1))] + x[size_t(mirror(p + 1))]) >> 1);
  std::copy(x.begin(), x.end(), out);
}

// openjpeg 2.5's 9/7 constants (dwt.c), and its scaling of the high band
// by 2/K ("BUG_WEIRD_TWO_INVK")
constexpr float kDelta = 0.443506852f, kGamma = 0.882911075f,
                kBeta = -0.052980118f, kAlpha = -1.586134342f;
constexpr float kK = 1.230174105f, kTwoInvK = 1.625732422f;

// openjpeg's opj_v8dwt_decode_step2 on one lane: w[i-1] += (l + w) * c
void step2(float *w, int lpos, int wpos, int end, int m, float c) {
  int fl = lpos, fw = wpos;
  const int imax = std::min(end, m);
  for (int i = 0; i < imax; ++i) {
    w[fw - 1] = w[fw - 1] + ((w[fl] + w[fw]) * c);
    fl = fw;
    fw += 2;
  }
  if (m < end) {
    c += c;
    w[fw - 1] = w[fw - 1] + w[fl] * c;
  }
}

// 9/7 synthesis of one line as openjpeg's opj_v8dwt_decode; `w` holds the
// interleaved samples (lows at cas, cas + 2, ...) and two spare floats
void idwt97(float *w, int sn, int dn, int cas) {
  int a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  for (int i = 0; i < sn; ++i) w[a + 2 * i] *= kK;
  for (int i = 0; i < dn; ++i) w[b + 2 * i] *= kTwoInvK;
  step2(w, b, a + 1, sn, std::min(sn, dn - a), -kDelta);
  step2(w, a, b + 1, dn, std::min(dn, sn - b), -kGamma);
  step2(w, b, a + 1, sn, std::min(sn, dn - a), -kBeta);
  step2(w, a, b + 1, dn, std::min(dn, sn - b), -kAlpha);
}

// Pillow's ConvertYCbCr.c tables: (int)(v * 64 + 0.5) of each product,
// shifted down by 6 after the sums
struct YccTables {
  int r_cr[256], g_cb[256], g_cr[256], b_cb[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      const double x = i - 128;
      r_cr[i] = int(x * 1.40200 * 64 + 0.5);
      g_cb[i] = int(x * -0.34414 * 64 + 0.5);
      g_cr[i] = int(x * -0.71414 * 64 + 0.5);
      b_cb[i] = int(x * 1.77200 * 64 + 0.5);
    }
  }
};
const YccTables kYcc;

// ------------------------------------------------------------------ decoder

struct TileData {
  std::vector<u8> bytes;  // the tile-parts' bodies, in order
  bool seen = false;
  Params params;
};

class Decoder {
 public:
  Decoder(const u8 *d, size_t n) : r_{d, n} {}

  void header() {
    if (r_.word() != 0xFF4F) fail("no SOC marker");
    if (r_.word() != 0xFF51) fail("no SIZ marker after SOC");
    siz();
    for (;;) {
      const int m = r_.word();
      if (m == 0xFF90) {
        r_.pos -= 2;
        break;
      }
      segment(m, main_, -1);
    }
    if (!have_cod_ || !have_qcd_) fail("no COD or QCD marker in the main header");
  }

  const Image &image() const { return im_; }

  void decode(int mode, int space, u8 *out) {
    tiles_.assign(size_t(im_.tiles_x) * im_.tiles_y, TileData{});
    while (r_.pos + 2 <= r_.n) {
      const int m = r_.word();
      if (m == 0xFFD9) break;
      if (m != 0xFF90) fail("corrupt data: expected SOT");
      sot();
    }
    const int64_t width = im_.x1 - im_.x0, height = im_.y1 - im_.y0;
    std::fill(out, out + size_t(width) * height * 3, 0);
    for (size_t t = 0; t < tiles_.size(); ++t) {
      if (!tiles_[t].seen) fail("a tile is missing");
      decode_tile(int(t), mode, space, out);
    }
  }

 private:
  Reader r_;
  Image im_;
  Params main_;
  bool have_cod_ = false, have_qcd_ = false;
  std::vector<TileData> tiles_;

  void siz() {
    const size_t start = r_.pos;
    const int len = r_.word();
    r_.word();  // Rsiz
    im_.x1 = r_.dword();
    im_.y1 = r_.dword();
    im_.x0 = r_.dword();
    im_.y0 = r_.dword();
    im_.tw = r_.dword();
    im_.th = r_.dword();
    im_.tx0 = r_.dword();
    im_.ty0 = r_.dword();
    const int n = r_.word();
    if (n < 1 || n > 16384) fail("bad component count");
    if (im_.x0 >= im_.x1 || im_.y0 >= im_.y1 || im_.tw == 0 || im_.th == 0 ||
        im_.tx0 > im_.x0 || im_.ty0 > im_.y0 || im_.tx0 + im_.tw <= im_.x0 ||
        im_.ty0 + im_.th <= im_.y0)
      fail("bad image or tile size");
    for (int i = 0; i < n; ++i) {
      Comp c;
      const int s = r_.byte();
      c.sgnd = s & 0x80;
      c.prec = (s & 0x7F) + 1;
      c.dx = r_.byte();
      c.dy = r_.byte();
      if (c.prec > 16) fail("components of more than 16 bits are not supported");
      if (c.dx < 1 || c.dy < 1) fail("bad component subsampling");
      im_.comps.push_back(c);
    }
    if (int(r_.pos - start) != len) fail("bad SIZ length");
    im_.tiles_x = int(ceildiv(im_.x1 - im_.tx0, im_.tw));
    im_.tiles_y = int(ceildiv(im_.y1 - im_.ty0, im_.th));
    if (int64_t(im_.tiles_x) * im_.tiles_y > 65535) fail("too many tiles");
    main_.coding.assign(size_t(n), Coding{});
    main_.quant.assign(size_t(n), Quant{});
    main_.coding_level.assign(size_t(n), 0);
    main_.quant_level.assign(size_t(n), 0);
  }

  int comp_index(Reader &r) {
    const int c = im_.comps.size() < 257 ? r.byte() : r.word();
    if (c >= int(im_.comps.size())) fail("a marker for a component that is not there");
    return c;
  }

  // a marker segment of the main header (tile < 0) or of a tile-part's
  // first header; precedence: tile COC/QCC > tile COD/QCD > main COC/QCC >
  // main COD/QCD (levels 4, 3, 2, 1)
  void segment(int m, Params &p, int tile) {
    if (m < 0xFF30 || m > 0xFFFF) fail("corrupt data: a marker was expected");
    if (m >= 0xFF30 && m <= 0xFF3F) return;  // no segment
    const size_t start = r_.pos;
    const int len = r_.word();
    if (len < 2 || start + size_t(len) > r_.n) fail("truncated marker segment");
    const size_t end = start + size_t(len);
    const int base = tile < 0 ? 0 : 2;
    if (m == 0xFF52) {  // COD
      p.scod = r_.byte();
      p.progression = r_.byte();
      p.layers = r_.word();
      p.mct = r_.byte();
      if (p.layers < 1) fail("no quality layers");
      if (p.progression > 4) fail("progression order " + std::to_string(p.progression));
      Coding c;
      read_spcod(r_, c, p.scod & 1);
      for (size_t i = 0; i < p.coding.size(); ++i)
        if (p.coding_level[i] <= base + 1) {
          p.coding[i] = c;
          p.coding_level[i] = base + 1;
        }
      if (tile < 0) have_cod_ = true;
    } else if (m == 0xFF53) {  // COC
      const int c = comp_index(r_);
      const int s = r_.byte();
      Coding cd;
      read_spcod(r_, cd, s & 1);
      p.coding[size_t(c)] = cd;
      p.coding_level[size_t(c)] = base + 2;
    } else if (m == 0xFF5C) {  // QCD
      Quant q;
      read_quant(r_, q, end);
      for (size_t i = 0; i < p.quant.size(); ++i)
        if (p.quant_level[i] <= base + 1) {
          p.quant[i] = q;
          p.quant_level[i] = base + 1;
        }
      if (tile < 0) have_qcd_ = true;
    } else if (m == 0xFF5D) {  // QCC
      const int c = comp_index(r_);
      Quant q;
      read_quant(r_, q, end);
      p.quant[size_t(c)] = q;
      p.quant_level[size_t(c)] = base + 2;
    } else if (m == 0xFF5F) {
      fail("progression order changes (POC) are not supported");
    } else if (m == 0xFF60 || m == 0xFF61) {
      fail("packed packet headers (PPM, PPT) are not supported");
    } else if (m == 0xFF5E) {
      fail("regions of interest (RGN) are not supported");
    }  // TLM, PLM, PLT, CRG, COM and unknown segments: skipped, as openjpeg
    r_.pos = end;
  }

  void sot() {
    const size_t start = r_.pos - 2;
    const int len = r_.word();
    if (len != 10) fail("bad SOT length");
    const int t = r_.word();
    const uint32_t psot = r_.dword();
    r_.byte();  // TPsot
    r_.byte();  // TNsot
    if (t >= int(tiles_.size())) fail("a tile index past the last tile");
    TileData &td = tiles_[size_t(t)];
    if (!td.seen) {
      td.params = main_;
      td.seen = true;
    }
    for (;;) {
      const int m = r_.word();
      if (m == 0xFF93) break;
      segment(m, td.params, t);
    }
    const size_t end = psot ? start + psot : r_.n - (r_.n >= 2 && r_.d[r_.n - 2] == 0xFF &&
                                                       r_.d[r_.n - 1] == 0xD9 ? 2 : 0);
    if (end > r_.n || end < r_.pos) fail("truncated tile-part");
    td.bytes.insert(td.bytes.end(), r_.d + r_.pos, r_.d + end);
    r_.pos = end;
  }

  void build(int t, std::vector<TileComp> &tcs, int64_t &tx0, int64_t &ty0,
             int64_t &tx1, int64_t &ty1) {
    const Params &p = tiles_[size_t(t)].params;
    const int px = t % im_.tiles_x, py = t / im_.tiles_x;
    tx0 = std::max(im_.tx0 + px * im_.tw, im_.x0);
    ty0 = std::max(im_.ty0 + py * im_.th, im_.y0);
    tx1 = std::min(im_.tx0 + (px + 1) * im_.tw, im_.x1);
    ty1 = std::min(im_.ty0 + (py + 1) * im_.th, im_.y1);
    tcs.resize(im_.comps.size());
    for (size_t c = 0; c < im_.comps.size(); ++c) {
      const Comp &cp = im_.comps[c];
      const Coding &cd = p.coding[c];
      const Quant &q = p.quant[c];
      TileComp &tc = tcs[c];
      tc.x0 = ceildiv(tx0, cp.dx);
      tc.y0 = ceildiv(ty0, cp.dy);
      tc.x1 = ceildiv(tx1, cp.dx);
      tc.y1 = ceildiv(ty1, cp.dy);
      const int nl = cd.levels;
      tc.res.resize(size_t(nl + 1));
      for (int r = 0; r <= nl; ++r) {
        Resolution &res = tc.res[size_t(r)];
        const int level = nl - r;
        res.x0 = ceildivpow2(tc.x0, level);
        res.y0 = ceildivpow2(tc.y0, level);
        res.x1 = ceildivpow2(tc.x1, level);
        res.y1 = ceildivpow2(tc.y1, level);
        res.ppx = cd.ppx[r];
        res.ppy = cd.ppy[r];
        const int64_t prx0 = (res.x0 >> res.ppx) << res.ppx;
        const int64_t pry0 = (res.y0 >> res.ppy) << res.ppy;
        const int64_t prx1 = ceildivpow2(res.x1, res.ppx) << res.ppx;
        const int64_t pry1 = ceildivpow2(res.y1, res.ppy) << res.ppy;
        res.pw = res.x0 == res.x1 ? 0 : int((prx1 - prx0) >> res.ppx);
        res.ph = res.y0 == res.y1 ? 0 : int((pry1 - pry0) >> res.ppy);
        if (int64_t(res.pw) * res.ph > (1 << 24)) fail("too many precincts");
        const int nbands = r == 0 ? 1 : 3;
        const int cbgw = r == 0 ? res.ppx : res.ppx - 1;
        const int cbgh = r == 0 ? res.ppy : res.ppy - 1;
        const int64_t cbgx0 = r == 0 ? prx0 : ceildivpow2(prx0, 1);
        const int64_t cbgy0 = r == 0 ? pry0 : ceildivpow2(pry0, 1);
        const int xcb = std::min(cd.xcb, cbgw), ycb = std::min(cd.ycb, cbgh);
        res.bands.resize(size_t(nbands));
        for (int b = 0; b < nbands; ++b) {
          Band &band = res.bands[size_t(b)];
          band.orient = r == 0 ? 0 : b + 1;
          if (r == 0) {
            band.x0 = res.x0;
            band.y0 = res.y0;
            band.x1 = res.x1;
            band.y1 = res.y1;
          } else {
            const int nb = nl - r + 1;
            const int64_t xo = band.orient & 1, yo = band.orient >> 1;
            band.x0 = ceildivpow2(tc.x0 - (xo << (nb - 1)), nb);
            band.y0 = ceildivpow2(tc.y0 - (yo << (nb - 1)), nb);
            band.x1 = ceildivpow2(tc.x1 - (xo << (nb - 1)), nb);
            band.y1 = ceildivpow2(tc.y1 - (yo << (nb - 1)), nb);
          }
          const int index = r == 0 ? 0 : 3 * (r - 1) + b + 1;
          band.numbps = q.step(index).first + q.guard - 1;
          band.stepsize = band_stepsize(q, index, cp.prec, cd.reversible == 1,
                                        band.orient);
          band.precincts.resize(size_t(res.pw) * res.ph);
          for (int k = 0; k < res.pw * res.ph; ++k) {
            Precinct &pr = band.precincts[size_t(k)];
            const int64_t gx0 = cbgx0 + int64_t(k % res.pw) * (int64_t(1) << cbgw);
            const int64_t gy0 = cbgy0 + int64_t(k / res.pw) * (int64_t(1) << cbgh);
            const int64_t x0 = std::max(gx0, band.x0), y0 = std::max(gy0, band.y0);
            const int64_t x1 = std::min(gx0 + (int64_t(1) << cbgw), band.x1);
            const int64_t y1 = std::min(gy0 + (int64_t(1) << cbgh), band.y1);
            if (band.empty() || x0 >= x1 || y0 >= y1) continue;
            const int64_t bx0 = (x0 >> xcb) << xcb, by0 = (y0 >> ycb) << ycb;
            const int64_t bx1 = ceildivpow2(x1, xcb) << xcb;
            const int64_t by1 = ceildivpow2(y1, ycb) << ycb;
            pr.cw = int((bx1 - bx0) >> xcb);
            pr.ch = int((by1 - by0) >> ycb);
            pr.incl = TagTree(pr.cw, pr.ch);
            pr.zero = TagTree(pr.cw, pr.ch);
            pr.blocks.resize(size_t(pr.cw) * pr.ch);
            for (int j = 0; j < pr.cw * pr.ch; ++j) {
              Block &bl = pr.blocks[size_t(j)];
              const int64_t cx0 = bx0 + int64_t(j % pr.cw) * (int64_t(1) << xcb);
              const int64_t cy0 = by0 + int64_t(j / pr.cw) * (int64_t(1) << ycb);
              bl.x0 = std::max(cx0, x0);
              bl.y0 = std::max(cy0, y0);
              bl.x1 = std::min(cx0 + (int64_t(1) << xcb), x1);
              bl.y1 = std::min(cy0 + (int64_t(1) << ycb), y1);
            }
          }
        }
      }
    }
  }

  // one packet's header and body from `pos`; returns the position after
  size_t packet(const Params &p, TileComp &tc, int r, int k, int layer,
                const std::vector<u8> &data, size_t pos) {
    Resolution &res = tc.res[size_t(r)];
    if (p.scod & 2) {  // SOP
      if (pos + 6 <= data.size() && data[pos] == 0xFF && data[pos + 1] == 0x91) pos += 6;
    }
    BitReader b{data.data() + pos, data.data() + data.size()};
    std::vector<std::pair<Block *, uint32_t>> lengths;
    if (b.bit()) {
      for (Band &band : res.bands) {
        if (band.empty()) continue;
        Precinct &pr = band.precincts[size_t(k)];
        for (int j = 0; j < pr.cw * pr.ch; ++j) {
          Block &bl = pr.blocks[size_t(j)];
          int included;
          if (!bl.included) {
            included = tag_decode(b, pr.incl, j, layer + 1);
          } else {
            included = b.bit();
          }
          if (!included) continue;
          if (!bl.included) {
            int i = 0;
            while (!tag_decode(b, pr.zero, j, i)) ++i;
            bl.numbps = band.numbps + 1 - i;
            bl.included = true;
          }
          int passes;
          if (!b.bit()) {
            passes = 1;
          } else if (!b.bit()) {
            passes = 2;
          } else {
            int n = int(b.bits(2));
            if (n != 3) {
              passes = 3 + n;
            } else {
              n = int(b.bits(5));
              passes = n != 31 ? 6 + n : 37 + int(b.bits(7));
            }
          }
          while (b.bit()) ++bl.lblock;
          const int nbits = bl.lblock + floorlog2(uint32_t(passes));
          if (nbits > 32) fail("corrupt packet header");
          lengths.push_back({&bl, b.bits(nbits)});
          bl.passes += passes;
        }
      }
    }
    b.align();
    pos = size_t(b.p - data.data());
    if (p.scod & 4) {  // EPH
      if (pos + 2 <= data.size() && data[pos] == 0xFF && data[pos + 1] == 0x92) pos += 2;
    }
    for (auto &[bl, len] : lengths) {
      if (pos + len > data.size()) fail("truncated packet data");
      bl->data.insert(bl->data.end(), data.begin() + long(pos),
                      data.begin() + long(pos + len));
      pos += len;
    }
    return pos;
  }

  // openjpeg's pi.c orders for one tile, each packet once
  void packets(int t, std::vector<TileComp> &tcs, int64_t tx0, int64_t ty0,
               int64_t tx1, int64_t ty1) {
    const Params &p = tiles_[size_t(t)].params;
    const std::vector<u8> &data = tiles_[size_t(t)].bytes;
    const int nc = int(im_.comps.size());
    int maxres = 0;
    for (auto &tc : tcs) maxres = std::max(maxres, int(tc.res.size()));
    size_t pos = 0;
    auto emit = [&](int l, int r, int c, int k) {
      pos = packet(p, tcs[size_t(c)], r, k, l, data, pos);
    };
    const int order = p.progression;
    if (order == 0 || order == 1) {  // LRCP, RLCP
      for (int a = 0; a < (order == 0 ? p.layers : maxres); ++a)
        for (int bb = 0; bb < (order == 0 ? maxres : p.layers); ++bb) {
          const int l = order == 0 ? a : bb, r = order == 0 ? bb : a;
          for (int c = 0; c < nc; ++c) {
            if (r >= int(tcs[size_t(c)].res.size())) continue;
            const Resolution &res = tcs[size_t(c)].res[size_t(r)];
            for (int k = 0; k < res.pw * res.ph; ++k) emit(l, r, c, k);
          }
        }
      return;
    }
    // position-driven: RPCL (2), PCRL (3), CPRL (4)
    auto step = [&](int c0, int c1, bool x_axis) {
      int64_t best = 0;
      for (int c = c0; c < c1; ++c) {
        const TileComp &tc = tcs[size_t(c)];
        const int nres = int(tc.res.size());
        for (int r = 0; r < nres; ++r) {
          const int e = (x_axis ? tc.res[size_t(r)].ppx : tc.res[size_t(r)].ppy) + nres - 1 - r;
          if (e >= 31) continue;
          const int64_t d = int64_t(x_axis ? im_.comps[size_t(c)].dx : im_.comps[size_t(c)].dy) << e;
          best = best ? std::min(best, d) : d;
        }
      }
      return best ? best : 1;
    };
    // the precinct at (x, y) of resolution r of component c, or -1
    auto precinct = [&](int c, int r, int64_t x, int64_t y) -> int {
      const TileComp &tc = tcs[size_t(c)];
      const Comp &cp = im_.comps[size_t(c)];
      if (r >= int(tc.res.size())) return -1;
      const Resolution &res = tc.res[size_t(r)];
      const int level = int(tc.res.size()) - 1 - r;
      const int64_t dxl = int64_t(cp.dx) << level, dyl = int64_t(cp.dy) << level;
      const int64_t trx0 = ceildiv(tx0, dxl), try0 = ceildiv(ty0, dyl);
      const int64_t trx1 = ceildiv(tx1, dxl), try1 = ceildiv(ty1, dyl);
      const int rpx = res.ppx + level, rpy = res.ppy + level;
      if (rpx >= 31 || rpy >= 31) return -1;
      if (!(y % (int64_t(cp.dy) << rpy) == 0 ||
            (y == ty0 && ((try0 << level) % (int64_t(1) << rpy)))))
        return -1;
      if (!(x % (int64_t(cp.dx) << rpx) == 0 ||
            (x == tx0 && ((trx0 << level) % (int64_t(1) << rpx)))))
        return -1;
      if (res.pw == 0 || res.ph == 0) return -1;
      if (trx0 == trx1 || try0 == try1) return -1;
      const int64_t prci = (ceildiv(x, dxl) >> res.ppx) - (trx0 >> res.ppx);
      const int64_t prcj = (ceildiv(y, dyl) >> res.ppy) - (try0 >> res.ppy);
      return int(prci + prcj * res.pw);
    };
    // each precinct's packets once, as openjpeg's include array
    std::vector<std::vector<std::vector<u8>>> seen;
    seen.resize(size_t(nc));
    auto visit = [&](int c, int r, int k) {
      auto &per_res = seen[size_t(c)];
      if (per_res.empty()) per_res.resize(tcs[size_t(c)].res.size());
      auto &v = per_res[size_t(r)];
      if (v.empty()) {
        const Resolution &res = tcs[size_t(c)].res[size_t(r)];
        v.assign(size_t(res.pw) * res.ph, 0);
      }
      if (v[size_t(k)]) return;
      v[size_t(k)] = 1;
      for (int l = 0; l < p.layers; ++l) emit(l, r, c, k);
    };
    if (order == 2) {  // RPCL
      const int64_t sx = step(0, nc, true), sy = step(0, nc, false);
      for (int r = 0; r < maxres; ++r)
        for (int64_t y = ty0; y < ty1; y += sy - (y % sy))
          for (int64_t x = tx0; x < tx1; x += sx - (x % sx))
            for (int c = 0; c < nc; ++c) {
              const int k = precinct(c, r, x, y);
              if (k >= 0) visit(c, r, k);
            }
    } else if (order == 3) {  // PCRL
      const int64_t sx = step(0, nc, true), sy = step(0, nc, false);
      for (int64_t y = ty0; y < ty1; y += sy - (y % sy))
        for (int64_t x = tx0; x < tx1; x += sx - (x % sx))
          for (int c = 0; c < nc; ++c)
            for (int r = 0; r < int(tcs[size_t(c)].res.size()); ++r) {
              const int k = precinct(c, r, x, y);
              if (k >= 0) visit(c, r, k);
            }
    } else {  // CPRL
      for (int c = 0; c < nc; ++c) {
        const int64_t sx = step(c, c + 1, true), sy = step(c, c + 1, false);
        for (int64_t y = ty0; y < ty1; y += sy - (y % sy))
          for (int64_t x = tx0; x < tx1; x += sx - (x % sx))
            for (int r = 0; r < int(tcs[size_t(c)].res.size()); ++r) {
              const int k = precinct(c, r, x, y);
              if (k >= 0) visit(c, r, k);
            }
      }
    }
  }

  void decode_tile(int t, int mode, int space, u8 *out) {
    std::vector<TileComp> tcs;
    int64_t tx0, ty0, tx1, ty1;
    build(t, tcs, tx0, ty0, tx1, ty1);
    packets(t, tcs, tx0, ty0, tx1, ty1);
    const Params &p = tiles_[size_t(t)].params;
    const size_t nc = im_.comps.size();
    std::vector<int32_t> coef;
    for (size_t c = 0; c < nc; ++c) {
      TileComp &tc = tcs[c];
      const Coding &cd = p.coding[c];
      const bool rev = cd.reversible == 1;
      const int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
      if (rev) {
        tc.ints.assign(size_t(w * h), 0);
      } else {
        tc.floats.assign(size_t(w * h), 0.0f);
      }
      for (size_t r = 0; r < tc.res.size(); ++r) {
        const Resolution &res = tc.res[r];
        for (const Band &band : res.bands) {
          if (band.empty()) continue;
          int64_t ox = 0, oy = 0;  // the band's place in the tile buffer
          if (band.orient & 1) ox = tc.res[r - 1].x1 - tc.res[r - 1].x0;
          if (band.orient & 2) oy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
          const float stepsize = 0.5f * band.stepsize;
          for (const Precinct &pr : band.precincts)
            for (const Block &bl : pr.blocks) {
              const int bw = int(bl.x1 - bl.x0), bh = int(bl.y1 - bl.y0);
              if (bw <= 0 || bh <= 0) continue;
              coef.assign(size_t(bw) * bh, 0);
              if (bl.passes > 0) {
                std::vector<u8> buf(bl.data);
                buf.push_back(0xFF);
                buf.push_back(0xFF);
                decode_block(buf.data(), bl.passes, bl.numbps, bw, bh,
                             band.orient, cd.style, coef.data());
              }
              for (int y = 0; y < bh; ++y)
                for (int x = 0; x < bw; ++x) {
                  const size_t at = size_t(bl.y0 - band.y0 + oy + y) * size_t(w) +
                                    size_t(bl.x0 - band.x0 + ox + x);
                  const int32_t v = coef[size_t(y) * bw + x];
                  if (rev) {
                    tc.ints[at] = v / 2;
                  } else {
                    tc.floats[at] = float(v) * stepsize;
                  }
                }
            }
        }
      }
      synthesise(tc, rev, size_t(w));
    }
    // multiple component transform, over the first three components
    if (p.mct == 1 && nc >= 3) {
      auto size = [&](int c) {
        return std::make_pair(tcs[size_t(c)].x1 - tcs[size_t(c)].x0,
                              tcs[size_t(c)].y1 - tcs[size_t(c)].y0);
      };
      if (size(1) != size(0) || size(2) != size(0))
        fail("a component transform over components of different sizes");
      const size_t n = size_t(size(0).first * size(0).second);
      if (p.coding[0].reversible == 1) {
        for (size_t i = 0; i < n; ++i) {
          const int32_t y = tcs[0].ints[i], u = tcs[1].ints[i], v = tcs[2].ints[i];
          const int32_t g = y - ((u + v) >> 2);
          tcs[0].ints[i] = v + g;
          tcs[1].ints[i] = g;
          tcs[2].ints[i] = u + g;
        }
      } else {
        for (size_t i = 0; i < n; ++i) {
          const float y = tcs[0].floats[i], u = tcs[1].floats[i], v = tcs[2].floats[i];
          const float r = y + (v * 1.402f);
          const float g = y - (u * 0.34413f) - (v * 0.71414f);
          const float b = y + (u * 1.772f);
          tcs[0].floats[i] = r;
          tcs[1].floats[i] = g;
          tcs[2].floats[i] = b;
        }
      }
    }
    // DC level shift and clamping, into the samples
    for (size_t c = 0; c < nc; ++c) {
      TileComp &tc = tcs[c];
      const Comp &cp = im_.comps[c];
      const int64_t lo = cp.sgnd ? -(int64_t(1) << (cp.prec - 1)) : 0;
      const int64_t hi = cp.sgnd ? (int64_t(1) << (cp.prec - 1)) - 1 : (int64_t(1) << cp.prec) - 1;
      const int64_t shift = cp.sgnd ? 0 : int64_t(1) << (cp.prec - 1);
      const size_t n = size_t((tc.x1 - tc.x0) * (tc.y1 - tc.y0));
      if (p.coding[c].reversible == 1) {
        for (size_t i = 0; i < n; ++i)
          tc.ints[i] = int32_t(std::clamp(int64_t(tc.ints[i]) + shift, lo, hi));
      } else {
        tc.ints.assign(n, 0);
        for (size_t i = 0; i < n; ++i) {
          const float v = tc.floats[i];
          int64_t x;
          if (v > float(INT32_MAX)) {
            x = hi;
          } else if (v < float(INT32_MIN)) {
            x = lo;
          } else {
            x = std::clamp(int64_t(std::lrintf(v)) + shift, lo, hi);
          }
          tc.ints[i] = int32_t(x);
        }
      }
    }
    unpack(tcs, tx0, ty0, tx1, ty1, mode, space, out);
  }

  // inverse wavelet transform of a tile-component, resolution by
  // resolution: rows first, then columns, as openjpeg's
  // opj_dwt_decode_tile(_97)
  void synthesise(TileComp &tc, bool rev, size_t stride) {
    for (size_t r = 1; r < tc.res.size(); ++r) {
      const Resolution &lo = tc.res[r - 1], &cur = tc.res[r];
      const int sw = int(lo.x1 - lo.x0), sh = int(lo.y1 - lo.y0);
      const int rw = int(cur.x1 - cur.x0), rh = int(cur.y1 - cur.y0);
      const int cx = int(cur.x0 & 1), cy = int(cur.y0 & 1);
      if (rev) {
        std::vector<int32_t> line(size_t(std::max(rw, rh)) + 2), col(line.size());
        for (int y = 0; y < rh; ++y) {
          int32_t *row = tc.ints.data() + size_t(y) * stride;
          idwt53(row, row + sw, sw, rw - sw, cx, line.data());
          std::copy(line.begin(), line.begin() + rw, row);
        }
        for (int x = 0; x < rw; ++x) {
          for (int y = 0; y < rh; ++y) col[size_t(y)] = tc.ints[size_t(y) * stride + x];
          idwt53(col.data(), col.data() + sh, sh, rh - sh, cy, line.data());
          for (int y = 0; y < rh; ++y) tc.ints[size_t(y) * stride + x] = line[size_t(y)];
        }
      } else {
        std::vector<float> w(size_t(std::max(rw, rh)) + 4);
        for (int y = 0; y < rh; ++y) {
          float *row = tc.floats.data() + size_t(y) * stride;
          std::fill(w.begin(), w.end(), 0.0f);
          for (int i = 0; i < sw; ++i) w[size_t(cx + 2 * i)] = row[i];
          for (int i = 0; i < rw - sw; ++i) w[size_t(1 - cx + 2 * i)] = row[sw + i];
          idwt97(w.data(), sw, rw - sw, cx);
          std::copy(w.begin(), w.begin() + rw, row);
        }
        for (int x = 0; x < rw; ++x) {
          std::fill(w.begin(), w.end(), 0.0f);
          for (int i = 0; i < sh; ++i) w[size_t(cy + 2 * i)] = tc.floats[size_t(i) * stride + x];
          for (int i = 0; i < rh - sh; ++i)
            w[size_t(1 - cy + 2 * i)] = tc.floats[size_t(sh + i) * stride + x];
          idwt97(w.data(), sh, rh - sh, cy);
          for (int y = 0; y < rh; ++y) tc.floats[size_t(y) * stride + x] = w[size_t(y)];
        }
      }
    }
  }

  // Pillow's Jpeg2KDecode.c for one tile: openjpeg's tile buffer (each
  // component's samples in 1, 2 or 4 bytes, one after the other), read by
  // the unpacker for Pillow's mode; then convert('RGB')
  void unpack(const std::vector<TileComp> &tcs, int64_t tx0, int64_t ty0,
              int64_t tx1, int64_t ty1, int mode, int space, u8 *out) {
    const size_t nc = im_.comps.size();
    std::vector<int> csiz(nc), shift(nc), offset(nc);
    std::vector<u8> buf;
    for (size_t c = 0; c < nc; ++c) {
      const Comp &cp = im_.comps[c];
      csiz[c] = (cp.prec + 7) >> 3;
      if (csiz[c] == 3) csiz[c] = 4;
      const TileComp &tc = tcs[c];
      const size_t n = size_t((tc.x1 - tc.x0) * (tc.y1 - tc.y0));
      for (size_t i = 0; i < n; ++i) {
        const uint32_t v = uint32_t(tc.ints[i]);
        for (int k = 0; k < csiz[c]; ++k) buf.push_back(u8(v >> (8 * k)));
      }
    }
    buf.resize(buf.size() + 16, 0);
    const int64_t w = tx1 - tx0, h = ty1 - ty0;
    const int64_t width = im_.x1 - im_.x0;
    const int64_t xo = tx0 - im_.x0, yo = ty0 - im_.y0;
    bool subsampled = false;
    for (const Comp &cp : im_.comps) subsampled |= cp.dx != 1 || cp.dy != 1;
    int want;  // components of the mode's unpacker
    if (space == 0) {  // Pillow's guess: subsampled chroma is sYCC
      space = nc <= 2 ? 2 : 1;
      if (nc == 3 && (im_.comps[1].dx != 1 || im_.comps[1].dy != 1 ||
                      im_.comps[2].dx != 1 || im_.comps[2].dy != 1))
        space = 3;
    }
    if (mode == 0 || mode == 1) {
      want = 1;
      if (space != 2) fail("a one-component image that is not greyscale");
    } else if (mode == 2) {
      want = 2;
      if (space != 2) fail("a two-component image that is not greyscale");
    } else if (mode == 3) {
      want = 3;
      if (space != 1 && space != 3)
        fail("colour space " + std::to_string(space) + " is not supported");
    } else {
      want = 4;
      if (mode == 5 ? space != 5 : (space != 1 && space != 3))
        fail("colour space " + std::to_string(space) + " is not supported");
    }
    if (int(nc) != want) fail("a component count that does not match the file's header");
    if (subsampled && want < 3) fail("subsampled greyscale components (Pillow reads none)");
    std::vector<size_t> start(nc);
    size_t at = 0;
    for (size_t c = 0; c < nc; ++c) {
      const Comp &cp = im_.comps[c];
      start[c] = at;
      at += size_t(csiz[c]) * size_t(w / cp.dx) * size_t(h / cp.dy);
      const int bits = (mode == 1 ? 16 : 8);
      shift[c] = bits - cp.prec;
      offset[c] = cp.sgnd ? 1 << (cp.prec - 1) : 0;
      if (shift[c] < 0) offset[c] += 1 << (-shift[c] - 1);
    }
    auto word = [&](size_t c, int64_t x, int64_t y) -> uint32_t {
      const Comp &cp = im_.comps[c];
      const size_t i = start[c] + size_t(csiz[c]) * (size_t(y / cp.dy) * size_t(w / cp.dx) +
                                                     size_t(x / cp.dx));
      if (i + size_t(csiz[c]) > buf.size()) return 0;
      uint32_t v = 0;
      for (int k = 0; k < csiz[c]; ++k) v |= uint32_t(buf[i + size_t(k)]) << (8 * k);
      return v;
    };
    auto value = [&](size_t c, int64_t x, int64_t y) -> uint32_t {
      const uint32_t v = uint32_t(offset[c]) + word(c, x, y);
      return shift[c] < 0 ? v >> -shift[c] : v << shift[c];
    };
    auto muldiv255 = [](int a, int b) {
      const int t = a * b + 128;
      return ((t >> 8) + t) >> 8;
    };
    for (int64_t y = 0; y < h; ++y)
      for (int64_t x = 0; x < w; ++x) {
        u8 *px = out + (size_t(yo + y) * size_t(width) + size_t(xo + x)) * 3;
        if (mode == 1) {
          const uint32_t v = value(0, x, y) & 0xFFFF;
          px[0] = px[1] = px[2] = u8(std::min<uint32_t>(v, 255));
        } else if (mode == 0 || mode == 2) {
          px[0] = px[1] = px[2] = u8(value(0, x, y));
        } else if (mode == 5) {
          const int nk = 255 - int(u8(value(3, x, y)));
          for (int c = 0; c < 3; ++c)
            px[c] = u8(std::clamp(nk - muldiv255(int(u8(value(size_t(c), x, y))), nk), 0, 255));
        } else {
          for (int c = 0; c < 3; ++c) px[c] = u8(value(size_t(c), x, y));
          if (space == 3) {  // Pillow's ImagingConvertYCbCr2RGB
            const int luma = px[0], cb = px[1], cr = px[2];
            px[0] = u8(std::clamp(luma + (kYcc.r_cr[cr] >> 6), 0, 255));
            px[1] = u8(std::clamp(luma + ((kYcc.g_cb[cb] + kYcc.g_cr[cr]) >> 6), 0, 255));
            px[2] = u8(std::clamp(luma + (kYcc.b_cb[cb] >> 6), 0, 255));
          }
        }
      }
  }
};

void message(char *err, long cap, const char *what) {
  if (cap <= 0) return;
  std::strncpy(err, what, size_t(cap - 1));
  err[cap - 1] = 0;
}

}  // namespace

extern "C" {

// the codestream's size (height and width of Pillow's image) and its
// components, and the first component's precision; 0, or -1 with `err`
int j2k_info(const u8 *data, long size, long *dims, char *err, long errcap) {
  try {
    Decoder d(data, size_t(size));
    d.header();
    const Image &im = d.image();
    dims[0] = long(im.y1 - im.y0);
    dims[1] = long(im.x1 - im.x0);
    dims[2] = long(im.comps.size());
    dims[3] = im.comps[0].prec;
    return 0;
  } catch (const std::exception &e) {
    message(err, errcap, e.what());
    return -1;
  }
}

// decode into `out`, (height, width, 3) uint8 RGB, for Pillow's `mode`
// and openjpeg's colour `space`; 0, or -1 with `err`
int j2k_decode(const u8 *data, long size, int mode, int space, u8 *out,
               char *err, long errcap) {
  try {
    Decoder d(data, size_t(size));
    d.header();
    d.decode(mode, space, out);
    return 0;
  } catch (const std::exception &e) {
    message(err, errcap, e.what());
    return -1;
  }
}

}  // extern "C"

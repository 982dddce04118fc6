// CCITT fax decoder for TIFF image data, for hosts without PIL.
//
// TIFF's compressions 2 (Modified Huffman: one-dimensional rows, each
// starting on a byte boundary, no end-of-line codes), 3 (ITU-T T.4: rows
// after end-of-line codes, one- or two-dimensional by the tag bit after
// each end-of-line code when T4Options bit 0 is set, fill bits before the
// codes when bit 2 is) and 4 (ITU-T T.6: two-dimensional rows, the first
// against an all-white reference row, no end-of-line codes), as libtiff's
// Fax3Decode1D, Fax3Decode2D and Fax4Decode read them.  The codes are
// those of T.4's tables 2 and 3 (terminating and make-up codes of white
// and black runs, and the extended make-up codes shared by both) and
// table 4 (pass, horizontal and vertical modes).  Uncompressed mode (the
// extension codes) raises.
//
// Plain C interface (ctypes): fax_decode writes one byte per pixel, 0 for
// white and 1 for black, and returns the rows decoded, or -1 with a
// message.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

using u8 = uint8_t;

// T.4 table 2: terminating codes, run lengths 0..63
const char *const kWhiteTerm[64] = {
    "00110101", "000111",   "0111",     "1000",     "1011",     "1100",
    "1110",     "1111",     "10011",    "10100",    "00111",    "01000",
    "001000",   "000011",   "110100",   "110101",   "101010",   "101011",
    "0100111",  "0001100",  "0001000",  "0010111",  "0000011",  "0000100",
    "0101000",  "0101011",  "0010011",  "0100100",  "0011000",  "00000010",
    "00000011", "00011010", "00011011", "00010010", "00010011", "00010100",
    "00010101", "00010110", "00010111", "00101000", "00101001", "00101010",
    "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100",
    "00100101", "01011000", "01011001", "01011010", "01011011", "01001010",
    "01001011", "00110010", "00110011", "00110100"};
const char *const kBlackTerm[64] = {
    "0000110111",   "010",          "11",           "10",
    "011",          "0011",         "0010",         "00011",
    "000101",       "000100",       "0000100",      "0000101",
    "0000111",      "00000100",     "00000111",     "000011000",
    "0000010111",   "0000011000",   "0000001000",   "00001100111",
    "00001101000",  "00001101100",  "00000110111",  "00000101000",
    "00000010111",  "00000011000",  "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001",
    "000001101010", "000001101011", "000011010010", "000011010011",
    "000011010100", "000011010101", "000011010110", "000011010111",
    "000001101100", "000001101101", "000011011010", "000011011011",
    "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011",
    "000000100100", "000000110111", "000000111000", "000000100111",
    "000000101000", "000001011000", "000001011001", "000000101011",
    "000000101100", "000001011010", "000001100110", "000001100111"};
// T.4 table 3: make-up codes, run lengths 64..1728 by 64
const char *const kWhiteMakeup[27] = {
    "11011",     "10010",     "010111",    "0110111",   "00110110",
    "00110111",  "01100100",  "01100101",  "01101000",  "01100111",
    "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001",
    "011011010", "011011011", "010011000", "010011001", "010011010",
    "011000",    "010011011"};
const char *const kBlackMakeup[27] = {
    "0000001111",    "000011001000",  "000011001001",  "000001011011",
    "000000110011",  "000000110100",  "000000110101",  "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
// extended make-up codes, run lengths 1792..2560 by 64, both colours
const char *const kExtMakeup[13] = {
    "00000001000",  "00000001100",  "00000001101",  "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

constexpr int kMaxBits = 13;

// code length and bits -> run length (-1: no code)
struct RunTable {
  std::vector<int16_t> v;
  RunTable(const char *const *term, const char *const *makeup) :
      v(size_t(kMaxBits + 1) << kMaxBits, -1) {
    for (int i = 0; i < 64; ++i) add(term[i], i);
    for (int i = 0; i < 27; ++i) add(makeup[i], 64 * (i + 1));
    for (int i = 0; i < 13; ++i) add(kExtMakeup[i], 1792 + 64 * i);
  }
  void add(const char *bits, int value) {
    int len = int(std::strlen(bits)), code = 0;
    for (int i = 0; i < len; ++i) code = code << 1 | (bits[i] - '0');
    v[size_t(len) << kMaxBits | size_t(code)] = int16_t(value);
  }
  int at(int len, int code) const { return v[size_t(len) << kMaxBits | size_t(code)]; }
};

const RunTable &white() {
  static const RunTable t(kWhiteTerm, kWhiteMakeup);
  return t;
}
const RunTable &black() {
  static const RunTable t(kBlackTerm, kBlackMakeup);
  return t;
}

struct FaxError : std::exception {
  std::string what_;
  explicit FaxError(std::string w) : what_(std::move(w)) {}
  const char *what() const noexcept override { return what_.c_str(); }
};

struct Bits {
  const u8 *d;
  long n, pos = 0;  // pos in bits
  int bit() {
    if (pos >= n * 8) throw FaxError("CCITT: the data ends inside a row");
    int b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return b;
  }
  int peek(int k) const {  // the next k bits, zeros past the end
    int v = 0;
    for (int i = 0; i < k; ++i) {
      long p = pos + i;
      v = v << 1 | (p < n * 8 ? (d[p >> 3] >> (7 - (p & 7))) & 1 : 0);
    }
    return v;
  }
  bool at_end() const { return pos >= n * 8; }
  void align() { pos = (pos + 7) & ~7L; }
  // skip an end-of-line code (11 or more zeros and a one) if one is next;
  // true when one was skipped
  bool eol() {
    long p = pos;
    int zeros = 0;
    while (p < n * 8 && !((d[p >> 3] >> (7 - (p & 7))) & 1)) {
      ++zeros;
      ++p;
    }
    if (zeros < 11 || p >= n * 8) return false;
    pos = p + 1;
    return true;
  }
};

// one run: make-up codes then a terminating code
int run(Bits &b, const RunTable &t) {
  int total = 0;
  for (;;) {
    int code = 0, len = 0, value = -1;
    while (len < kMaxBits) {
      code = code << 1 | b.bit();
      ++len;
      value = t.at(len, code);
      if (value >= 0) break;
    }
    if (value < 0) {
      if (code == 0 || (len == kMaxBits && (code >> 1) == 0))
        throw FaxError("CCITT: an end-of-line code inside a row");
      throw FaxError("CCITT: a run-length code that is not defined");
    }
    total += value;
    if (value < 64) return total;
  }
}

// 1D row: alternating runs from white; changes (run ends) into `changes`
void row1d(Bits &b, long width, std::vector<long> &changes) {
  changes.clear();
  long a = 0;
  int colour = 0;
  while (a < width) {
    a += run(b, colour ? black() : white());
    if (a > width) throw FaxError("CCITT: a row longer than the image width");
    changes.push_back(a);
    colour ^= 1;
  }
}

// 2D row against `ref` (changing elements, ending in two `width`s)
void row2d(Bits &b, long width, const std::vector<long> &ref,
           std::vector<long> &changes) {
  changes.clear();
  long a0 = -1;
  int colour = 0;
  size_t i = 0;  // search start in ref
  while (a0 < width) {
    // b1: first change on ref right of a0 with the colour opposite a0's
    // (white -> black changes sit at even indices)
    while (i > 0 && ref[i - 1] > a0) --i;
    while (i < ref.size() && (ref[i] <= a0 || int(i & 1) != colour)) ++i;
    long b1 = i < ref.size() ? ref[i] : width;
    long b2 = i + 1 < ref.size() ? ref[i + 1] : width;
    int mode;
    if (b.bit()) {
      mode = 0;  // V0
    } else if (b.bit()) {
      mode = b.bit() ? 1 : -1;  // VR1 011, VL1 010
    } else if (b.bit()) {
      mode = 10;  // horizontal 001
    } else if (b.bit()) {
      mode = 11;  // pass 0001
    } else if (b.bit()) {
      mode = b.bit() ? 2 : -2;  // VR2 000011, VL2 000010
    } else if (b.bit()) {
      mode = b.bit() ? 3 : -3;  // VR3 0000011, VL3 0000010
    } else if (b.bit()) {
      throw FaxError("CCITT: uncompressed mode (an extension code) is not supported");
    } else {
      throw FaxError("CCITT: an end-of-line code inside a row");
    }
    if (mode == 11) {
      a0 = b2;
    } else if (mode == 10) {
      long start = a0 < 0 ? 0 : a0;
      long a1 = start + run(b, colour ? black() : white());
      long a2 = a1 + run(b, colour ? white() : black());
      if (a2 > width) throw FaxError("CCITT: a row longer than the image width");
      changes.push_back(a1);
      changes.push_back(a2);
      a0 = a2;
    } else {
      long a1 = b1 + mode;
      if (a1 < 0 || a1 > width) throw FaxError("CCITT: a vertical code outside the row");
      changes.push_back(a1);
      a0 = a1;
      colour ^= 1;
    }
  }
}

void message(char *err, long cap, const std::string &what) {
  if (cap <= 0) return;
  std::strncpy(err, what.c_str(), size_t(cap) - 1);
  err[cap - 1] = '\0';
}

}  // namespace

extern "C" {

// `compression` 2, 3 or 4 (TIFF's numbers), `options` T4Options for 3;
// `out` holds rows * width bytes
long fax_decode(const u8 *in, long n, int compression, int options,
                long width, long rows, u8 *out, char *err, long errcap) {
  try {
    if (compression == 3 && (options & 2))
      throw FaxError("CCITT Group 3 fax with uncompressed mode is not supported");
    Bits b{in, n};
    std::vector<long> ref{width, width}, cur;
    std::memset(out, 0, size_t(rows) * size_t(width));
    long y = 0;
    for (; y < rows; ++y) {
      if (compression == 2) {
        b.align();
        if (b.at_end()) break;
        row1d(b, width, cur);
      } else if (compression == 3) {
        b.eol();
        if (b.at_end()) break;
        bool two_d = (options & 1) && !b.bit();
        if (two_d) {
          row2d(b, width, ref, cur);
        } else {
          row1d(b, width, cur);
        }
      } else {
        if (b.peek(24) == 0x001001) break;  // EOFB
        if (b.at_end()) break;
        row2d(b, width, ref, cur);
      }
      u8 *line = out + size_t(y) * size_t(width);
      long start = 0;
      int colour = 0;
      for (long c : cur) {
        long end = c < width ? c : width;
        if (colour)
          for (long x = start; x < end; ++x) line[x] = 1;
        start = end > start ? end : start;
        colour ^= 1;
      }
      cur.push_back(width);
      cur.push_back(width);
      ref.swap(cur);
    }
    return y;
  } catch (const std::exception &e) {
    message(err, errcap, e.what());
    return -1;
  }
}

}  // extern "C"

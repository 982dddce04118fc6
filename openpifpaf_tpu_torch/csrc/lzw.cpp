// LZW decoder for GIF and TIFF image data, for hosts without PIL.
//
// GIF (GIF89a specification, appendix F): codes read least significant bit
// first, starting one bit wider than the minimum code size, widening when
// the next free code reaches the width's limit, up to 12 bits; a full table
// stops growing until the next clear code.
//
// TIFF (TIFF 6.0 section 13, as libtiff's LZWDecode): 8-bit roots, codes
// read most significant bit first from 9 to 12 bits, widening one code
// early (when the next free code is the width's limit less one).
//
// Both stop at the end-of-information code, at the end of the data, or
// when the output is full; a code that is not yet defined is an error.
//
// Plain C interface (ctypes): lzw_decode returns the bytes written, or -1
// with a message.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

using u8 = uint8_t;

void message(char *err, long cap, const std::string &what) {
  if (cap <= 0) return;
  std::strncpy(err, what.c_str(), size_t(cap) - 1);
  err[cap - 1] = '\0';
}

}  // namespace

extern "C" {

// `min_code_size` 1..8 for GIF (its root width), 0 for TIFF
long lzw_decode(const u8 *in, long n, int min_code_size, u8 *out, long cap,
                char *err, long errcap) {
  const bool gif = min_code_size > 0;
  const int root_bits = gif ? min_code_size : 8;
  if (gif && min_code_size > 11) {
    message(err, errcap, "LZW: minimum code size " +
                             std::to_string(min_code_size) + " is out of range");
    return -1;
  }
  const int clear = 1 << root_bits, eoi = clear + 1;
  // each code: its prefix code and last byte; lengths for copying out
  std::vector<int> prefix(4096), length(4096);
  std::vector<u8> suffix(4096), first(4096);
  for (int c = 0; c < clear; ++c) {
    prefix[c] = -1;
    suffix[c] = first[c] = u8(c);
    length[c] = 1;
  }
  int width = root_bits + 1, next = clear + 2, prev = -1;
  long pos = 0;  // output
  uint64_t acc = 0;
  int nbits = 0;
  long at = 0;  // input
  for (;;) {
    while (nbits < width && at < n) {
      if (gif) {
        acc |= uint64_t(in[at++]) << nbits;
      } else {
        acc = (acc << 8) | in[at++];
      }
      nbits += 8;
    }
    if (nbits < width) break;  // the data ended
    int code;
    if (gif) {
      code = int(acc & ((1u << width) - 1));
      acc >>= width;
    } else {
      code = int((acc >> (nbits - width)) & ((1u << width) - 1));
    }
    nbits -= width;
    if (code == clear) {
      width = root_bits + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    if (code > next || (code == next && prev < 0) || next > 4096) {
      message(err, errcap, "LZW: a code that is not defined");
      return -1;
    }
    if (prev >= 0 && next < 4096) {
      // the new entry: prev's string and the first byte of this code's
      prefix[next] = prev;
      suffix[next] = code == next ? first[prev] : first[code];
      first[next] = first[prev];
      length[next] = length[prev] + 1;
      ++next;
    }
    // copy out the code's string, last byte first
    const int len = length[code];
    long end = pos + len;
    int c = code;
    for (long i = end - 1; i >= pos; --i) {
      if (i < cap) out[i] = suffix[c];
      c = prefix[c];
    }
    pos = end;
    if (pos >= cap) return cap;
    prev = code;
    const int limit = gif ? (1 << width) : (1 << width) - 1;
    if (next >= limit && width < 12) ++width;
  }
  return pos;
}

}  // extern "C"

// WebP decoder without libwebp, for hosts without PIL.
//
// It gives what Pillow 12 gives for Image.open(path).convert('RGB'): Pillow
// decodes every WebP file through libwebp's WebPAnimDecoder into an RGBA
// canvas that starts zeroed, and convert('RGB') drops the alpha.  So:
//
// - the RIFF container: a simple file ("VP8 " or "VP8L"), or an extended
//   one ("VP8X") with ICCP, EXIF and XMP chunks skipped (convert('RGB')
//   applies no profile), ALPH dropped, and of an animation the first ANMF
//   frame at its offset on the zeroed canvas;
// - VP8L, lossless: prefix codes with the meta-code image, the colour
//   cache, LZ77 backward references with the distance map, and the four
//   transforms (predictor with its 14 modes, cross-colour, subtract-green,
//   colour indexing with pixel bundling); lossless output is exact by
//   definition;
// - VP8, lossy key frames, as libwebp 1.6.0 decodes them by default: the
//   boolean decoder, segments, the coefficient probabilities and their
//   updates, the intra predictors (16x16, 4x4 with libwebp's top-right
//   replication, chroma 8x8) and the 127/129 borders, token decoding,
//   dequantisation (dsp/dec.c's WHT and integer IDCT), the simple and
//   normal loop filters with per-segment and mode deltas and sharpness
//   (prediction reads the unfiltered pixels), then the "fancy" 2x chroma
//   upsampler of dsp/upsampling.c and the fixed-point YUV->RGB of
//   dsp/yuv.h.  No dithering (libwebp's default).
//
// Refused, by message: VP8 frames that are not key frames or not shown,
// a VP8L version other than 0, a still VP8X image whose bitstream does
// not fill its canvas, files without an image chunk, and truncated or
// corrupt data.
//
// Plain C interface (ctypes): webp_info, webp_decode; each returns -1 and
// writes a message on failure.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

using u8 = uint8_t;

struct WebpError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string &what) { throw WebpError(what); }

inline uint32_t le16(const u8 *p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const u8 *p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const u8 *p) { return le24(p) | (uint32_t(p[3]) << 24); }

// --------------------------------------------------------------- VP8 tables
// (RFC 6386: dequantisation, default and update coefficient probabilities,
// key-frame sub-block mode probabilities; VP8L: the distance map)

constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

constexpr uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

constexpr uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

constexpr uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

constexpr uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

constexpr u8 kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// coefficient index -> probability band; the 17th entry is read (never used)
// after the last coefficient
constexpr u8 kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr u8 kCat3[] = {173, 148, 140, 0};
constexpr u8 kCat4[] = {176, 155, 140, 135, 0};
constexpr u8 kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr u8 kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const u8 *kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// intra modes, in libwebp's order (the sub-block probabilities' indices)
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
  // 16x16 and chroma DC at the picture's edges
  B_DC_PRED_NOTOP, B_DC_PRED_NOLEFT, B_DC_PRED_NOTOPLEFT
};

// the sub-block mode tree: a negative entry is a leaf (minus the mode)
constexpr int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};

// ============================================================ VP8L (lossless)

constexpr int kCodeLengthCodes = 19;
constexpr u8 kCodeLengthOrder[kCodeLengthCodes] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
constexpr int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
enum { GREEN = 0, RED, BLUE, ALPHA, DIST };

// LSB-first bit reader; reading past the end gives zeros and marks `eos`
struct LBits {
  const u8 *data;
  size_t size, pos = 0;
  uint64_t val = 0;
  int nbits = 0;
  size_t overrun = 0;  // bytes "read" past the end

  LBits(const u8 *d, size_t n) : data(d), size(n) {}
  void fill() {
    while (nbits <= 56) {
      if (pos < size) {
        val |= uint64_t(data[pos++]) << nbits;
      } else {
        ++overrun;
      }
      nbits += 8;
    }
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    fill();
    const uint32_t v = uint32_t(val & ((uint64_t(1) << n) - 1));
    val >>= n;
    nbits -= n;
    return v;
  }
  uint32_t peek(int n) {
    fill();
    return uint32_t(val & ((uint64_t(1) << n) - 1));
  }
  void skip(int n) {
    val >>= n;
    nbits -= n;
  }
  // true once a bit past the end was consumed
  bool eos() const { return overrun * 8 > size_t(nbits); }
};

// a canonical prefix code read LSB first: a table for codes of up to
// kLutBits bits, the canonical walk (RFC 1951's) for longer ones
constexpr int kLutBits = 8;
struct Prefix {
  int single = -1;         // the one symbol of a zero-bit code
  uint16_t count[16] = {};  // codes per length
  std::vector<uint16_t> symbols;  // by (length, symbol)
  uint32_t lut[1 << kLutBits] = {};  // (length << 16) | symbol, 0: longer

  void build(const std::vector<int> &lengths) {
    int n = 0, last = 0;
    for (size_t s = 0; s < lengths.size(); ++s) {
      if (lengths[s] > 0) {
        ++n;
        last = int(s);
        ++count[lengths[s]];
      }
    }
    if (n == 0) fail("WebP lossless: a prefix code without symbols");
    if (n == 1) {  // libwebp decodes a lone symbol with no bits
      single = last;
      return;
    }
    // complete and not over-subscribed, as libwebp requires
    int64_t left = 1;
    for (int len = 1; len < 16; ++len) {
      left = 2 * left - count[len];
      if (left < 0) fail("WebP lossless: an over-subscribed prefix code");
    }
    if (left != 0) fail("WebP lossless: an incomplete prefix code");
    int offs[16] = {};
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    symbols.assign(n, 0);
    for (size_t s = 0; s < lengths.size(); ++s) {
      if (lengths[s] > 0) symbols[offs[lengths[s]]++] = uint16_t(s);
    }
    // the table: canonical codes, bit-reversed for LSB-first reading
    uint32_t code = 0;
    int index = 0;
    for (int len = 1; len < 16; ++len) {
      for (int i = 0; i < count[len]; ++i, ++index, ++code) {
        if (len > kLutBits) continue;
        uint32_t rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (uint32_t k = rev; k < (1u << kLutBits); k += 1u << len) {
          lut[k] = (uint32_t(len) << 16) | symbols[index];
        }
      }
      code <<= 1;
    }
  }

  int read(LBits &br) const {
    if (single >= 0) return single;
    const uint32_t e = lut[br.peek(kLutBits)];
    if (e) {
      br.skip(int(e >> 16));
      return int(e & 0xFFFF);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len < 16; ++len) {
      code |= int(br.read(1));
      const int c = count[len];
      if (code - c < first) return symbols[index + (code - first)];
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    fail("WebP lossless: a corrupt prefix code");
  }
};

struct Group {
  Prefix code[5];
};

// the code lengths of a normal prefix code (ReadHuffmanCodeLengths)
void read_code_lengths(LBits &br, const std::vector<int> &cl_lengths,
                       std::vector<int> &lengths) {
  Prefix cl;
  cl.build(cl_lengths);
  const int n = int(lengths.size());
  int max_symbol = n;
  if (br.read(1)) {
    const int length_nbits = 2 + 2 * int(br.read(3));
    max_symbol = 2 + int(br.read(length_nbits));
    if (max_symbol > n) fail("WebP lossless: too many code lengths");
  }
  int prev = 8, symbol = 0;
  while (symbol < n) {
    if (max_symbol-- == 0) break;
    const int len = cl.read(br);
    if (len < 16) {
      lengths[symbol++] = len;
      if (len != 0) prev = len;
    } else {
      static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
      const int slot = len - 16;
      const int repeat = int(br.read(extra[slot])) + offset[slot];
      if (symbol + repeat > n) fail("WebP lossless: a code length run too long");
      const int value = len == 16 ? prev : 0;
      for (int i = 0; i < repeat; ++i) lengths[symbol++] = value;
    }
  }
}

void read_prefix(LBits &br, int alphabet, Prefix &out) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple code: one or two symbols
    const int num = int(br.read(1)) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    const int s0 = int(br.read(first_bits));
    if (s0 < alphabet) lengths[s0] = 1;
    if (num == 2) {
      const int s1 = int(br.read(8));
      if (s1 < alphabet) lengths[s1] = 1;
    }
  } else {
    std::vector<int> cl(kCodeLengthCodes, 0);
    const int num = int(br.read(4)) + 4;
    for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = int(br.read(3));
    read_code_lengths(br, cl, lengths);
  }
  if (br.eos()) fail("WebP lossless: truncated data");
  out.build(lengths);
}

inline int sub_sample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

// prefix-coded lengths and distances: symbol -> value (GetCopyDistance)
inline int copy_value(int symbol, LBits &br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + int(br.read(extra)) + 1;
}

inline int plane_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dist_code = kCodeToPlane[code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xF);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

// one entropy-coded image (DecodeImageStream without the transforms):
// the colour cache, the prefix codes (with the meta-code image at the top
// level), the pixels
std::vector<uint32_t> decode_entropy_image(LBits &br, int xsize, int ysize,
                                           bool top);

std::vector<uint32_t> decode_pixels(LBits &br, int xsize, int ysize,
                                    int cache_bits,
                                    const std::vector<Group> &groups,
                                    const std::vector<uint32_t> &meta,
                                    int meta_bits) {
  const size_t total = size_t(xsize) * ysize;
  std::vector<uint32_t> out(total);
  std::vector<uint32_t> cache(cache_bits ? (size_t(1) << cache_bits) : 0);
  const int cache_shift = 32 - cache_bits;
  const int meta_xsize = meta_bits ? sub_sample(xsize, meta_bits) : 0;
  const int mask = meta_bits ? (1 << meta_bits) - 1 : -1;
  size_t pos = 0, cached = 0;
  int col = 0, row = 0;
  const Group *g = &groups[0];
  auto group_at = [&](int x, int y) -> const Group * {
    if (!meta_bits) return &groups[0];
    const uint32_t m = meta[size_t(y >> meta_bits) * meta_xsize + (x >> meta_bits)];
    return &groups[(m >> 8) & 0xFFFF];
  };
  auto cache_up_to = [&](size_t end) {
    if (!cache_bits) return;
    for (; cached < end; ++cached) {
      const uint32_t argb = out[cached];
      cache[(0x1E35A7BDu * argb) >> cache_shift] = argb;
    }
  };
  while (pos < total) {
    if ((col & mask) == 0) g = group_at(col, row);
    const int code = g->code[GREEN].read(br);
    if (code < 256) {
      const uint32_t red = uint32_t(g->code[RED].read(br));
      const uint32_t blue = uint32_t(g->code[BLUE].read(br));
      const uint32_t alpha = uint32_t(g->code[ALPHA].read(br));
      out[pos++] = (alpha << 24) | (red << 16) | (uint32_t(code) << 8) | blue;
      if (++col >= xsize) {
        col = 0;
        ++row;
      }
    } else if (code < 256 + 24) {
      const int length = copy_value(code - 256, br);
      const int dist_symbol = g->code[DIST].read(br);
      const int dist = plane_distance(xsize, copy_value(dist_symbol, br));
      if (size_t(dist) > pos || size_t(length) > total - pos) {
        fail("WebP lossless: a backward reference out of the image");
      }
      for (int i = 0; i < length; ++i, ++pos) out[pos] = out[pos - dist];
      col += length;
      while (col >= xsize) {
        col -= xsize;
        ++row;
      }
      if (pos < total && (col & mask)) g = group_at(col, row);
    } else {
      const int key = code - 280;
      if (!cache_bits || key >= (1 << cache_bits)) {
        fail("WebP lossless: a colour cache code out of range");
      }
      cache_up_to(pos);
      out[pos++] = cache[key];
      if (++col >= xsize) {
        col = 0;
        ++row;
      }
    }
    cache_up_to(pos);
    if (br.eos()) fail("WebP lossless: truncated data");
  }
  return out;
}

std::vector<uint32_t> decode_entropy_image(LBits &br, int xsize, int ysize,
                                           bool top) {
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = int(br.read(4));
    if (cache_bits < 1 || cache_bits > 11) {
      fail("WebP lossless: colour cache bits out of range");
    }
  }
  int meta_bits = 0, num_groups = 1;
  std::vector<uint32_t> meta;
  if (top && br.read(1)) {
    meta_bits = int(br.read(3)) + 2;
    meta = decode_entropy_image(br, sub_sample(xsize, meta_bits),
                                sub_sample(ysize, meta_bits), false);
    for (uint32_t m : meta) num_groups = std::max(num_groups, int((m >> 8) & 0xFFFF) + 1);
  }
  if (br.eos()) fail("WebP lossless: truncated data");
  std::vector<Group> groups(num_groups);
  for (auto &group : groups) {
    for (int j = 0; j < 5; ++j) {
      const int alphabet = kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
      read_prefix(br, alphabet, group.code[j]);
    }
  }
  return decode_pixels(br, xsize, ysize, cache_bits, groups, meta, meta_bits);
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xFF00FF00u) + (b & 0xFF00FF00u);
  const uint32_t rb = (a & 0x00FF00FFu) + (b & 0x00FF00FFu);
  return (ag & 0xFF00FF00u) | (rb & 0x00FF00FFu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b);
}
inline int clip255(int a) { return a < 0 ? 0 : (a > 255 ? 255 : a); }
inline uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (t >> s) & 0xFF, b = (l >> s) & 0xFF, c = (tl >> s) & 0xFF;
    pa_minus_pb += std::abs(b - c) - std::abs(a - c);
  }
  return pa_minus_pb <= 0 ? t : l;
}
inline uint32_t clamped_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    out |= uint32_t(clip255(int((a >> s) & 0xFF) + int((b >> s) & 0xFF) -
                            int((c >> s) & 0xFF))) << s;
  }
  return out;
}
inline uint32_t clamped_half(uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t ave = average2(a, b);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = int((ave >> s) & 0xFF), y = int((c >> s) & 0xFF);
    out |= uint32_t(clip255(x + (x - y) / 2)) << s;
  }
  return out;
}

// predictor `mode` from the left pixel and the row above (top[x] above)
inline uint32_t predict(int mode, uint32_t left, const uint32_t *top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], left, top[-1]);
    case 12: return clamped_full(left, top[0], top[-1]);
    case 13: return clamped_half(left, top[0], top[-1]);
    default: return 0xFF000000u;  // 0, and libwebp's 14 and 15
  }
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

// lossless bitstream (after the 5-byte header) -> ARGB pixels
std::vector<uint32_t> decode_vp8l(const u8 *data, size_t size, int *width,
                                  int *height) {
  if (size < 5 || data[0] != 0x2F) fail("WebP lossless: bad signature");
  LBits br(data + 1, size - 1);
  const int xsize = int(br.read(14)) + 1;
  const int ysize = int(br.read(14)) + 1;
  br.read(1);  // alpha hint
  if (br.read(3) != 0) fail("WebP lossless: version is not 0");
  std::vector<Transform> transforms;
  unsigned seen = 0;
  int w = xsize;
  while (br.read(1)) {
    Transform t{int(br.read(2)), 0, w, ysize, {}};
    if (seen & (1u << t.type)) fail("WebP lossless: a transform repeated");
    seen |= 1u << t.type;
    if (t.type == 0 || t.type == 1) {
      t.bits = int(br.read(3)) + 2;
      t.data = decode_entropy_image(br, sub_sample(w, t.bits),
                                    sub_sample(ysize, t.bits), false);
    } else if (t.type == 3) {
      const int colours = int(br.read(8)) + 1;
      t.bits = colours > 16 ? 0 : colours > 4 ? 1 : colours > 2 ? 2 : 3;
      std::vector<uint32_t> table = decode_entropy_image(br, colours, 1, false);
      t.data.assign(size_t(1) << (8 >> t.bits), 0);
      t.data[0] = table[0];
      for (int i = 1; i < colours; ++i) t.data[i] = add_pixels(table[i], t.data[i - 1]);
      w = sub_sample(w, t.bits);
    }
    transforms.push_back(std::move(t));
  }
  std::vector<uint32_t> px = decode_entropy_image(br, w, ysize, true);
  for (auto it = transforms.rbegin(); it != transforms.rend(); ++it) {
    const Transform &t = *it;
    const int W = t.xsize, H = t.ysize;
    if (t.type == 0) {  // predictor
      const int tiles = sub_sample(W, t.bits);
      px[0] = add_pixels(px[0], 0xFF000000u);
      for (int x = 1; x < W; ++x) px[x] = add_pixels(px[x], px[x - 1]);
      for (int y = 1; y < H; ++y) {
        uint32_t *row = &px[size_t(y) * W];
        const uint32_t *top = row - W;
        row[0] = add_pixels(row[0], top[0]);
        const uint32_t *modes = &t.data[size_t(y >> t.bits) * tiles];
        for (int x = 1; x < W; ++x) {
          const int mode = int((modes[x >> t.bits] >> 8) & 0xF);
          row[x] = add_pixels(row[x], predict(mode, row[x - 1], top + x));
        }
      }
    } else if (t.type == 1) {  // cross-colour
      const int tiles = sub_sample(W, t.bits);
      for (int y = 0; y < H; ++y) {
        for (int x = 0; x < W; ++x) {
          const uint32_t m = t.data[size_t(y >> t.bits) * tiles + (x >> t.bits)];
          const int g2r = int8_t(m & 0xFF), g2b = int8_t((m >> 8) & 0xFF),
                    r2b = int8_t((m >> 16) & 0xFF);
          uint32_t &p = px[size_t(y) * W + x];
          const int green = int8_t((p >> 8) & 0xFF);
          int red = int((p >> 16) & 0xFF), blue = int(p & 0xFF);
          red = (red + ((g2r * green) >> 5)) & 0xFF;
          blue += (g2b * green) >> 5;
          blue += (r2b * int8_t(red)) >> 5;
          blue &= 0xFF;
          p = (p & 0xFF00FF00u) | (uint32_t(red) << 16) | uint32_t(blue);
        }
      }
    } else if (t.type == 2) {  // subtract green
      for (auto &p : px) {
        const uint32_t g = (p >> 8) & 0xFF;
        const uint32_t rb = ((p & 0x00FF00FFu) + ((g << 16) | g)) & 0x00FF00FFu;
        p = (p & 0xFF00FF00u) | rb;
      }
    } else {  // colour indexing, `bits` pixels bundled per byte
      const int packed_w = sub_sample(W, t.bits);
      std::vector<uint32_t> outp(size_t(W) * H);
      const int bpp = 8 >> t.bits;
      const int count_mask = (1 << t.bits) - 1;
      const uint32_t bit_mask = (1u << bpp) - 1;
      for (int y = 0; y < H; ++y) {
        const uint32_t *src = &px[size_t(y) * packed_w];
        uint32_t *dst = &outp[size_t(y) * W];
        uint32_t packed = 0;
        for (int x = 0; x < W; ++x) {
          if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xFF;
          dst[x] = t.data[packed & bit_mask];
          packed >>= bpp;
        }
      }
      px.swap(outp);
    }
  }
  *width = xsize;
  *height = ysize;
  return px;
}

// ================================================================ VP8 (lossy)

// boolean decoder, as libwebp's VP8BitReader (range kept minus one; one
// byte loaded at a time; past the end a single zero byte, then `eof`)
struct BoolReader {
  const u8 *buf = nullptr, *end = nullptr;
  uint32_t value = 0, range = 255 - 1;
  int bits = -8;
  bool eof = false;

  void init(const u8 *start, size_t size) {
    buf = start;
    end = start + size;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    while (bits < 0) {
      if (buf < end) {
        bits += 8;
        value = uint32_t(*buf++) | (value << 8);
      } else if (!eof) {
        value <<= 8;
        bits += 8;
        eof = true;
      } else {
        bits = 0;
      }
    }
  }
  int get_bit(int prob) {
    if (bits < 0) load();
    uint32_t r = range;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = value >> bits;
    int bit;
    if (v > split) {
      r -= split;
      value -= (split + 1) << bits;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    int shift = 0;
    while ((r << shift) < 128) ++shift;
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_value(int n) {
    int v = 0;
    while (n-- > 0) v |= get_bit(0x80) << n;
    return v;
  }
  int get() { return get_value(1); }
  int get_signed_value(int n) {
    const int v = get_value(n);
    return get() ? -v : v;
  }
  int get_signed(int v) { return get_bit(0x80) ? -v : v; }
};

constexpr int BPS = 32;  // the work buffer's stride, as libwebp's
constexpr int kYOff = BPS * 1 + 8, kUOff = kYOff + BPS * 16 + BPS, kVOff = kUOff + 16;
constexpr int kWorkSize = BPS * 17 + BPS * 9;

inline u8 clip8(int v) { return u8(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(u8 *dst, int size) {
  const u8 *top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
    dst += BPS;
  }
}

void fill(u8 *dst, int value, int size) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, value, size);
}

// 16x16 (size 16) and chroma (size 8) prediction, `mode` after CheckMode
void predict_block(u8 *dst, int mode, int size) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC_PRED: {
      int dc = size;
      for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc >> (shift + 1), size);
      break;
    }
    case B_DC_PRED_NOTOP: {
      int dc = size >> 1;
      for (int i = 0; i < size; ++i) dc += dst[-1 + i * BPS];
      fill(dst, dc >> shift, size);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc = size >> 1;
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      fill(dst, dc >> shift, size);
      break;
    }
    case B_DC_PRED_NOTOPLEFT: fill(dst, 0x80, size); break;
    case B_TM_PRED: true_motion(dst, size); break;
    case B_VE_PRED:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
      break;
    case B_HE_PRED:
      for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], size);
      break;
    default: fail("WebP lossy: a corrupt intra mode");
  }
}

void predict4(u8 *dst, int mode) {
  const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
            D = dst[3 - BPS], E = dst[4 - BPS], F = dst[5 - BPS],
            G = dst[6 - BPS], H = dst[7 - BPS];
  const int X = dst[-1 - BPS], I = dst[-1], J = dst[-1 + BPS],
            K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const u8 vals[4] = {u8(avg3(X, A, B)), u8(avg3(A, B, C)),
                          u8(avg3(B, C, D)), u8(avg3(C, D, E))};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    default: fail("WebP lossy: a corrupt sub-block mode");
  }
}

#undef DST

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// dsp/dec.c's TransformOne: the inverse DCT of `in`, added to `dst`
void idct_add(const int16_t *in, u8 *dst) {
  int tmp[16];
  int *t = tmp;
  for (int i = 0; i < 4; ++i, ++in, t += 4) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    t[0] = a + d;
    t[1] = b + c;
    t[2] = b - c;
    t[3] = a - d;
  }
  t = tmp;
  for (int i = 0; i < 4; ++i, ++t, dst += BPS) {  // horizontal pass
    const int dc = t[0] + 4;
    const int a = dc + t[8];
    const int b = dc - t[8];
    const int c = mul2(t[4]) - mul1(t[12]);
    const int d = mul1(t[4]) + mul2(t[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

// the inverse Walsh-Hadamard transform of the Y2 block into the 16 DCs
void iwht(const int16_t *in, int16_t *out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// ---- loop filter (dsp/dec.c)

inline int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
inline int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }

inline void do_filter2(u8 *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void do_filter4(u8 *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void do_filter6(u8 *p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const u8 *p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}
inline bool needs_filter(const u8 *p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
inline bool needs_filter2(const u8 *p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// `size` positions, `hstride` across the edge and `vstride` along it
void simple_filter(u8 *p, int hstride, int vstride, int size, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
  }
}
void filter_loop(u8 *p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool edge) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) {
      do_filter2(p, hstride);
    } else if (edge) {
      do_filter6(p, hstride);
    } else {
      do_filter4(p, hstride);
    }
  }
}

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

// ---- the frame

struct MBInfo {  // per column: the non-zero context above
  uint8_t nz = 0, nz_dc = 0;
};

struct Block {
  int segment = 0;
  bool skip = false, is_i4x4 = false;
  u8 imodes[16] = {};
  u8 uvmode = 0;
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct VP8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  std::vector<BoolReader> parts;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {}, filter_strength[4] = {};
  u8 segment_proba[3] = {255, 255, 255};
  // filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, ref_lf_delta[4] = {}, mode_lf_delta[4] = {};
  int filter_type = 0;
  QuantMatrix dqm[4];
  u8 proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  FilterInfo fstrengths[4][2];
  // planes, macroblock-aligned
  int y_stride = 0, uv_stride = 0;
  std::vector<u8> Y, U, V;
  std::vector<FilterInfo> finfo;  // per macroblock

  void parse_headers(const u8 *data, size_t size);
  void decode_frame();
  void filter_frame();
  void to_rgb(u8 *out, long out_stride) const;
};

void VP8::parse_headers(const u8 *data, size_t size) {
  if (size < 10) fail("WebP lossy: truncated frame header");
  const uint32_t bits = le24(data);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (!key_frame) fail("WebP lossy: not a key frame");
  if (profile > 3) fail("WebP lossy: incorrect keyframe parameters");
  if (!show) fail("WebP lossy: frame not displayable");
  if (data[3] != 0x9D || data[4] != 0x01 || data[5] != 0x2A) {
    fail("WebP lossy: bad start code");
  }
  width = int(le16(data + 6) & 0x3FFF);
  height = int(le16(data + 8) & 0x3FFF);
  if (width == 0 || height == 0) fail("WebP lossy: zero-sized frame");
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  data += 10;
  size -= 10;
  if (partition_length > size) fail("WebP lossy: bad partition length");
  br.init(data, partition_length);
  data += partition_length;
  size -= partition_length;
  br.get();  // colour space
  br.get();  // clamping type
  // segment header
  use_segment = br.get();
  if (use_segment) {
    update_map = br.get();
    if (br.get()) {  // update data
      absolute_delta = br.get();
      for (int s = 0; s < 4; ++s) quantizer[s] = br.get() ? br.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength[s] = br.get() ? br.get_signed_value(6) : 0;
    }
    if (update_map) {
      for (int s = 0; s < 3; ++s) segment_proba[s] = u8(br.get() ? br.get_value(8) : 255);
    }
  }
  if (br.eof) fail("WebP lossy: cannot parse segment header");
  // filter header
  simple = br.get();
  level = br.get_value(6);
  sharpness = br.get_value(3);
  use_lf_delta = br.get();
  if (use_lf_delta && br.get()) {
    for (int i = 0; i < 4; ++i) {
      if (br.get()) ref_lf_delta[i] = br.get_signed_value(6);
    }
    for (int i = 0; i < 4; ++i) {
      if (br.get()) mode_lf_delta[i] = br.get_signed_value(6);
    }
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) fail("WebP lossy: cannot parse filter header");
  // partitions
  const int last = (1 << br.get_value(2)) - 1;
  if (size < size_t(3 * last)) fail("WebP lossy: cannot parse partitions");
  const u8 *sz = data;
  const u8 *part = data + 3 * last;
  size_t left = size - 3 * last;
  parts.assign(last + 1, BoolReader());
  for (int p = 0; p < last; ++p) {
    size_t psize = le24(sz);
    if (psize > left) psize = left;
    parts[p].init(part, psize);
    part += psize;
    left -= psize;
    sz += 3;
  }
  parts[last].init(part, left);
  if (part >= data + size) fail("WebP lossy: cannot parse partitions");
  // quantisation
  const int base_q0 = br.get_value(7);
  const int dqy1_dc = br.get() ? br.get_signed_value(4) : 0;
  const int dqy2_dc = br.get() ? br.get_signed_value(4) : 0;
  const int dqy2_ac = br.get() ? br.get_signed_value(4) : 0;
  const int dquv_dc = br.get() ? br.get_signed_value(4) : 0;
  const int dquv_ac = br.get() ? br.get_signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : (v > m ? m : v); };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i];
      if (!absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        dqm[i] = dqm[0];
        continue;
      }
      q = base_q0;
    }
    QuantMatrix &m = dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.get();  // update_proba, ignored for a key frame
  for (int t = 0; t < 4; ++t) {
    for (int b = 0; b < 8; ++b) {
      for (int c = 0; c < 3; ++c) {
        for (int p = 0; p < 11; ++p) {
          proba[t][b][c][p] = u8(br.get_bit(kCoeffsUpdateProba[t][b][c][p])
                                     ? br.get_value(8)
                                     : kCoeffsProba0[t][b][c][p]);
        }
      }
    }
  }
  use_skip_proba = br.get();
  if (use_skip_proba) skip_p = br.get_value(8);
  // filter strengths (PrecomputeFilterStrengths)
  if (filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment) {
        base_level = filter_strength[s];
        if (!absolute_delta) base_level += level;
      } else {
        base_level = level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo &info = fstrengths[s][i4x4];
        int lvl = base_level;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4x4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : (lvl > 63 ? 63 : lvl);
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lvl + ilevel;
          info.hev_thresh = lvl >= 40 ? 2 : (lvl >= 15 ? 1 : 0);
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }
}

// GetLargeValue: a coefficient of magnitude 2 and up
int large_value(BoolReader &br, const u8 *p) {
  int v;
  if (!br.get_bit(p[3])) {
    if (!br.get_bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br.get_bit(p[5]);
    }
  } else {
    if (!br.get_bit(p[6])) {
      if (!br.get_bit(p[7])) {
        v = 5 + br.get_bit(159);
      } else {
        v = 7 + 2 * br.get_bit(165);
        v += br.get_bit(145);
      }
    } else {
      const int bit1 = br.get_bit(p[8]);
      const int bit0 = br.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const u8 *tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// GetCoeffs: the tokens of one block from coefficient `n` on; returns the
// index after the last one read (16 after a run of zeros to the end)
int get_coeffs(BoolReader &br, const u8 (*bands)[3][11], int ctx,
               const int *dq, int n, int16_t *out) {
  const u8 *p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;
    while (!br.get_bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const u8(*next)[11] = bands[kBands[n + 1]];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = next[1];
    } else {
      v = large_value(br, p);
      p = next[2];
    }
    out[kZigzag[n]] = int16_t(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

void VP8::decode_frame() {
  y_stride = mb_w * 16;
  uv_stride = mb_w * 8;
  Y.assign(size_t(y_stride) * mb_h * 16, 0);
  U.assign(size_t(uv_stride) * mb_h * 8, 0);
  V.assign(size_t(uv_stride) * mb_h * 8, 0);
  finfo.assign(size_t(mb_w) * mb_h, FilterInfo());
  std::vector<u8> intra_t(size_t(4) * mb_w, B_DC_PRED);
  std::vector<MBInfo> mb_info(mb_w + 1);  // [0] is the left one
  // the bottom row of each macroblock, unfiltered, for the row below
  std::vector<u8> top_y(size_t(16) * mb_w), top_u(size_t(8) * mb_w),
      top_v(size_t(8) * mb_w);
  std::vector<Block> blocks(mb_w);
  std::vector<int16_t> coeffs(size_t(384) * mb_w);
  std::vector<uint32_t> nz_y(mb_w), nz_uv(mb_w);
  u8 work[kWorkSize];
  int kScan[16];
  for (int n = 0; n < 16; ++n) kScan[n] = (n & 3) * 4 + (n >> 2) * 4 * BPS;

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    // the intra modes of the row, from the first partition
    u8 intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      Block &b = blocks[mb_x];
      u8 *top = &intra_t[4 * mb_x];
      b.segment = update_map ? (!br.get_bit(segment_proba[0])
                                    ? br.get_bit(segment_proba[1])
                                    : br.get_bit(segment_proba[2]) + 2)
                             : 0;
      b.skip = use_skip_proba ? br.get_bit(skip_p) : false;
      b.is_i4x4 = !br.get_bit(145);
      if (!b.is_i4x4) {
        const int ymode = br.get_bit(156)
                              ? (br.get_bit(128) ? B_TM_PRED : B_HE_PRED)
                              : (br.get_bit(163) ? B_VE_PRED : B_DC_PRED);
        b.imodes[0] = u8(ymode);
        std::memset(top, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        u8 *modes = b.imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const u8 *prob = kBModesProba[top[x]][ymode];
            int i = kYModesIntra4[br.get_bit(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.get_bit(prob[i])];
            ymode = -i;
            top[x] = u8(ymode);
          }
          std::memcpy(modes, top, 4);
          modes += 4;
          intra_l[y] = u8(ymode);
        }
      }
      b.uvmode = u8(!br.get_bit(142)   ? B_DC_PRED
                    : !br.get_bit(114) ? B_VE_PRED
                    : br.get_bit(183)  ? B_TM_PRED
                                       : B_HE_PRED);
    }
    if (br.eof) fail("WebP lossy: premature end of the first partition");

    // residuals, from this row's token partition
    BoolReader &tbr = parts[mb_y & (int(parts.size()) - 1)];
    MBInfo &left = mb_info[0];
    left.nz = left.nz_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      Block &b = blocks[mb_x];
      MBInfo &mb = mb_info[mb_x + 1];
      int16_t *dst = &coeffs[size_t(384) * mb_x];
      std::memset(dst, 0, 384 * sizeof(int16_t));
      bool skip = b.skip && use_skip_proba;
      if (!skip) {
        const QuantMatrix &q = dqm[b.segment];
        uint32_t non_zero_y = 0, non_zero_uv = 0;
        int first;
        const u8(*ac_proba)[3][11];
        if (!b.is_i4x4) {
          int16_t dc[16] = {};
          const int ctx = mb.nz_dc + left.nz_dc;
          const int nz = get_coeffs(tbr, proba[1], ctx, q.y2, 0, dc);
          mb.nz_dc = left.nz_dc = nz > 0;
          if (nz > 1) {
            iwht(dc, dst);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
          }
          first = 1;
          ac_proba = proba[0];
        } else {
          first = 0;
          ac_proba = proba[3];
        }
        uint8_t tnz = mb.nz & 0x0F, lnz = left.nz & 0x0F;
        int16_t *d = dst;
        for (int y = 0; y < 4; ++y) {
          int l = lnz & 1;
          uint32_t nz_coeffs = 0;
          for (int x = 0; x < 4; ++x) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(tbr, ac_proba, ctx, q.y1, first, d);
            l = nz > first;
            tnz = uint8_t((tnz >> 1) | (l << 7));
            nz_coeffs = (nz_coeffs << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : (d[0] != 0));
            d += 16;
          }
          tnz >>= 4;
          lnz = uint8_t((lnz >> 1) | (l << 7));
          non_zero_y = (non_zero_y << 8) | nz_coeffs;
        }
        uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          uint32_t nz_coeffs = 0;
          tnz = uint8_t(mb.nz >> (4 + ch));
          lnz = uint8_t(left.nz >> (4 + ch));
          for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
              const int ctx = l + (tnz & 1);
              const int nz = get_coeffs(tbr, proba[2], ctx, q.uv, 0, d);
              l = nz > 0;
              tnz = uint8_t((tnz >> 1) | (l << 3));
              nz_coeffs = (nz_coeffs << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : (d[0] != 0));
              d += 16;
            }
            tnz >>= 2;
            lnz = uint8_t((lnz >> 1) | (l << 5));
          }
          non_zero_uv |= nz_coeffs << (4 * ch);
          out_t_nz |= uint32_t(tnz << 4) << ch;
          out_l_nz |= uint32_t(lnz & 0xF0) << ch;
        }
        mb.nz = uint8_t(out_t_nz);
        left.nz = uint8_t(out_l_nz);
        nz_y[mb_x] = non_zero_y;
        nz_uv[mb_x] = non_zero_uv;
        skip = !(non_zero_y | non_zero_uv);
      } else {
        left.nz = mb.nz = 0;
        if (!b.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        nz_y[mb_x] = nz_uv[mb_x] = 0;
      }
      if (filter_type > 0) {
        FilterInfo &f = finfo[size_t(mb_y) * mb_w + mb_x];
        f = fstrengths[b.segment][b.is_i4x4];
        f.inner = f.inner || !skip;
      }
      if (tbr.eof) fail("WebP lossy: premature end of a token partition");
    }

    // reconstruction (ReconstructRow), into the work buffer
    u8 *const y_dst = work + kYOff;
    u8 *const u_dst = work + kUOff;
    u8 *const v_dst = work + kVOff;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const Block &b = blocks[mb_x];
      if (mb_x > 0) {  // the left samples, from the previous macroblock
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      const int16_t *c = &coeffs[size_t(384) * mb_x];
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
        std::memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
        std::memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
      }
      uint32_t bits = nz_y[mb_x];
      if (b.is_i4x4) {
        u8 *top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) {
            std::memset(top_right, top_y[16 * mb_x + 15], 4);
          } else {
            std::memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
          }
        }
        for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          u8 *dst = y_dst + kScan[n];
          predict4(dst, b.imodes[n]);
          if (bits >> 30) idct_add(c + n * 16, dst);
        }
      } else {
        int mode = b.imodes[0];
        if (mode == B_DC_PRED) {
          mode = mb_x == 0 ? (mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT)
                           : (mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED);
        }
        predict_block(y_dst, mode, 16);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          if (bits >> 30) idct_add(c + n * 16, y_dst + kScan[n]);
        }
      }
      {
        const uint32_t bits_uv = nz_uv[mb_x];
        int mode = b.uvmode;
        if (mode == B_DC_PRED) {
          mode = mb_x == 0 ? (mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT)
                           : (mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED);
        }
        predict_block(u_dst, mode, 8);
        predict_block(v_dst, mode, 8);
        for (int n = 0; n < 4; ++n) {  // a zero block adds nothing
          const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
          if (bits_uv & 0xFF) idct_add(c + 256 + n * 16, u_dst + off);
          if (bits_uv & 0xFF00) idct_add(c + 320 + n * 16, v_dst + off);
        }
      }
      // keep the bottom row for the row below; copy out the macroblock
      std::memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
      std::memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
      std::memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
      for (int j = 0; j < 16; ++j) {
        std::memcpy(&Y[size_t(mb_y * 16 + j) * y_stride + mb_x * 16], y_dst + j * BPS, 16);
      }
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&U[size_t(mb_y * 8 + j) * uv_stride + mb_x * 8], u_dst + j * BPS, 8);
        std::memcpy(&V[size_t(mb_y * 8 + j) * uv_stride + mb_x * 8], v_dst + j * BPS, 8);
      }
    }
  }
}

// the loop filter over the reconstructed frame, macroblocks in raster order
// (what libwebp's row pipeline does, as prediction read unfiltered pixels)
void VP8::filter_frame() {
  if (filter_type == 0) return;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const FilterInfo &f = finfo[size_t(mb_y) * mb_w + mb_x];
      const int limit = f.limit;
      if (limit == 0) continue;
      u8 *y = &Y[size_t(mb_y * 16) * y_stride + mb_x * 16];
      const int ys = y_stride;
      if (filter_type == 1) {
        if (mb_x > 0) simple_filter(y, 1, ys, 16, limit + 4);
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k, 1, ys, 16, limit);
        }
        if (mb_y > 0) simple_filter(y, ys, 1, 16, limit + 4);
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k * ys, ys, 1, 16, limit);
        }
      } else {
        const int us = uv_stride;
        u8 *u = &U[size_t(mb_y * 8) * us + mb_x * 8];
        u8 *v = &V[size_t(mb_y * 8) * us + mb_x * 8];
        const int il = f.ilevel, hv = f.hev_thresh;
        if (mb_x > 0) {
          filter_loop(y, 1, ys, 16, limit + 4, il, hv, true);
          filter_loop(u, 1, us, 8, limit + 4, il, hv, true);
          filter_loop(v, 1, us, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k, 1, ys, 16, limit, il, hv, false);
          filter_loop(u + 4, 1, us, 8, limit, il, hv, false);
          filter_loop(v + 4, 1, us, 8, limit, il, hv, false);
        }
        if (mb_y > 0) {
          filter_loop(y, ys, 1, 16, limit + 4, il, hv, true);
          filter_loop(u, us, 1, 8, limit + 4, il, hv, true);
          filter_loop(v, us, 1, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
          filter_loop(u + 4 * us, us, 1, 8, limit, il, hv, false);
          filter_loop(v + 4 * us, us, 1, 8, limit, il, hv, false);
        }
      }
    }
  }
}

// dsp/yuv.h: 14-bit fixed point, then 6 fractional bits dropped
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) {
  return (v & ~16383) == 0 ? (v >> 6) : (v < 0 ? 0 : 255);
}
inline void yuv_to_rgb(int y, int u, int v, u8 *rgb) {
  rgb[0] = u8(yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgb[1] = u8(yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                        mult_hi(v, 13320) + 8708));
  rgb[2] = u8(yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

// dsp/upsampling.c's UpsampleRgbLinePair: two output rows (bottom may be
// null) from two chroma rows, (9, 3, 3, 1) / 16 weights
void upsample_pair(const u8 *top_y, const u8 *bottom_y, const u8 *top_u,
                   const u8 *top_v, const u8 *cur_u, const u8 *cur_v,
                   u8 *top_dst, u8 *bottom_dst, int len) {
  auto load = [](int u, int v) { return uint32_t(u) | (uint32_t(v) << 16); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = load(top_u[0], top_v[0]);
  uint32_t l_uv = load(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xFF, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xFF, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]);
    const uint32_t uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xFF, uv0 >> 16, top_dst + (2 * x - 1) * 3);
      yuv_to_rgb(top_y[2 * x], uv1 & 0xFF, uv1 >> 16, top_dst + (2 * x) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xFF, uv0 >> 16, bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], uv1 & 0xFF, uv1 >> 16, bottom_dst + (2 * x) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xFF, uv0 >> 16, top_dst + (len - 1) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xFF, uv0 >> 16, bottom_dst + (len - 1) * 3);
    }
  }
}

// EmitFancyRGB over the whole frame: row 0 from chroma row 0 alone, then
// pairs of rows between chroma rows, and the last row of an even height
void VP8::to_rgb(u8 *out, long out_stride) const {
  const int w = width, h = height;
  const u8 *y0 = Y.data(), *u0 = U.data(), *v0 = V.data();
  upsample_pair(y0, nullptr, u0, v0, u0, v0, out, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const int k = y / 2;
    upsample_pair(&Y[size_t(y + 1) * y_stride], &Y[size_t(y + 2) * y_stride],
                  &U[size_t(k) * uv_stride], &V[size_t(k) * uv_stride],
                  &U[size_t(k + 1) * uv_stride], &V[size_t(k + 1) * uv_stride],
                  out + (y + 1) * out_stride, out + (y + 2) * out_stride, w);
  }
  if (!(h & 1)) {
    const int k = y / 2;
    const u8 *u = &U[size_t(k) * uv_stride], *v = &V[size_t(k) * uv_stride];
    upsample_pair(&Y[size_t(h - 1) * y_stride], nullptr, u, v, u, v,
                  out + (h - 1) * out_stride, nullptr, w);
  }
}

// ============================================================ RIFF container

struct Frame {
  const u8 *data = nullptr;
  size_t size = 0;
  bool lossless = false;
  int x = 0, y = 0, width = 0, height = 0;  // on the canvas; 0: whole
};

struct Container {
  int canvas_w = 0, canvas_h = 0;
  Frame frame;
};

// the bitstream's own size
void bitstream_size(const Frame &f, int *w, int *h) {
  if (f.lossless) {
    if (f.size < 5 || f.data[0] != 0x2F) fail("WebP lossless: bad signature");
    const uint32_t bits = le32(f.data + 1);
    *w = int(bits & 0x3FFF) + 1;
    *h = int((bits >> 14) & 0x3FFF) + 1;
  } else {
    if (f.size < 10) fail("WebP lossy: truncated frame header");
    if (f.data[3] != 0x9D || f.data[4] != 0x01 || f.data[5] != 0x2A) {
      fail("WebP lossy: bad start code");
    }
    *w = int(le16(f.data + 6) & 0x3FFF);
    *h = int(le16(f.data + 8) & 0x3FFF);
  }
}

// the image chunk among [p, end): ALPH skipped; false if none
bool find_image(const u8 *p, const u8 *end, Frame *f) {
  while (end - p >= 8) {
    const uint32_t n = le32(p + 4);
    if (n > size_t(end - p) - 8) fail("WebP: truncated chunk");
    if (!std::memcmp(p, "VP8 ", 4) || !std::memcmp(p, "VP8L", 4)) {
      f->data = p + 8;
      f->size = n;
      f->lossless = p[3] == 'L';
      return true;
    }
    p += 8 + n + (n & 1);
  }
  return false;
}

Container parse_container(const u8 *data, size_t size) {
  if (size < 12 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WEBP", 4)) {
    fail("not a WebP file");
  }
  const uint32_t riff = le32(data + 4);
  if (riff < 12 || size_t(riff) + 8 > size) fail("WebP: truncated RIFF data");
  const u8 *p = data + 12, *end = data + 8 + riff;
  Container c;
  if (end - p < 8) fail("WebP: no image chunk");
  if (!std::memcmp(p, "VP8X", 4)) {
    const uint32_t n = le32(p + 4);
    if (n < 10 || n > size_t(end - p) - 8) fail("WebP: bad VP8X chunk");
    const u8 flags = p[8];
    c.canvas_w = int(le24(p + 12)) + 1;
    c.canvas_h = int(le24(p + 15)) + 1;
    const bool animated = flags & 0x02;
    p += 8 + n + (n & 1);
    if (animated) {
      // the first ANMF frame: offset, size, then its own chunks
      while (end - p >= 8) {
        const uint32_t m = le32(p + 4);
        if (m > size_t(end - p) - 8) fail("WebP: truncated chunk");
        if (!std::memcmp(p, "ANMF", 4)) {
          if (m < 16) fail("WebP: bad ANMF chunk");
          const u8 *q = p + 8;
          c.frame.x = 2 * int(le24(q));
          c.frame.y = 2 * int(le24(q + 3));
          c.frame.width = int(le24(q + 6)) + 1;
          c.frame.height = int(le24(q + 9)) + 1;
          if (!find_image(q + 16, q + m, &c.frame)) fail("WebP: an animation frame without an image");
          if (c.frame.x + c.frame.width > c.canvas_w ||
              c.frame.y + c.frame.height > c.canvas_h) {
            fail("WebP: an animation frame outside its canvas");
          }
          return c;
        }
        p += 8 + m + (m & 1);
      }
      fail("WebP: an animation without frames");
    }
    if (!find_image(p, end, &c.frame)) fail("WebP: no image chunk");
    int w, h;
    bitstream_size(c.frame, &w, &h);
    if (w != c.canvas_w || h != c.canvas_h) {
      fail("WebP: the image does not fill its VP8X canvas");
    }
    c.frame.width = w;
    c.frame.height = h;
    return c;
  }
  if (!find_image(p, end, &c.frame)) fail("WebP: no image chunk");
  bitstream_size(c.frame, &c.canvas_w, &c.canvas_h);
  c.frame.width = c.canvas_w;
  c.frame.height = c.canvas_h;
  return c;
}

void decode(const u8 *data, size_t size, u8 *out) {
  const Container c = parse_container(data, size);
  std::memset(out, 0, size_t(c.canvas_w) * c.canvas_h * 3);
  const long stride = long(c.canvas_w) * 3;
  u8 *dst = out + c.frame.y * stride + c.frame.x * 3;
  int w, h;
  bitstream_size(c.frame, &w, &h);
  if (w != c.frame.width || h != c.frame.height) {
    fail("WebP: a frame's bitstream does not match its size");
  }
  if (c.frame.lossless) {
    const std::vector<uint32_t> px = decode_vp8l(c.frame.data, c.frame.size, &w, &h);
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        const uint32_t p = px[size_t(y) * w + x];
        u8 *o = dst + y * stride + x * 3;
        o[0] = u8(p >> 16);
        o[1] = u8(p >> 8);
        o[2] = u8(p);
      }
    }
  } else {
    VP8 dec;
    dec.parse_headers(c.frame.data, c.frame.size);
    dec.decode_frame();
    dec.filter_frame();
    dec.to_rgb(dst, stride);
  }
}

void message(char *err, long cap, const char *what) {
  if (cap <= 0) return;
  std::strncpy(err, what, size_t(cap) - 1);
  err[cap - 1] = '\0';
}

}  // namespace

extern "C" {

// the canvas's height and width; 0, or -1 with `err` written
int webp_info(const u8 *data, long size, long *dims, char *err, long errcap) {
  try {
    const Container c = parse_container(data, size_t(size));
    dims[0] = c.canvas_h;
    dims[1] = c.canvas_w;
    return 0;
  } catch (const std::exception &e) {
    message(err, errcap, e.what());
    return -1;
  }
}

// decode into `out`, (height, width, 3) uint8 RGB; 0, or -1 with `err`
int webp_decode(const u8 *data, long size, u8 *out, char *err, long errcap) {
  try {
    decode(data, size_t(size), out);
    return 0;
  } catch (const std::exception &e) {
    message(err, errcap, e.what());
    return -1;
  }
}

}  // extern "C"

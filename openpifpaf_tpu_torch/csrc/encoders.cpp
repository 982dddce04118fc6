// Native target painters: CIF / CAF ground-truth painting on the host.
//
// The PyTorch port's copy of openpifpaf_tpu/csrc/encoders.cpp, the same
// painting semantics as the numpy loops of encoder/cif.py and
// encoder/caf.py (the per-image loops that the data loader pays for on the
// host), which stay as the explicit alternative (use_native=False) and
// the oracle of the tests.  A plain shared library with a C interface and
// no dependencies, bound with ctypes by encoder/native.py, which builds it
// at first use with the host's C++ compiler.

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <limits>

namespace {

inline long idx3(long f, long j, long i, long h, long w) {
    return (f * h + j) * w + i;
}

}  // namespace

extern "C" {

// Paint CIF targets for one image.
//   kps:        (n_inst, k, 3) keypoints in feature-cell coordinates
//   inst_scale: (n_inst,) per-instance scale (cell units)
//   sigmas:     (k,) per-keypoint-type sigma
//   conf        (k, h, w) float32
//   conf_mask   (k, h, w) uint8 (pre-filled with the bg mask)
//   vec         (k, 1, 2, h, w) float32
//   vec_mask    (k, 1, h, w) uint8
//   scale       (k, 1, h, w) float32
//   scale_mask  (k, 1, h, w) uint8
//   closest     (k, h, w) float32 scratch, pre-filled with +inf
void paint_cif(const float* kps, const float* inst_scale,
               const float* sigmas,
               long n_inst, long k, long h, long w,
               long side_length, float v_threshold,
               float* conf, uint8_t* conf_mask,
               float* vec, uint8_t* vec_mask,
               float* scale, uint8_t* scale_mask,
               float* closest) {
    const float offset = (side_length - 1) / 2.0f;
    for (long inst = 0; inst < n_inst; ++inst) {
        for (long fi = 0; fi < k; ++fi) {
            const float x = kps[(inst * k + fi) * 3 + 0];
            const float y = kps[(inst * k + fi) * 3 + 1];
            const float v = kps[(inst * k + fi) * 3 + 2];
            if (v <= v_threshold) continue;
            const float joint_scale =
                std::max(1e-3f, sigmas[fi] * inst_scale[inst]);
            // ties to even, as numpy's np.round in cif.py (std::lround,
            // which the JAX package's copy calls, rounds them away from 0)
            const long i0 = std::lrint(x - offset);
            const long j0 = std::lrint(y - offset);
            const long j_lo = std::max(0L, j0);
            const long j_hi = std::min(h, j0 + side_length);
            const long i_lo = std::max(0L, i0);
            const long i_hi = std::min(w, i0 + side_length);
            for (long j = j_lo; j < j_hi; ++j) {
                for (long i = i_lo; i < i_hi; ++i) {
                    const float dx = x - i;
                    const float dy = y - j;
                    const float d2 = dx * dx + dy * dy;
                    const long c = idx3(fi, j, i, h, w);
                    if (d2 >= closest[c]) continue;
                    closest[c] = d2;
                    const bool core =
                        std::fabs(dx) < 1.0f && std::fabs(dy) < 1.0f;
                    if (core) conf[c] = 1.0f;
                    conf_mask[c] = 1;
                    // vec layout (k, 1, 2, h, w) -> (fi*2 + comp)*h*w + j*w + i
                    vec[(fi * 2 + 0) * h * w + j * w + i] = dx;
                    vec[(fi * 2 + 1) * h * w + j * w + i] = dy;
                    vec_mask[c] = 1;
                    scale[c] = joint_scale;
                    scale_mask[c] = joint_scale > 0.0f ? 1 : 0;
                }
            }
        }
    }
}

// Paint CAF targets for one image.
//   skeleton: (e, 2) 0-based keypoint indices
//   conf (e, h, w); vec (e, 2, 2, h, w); vec_mask (e, 2, h, w);
//   scale (e, 2, h, w); scale_mask (e, 2, h, w); closest (e, h, w) = +inf
void paint_caf(const float* kps, const float* inst_scale,
               const float* sigmas, const int32_t* skeleton,
               long n_inst, long k, long e, long h, long w,
               float min_size, float v_threshold,
               float* conf, uint8_t* conf_mask,
               float* vec, uint8_t* vec_mask,
               float* scale, uint8_t* scale_mask,
               float* closest) {
    const float pad = min_size / 2.0f;
    const long hw = h * w;
    for (long inst = 0; inst < n_inst; ++inst) {
        for (long ei = 0; ei < e; ++ei) {
            const long a = skeleton[ei * 2 + 0];
            const long b = skeleton[ei * 2 + 1];
            const float x1 = kps[(inst * k + a) * 3 + 0];
            const float y1 = kps[(inst * k + a) * 3 + 1];
            const float v1 = kps[(inst * k + a) * 3 + 2];
            const float x2 = kps[(inst * k + b) * 3 + 0];
            const float y2 = kps[(inst * k + b) * 3 + 1];
            const float v2 = kps[(inst * k + b) * 3 + 2];
            if (v1 <= v_threshold || v2 <= v_threshold) continue;
            const float s1 = std::max(1e-3f, sigmas[a] * inst_scale[inst]);
            const float s2 = std::max(1e-3f, sigmas[b] * inst_scale[inst]);

            const long i_lo = std::max(
                0L, (long)std::floor(std::min(x1, x2) - pad));
            const long i_hi = std::min(
                w - 1, (long)std::ceil(std::max(x1, x2) + pad));
            const long j_lo = std::max(
                0L, (long)std::floor(std::min(y1, y2) - pad));
            const long j_hi = std::min(
                h - 1, (long)std::ceil(std::max(y1, y2) + pad));
            if (i_hi < i_lo || j_hi < j_lo) continue;

            const float dx = x2 - x1;
            const float dy = y2 - y1;
            const float seg_len2 = std::max(1e-8f, dx * dx + dy * dy);
            for (long j = j_lo; j <= j_hi; ++j) {
                for (long i = i_lo; i <= i_hi; ++i) {
                    float t = ((i - x1) * dx + (j - y1) * dy) / seg_len2;
                    t = std::min(1.0f, std::max(0.0f, t));
                    const float px = x1 + t * dx;
                    const float py = y1 + t * dy;
                    const float d2 =
                        (i - px) * (i - px) + (j - py) * (j - py);
                    if (d2 > pad * pad) continue;
                    const long c = idx3(ei, j, i, h, w);
                    if (d2 >= closest[c]) continue;
                    closest[c] = d2;
                    conf[c] = 1.0f;
                    conf_mask[c] = 1;
                    // vec: (e, 2, 2, h, w)
                    vec[((ei * 2 + 0) * 2 + 0) * hw + j * w + i] = x1 - i;
                    vec[((ei * 2 + 0) * 2 + 1) * hw + j * w + i] = y1 - j;
                    vec[((ei * 2 + 1) * 2 + 0) * hw + j * w + i] = x2 - i;
                    vec[((ei * 2 + 1) * 2 + 1) * hw + j * w + i] = y2 - j;
                    // vec_mask/scale/scale_mask: (e, 2, h, w)
                    vec_mask[(ei * 2 + 0) * hw + j * w + i] = 1;
                    vec_mask[(ei * 2 + 1) * hw + j * w + i] = 1;
                    scale[(ei * 2 + 0) * hw + j * w + i] = s1;
                    scale[(ei * 2 + 1) * hw + j * w + i] = s2;
                    scale_mask[(ei * 2 + 0) * hw + j * w + i] = 1;
                    scale_mask[(ei * 2 + 1) * hw + j * w + i] = 1;
                }
            }
        }
    }
}

}  // extern "C"

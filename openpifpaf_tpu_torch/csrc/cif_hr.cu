// CifHr splat on Hopper (sm_90a): the port's kernel K1.
//
// Replaces the TPU kernel openpifpaf_tpu/ops/pallas_cif_hr.py::accumulate_pallas
// (body _kernel).  For every (image b, field f) it computes
//
//   hr[Y, X] = clip( sum_c  gy[c, Y] * gx[c, X], 0, 1 )
//   gy[c, Y] = v_c * exp(-dy^2 / (2 s_c^2)) * [|dy| <= t * s_c],  dy = Y*sp + y0 - y_c
//   gx[c, X] =       exp(-dx^2 / (2 s_c^2)) * [|dx| <= t * s_c],  dx = X*sp      - x_c
//
// with v == 0 for masked cells.  The TPU kernel builds both profile matrices
// for the whole field in VMEM and contracts them on the MXU; on this card a
// block holds at most 227 KB of shared memory and blocks run in parallel, so
// the design is tiled instead:
//
// - one CTA per (b, f, 32x32 output tile), 256 threads, 4 outputs each;
// - the cells stream through in chunks of 256 (one per thread).  A cell is
//   kept only if v != 0 and its truncation window, widened by 1 px, meets the
//   tile; the survivors are compacted in cell order with a warp ballot and a
//   prefix over warps (no atomics, so the sum order — and the result — is
//   deterministic);
// - for up to 64 survivors at a time the tile's 32-row and 32-column profile
//   slices are built in shared memory with expf (not __expf: the parity
//   tolerance against the plain version is 2e-5), then every thread
//   accumulates its outputs in f32 registers;
// - the tile is clipped and stored once.
//
// What bounds it: the output write (B*F*Hh*Wh*4 bytes; 56 MB for a batch of
// 8 at 641 px, 17 us at 3.35 TB/s).  Skipping cells whose window misses the
// tile makes the arithmetic scale with the blobs' area instead of the dense
// 2*F*Hh*Wh*N, so the f32 work is far below the CUDA cores' rate.  The
// remaining cost is each tile re-reading its field's cell list (an L2 read,
// not a device-memory read); a first pass that bins cells to tiles is the
// next step if the kernel needs to be faster.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = THREADS;   // cells tested per pass, one per thread
constexpr int SUB = 64;          // surviving cells whose profiles are staged at once
constexpr int OUT_PER_THREAD = TILE * TILE / THREADS;

__global__ void __launch_bounds__(THREADS)
cif_hr_kernel(const float* __restrict__ v, const float* __restrict__ x,
              const float* __restrict__ y, const float* __restrict__ sigma,
              float* __restrict__ out, int n, int hh, int wh, float spacing,
              float truncate, float y_offset, int clip) {
  __shared__ float s_v[CHUNK], s_x[CHUNK], s_y[CHUNK], s_inv[CHUNK], s_tr[CHUNK];
  __shared__ int s_warp_count[WARPS];
  __shared__ float s_gy[SUB][TILE];
  __shared__ float s_gx[SUB][TILE];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t bf = blockIdx.z;
  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  const float* vb = v + bf * n;
  const float* xb = x + bf * n;
  const float* yb = y + bf * n;
  const float* sb = sigma + bf * n;

  // the tile's extent in px, widened by 1 px: the skip test only has to be
  // conservative, the profiles themselves apply the exact truncation test
  const float tile_y_lo = __fadd_rn(__fmul_rn((float)y0, spacing), y_offset) - 1.f;
  const float tile_y_hi =
      __fadd_rn(__fmul_rn((float)(min(y0 + TILE, hh) - 1), spacing), y_offset) + 1.f;
  const float tile_x_lo = __fmul_rn((float)x0, spacing) - 1.f;
  const float tile_x_hi = __fmul_rn((float)(min(x0 + TILE, wh) - 1), spacing) + 1.f;

  float acc[OUT_PER_THREAD];
#pragma unroll
  for (int i = 0; i < OUT_PER_THREAD; ++i) acc[i] = 0.f;

  for (int base = 0; base < n; base += CHUNK) {
    const int c = base + tid;
    bool keep = false;
    float cv = 0.f, cx = 0.f, cy = 0.f, cinv = 0.f, ctr = 0.f;
    if (c < n) {
      cv = vb[c];
      if (cv != 0.f) {
        cx = xb[c];
        cy = yb[c];
        const float s = sb[c];
        cinv = 0.5f / (s * s);
        ctr = truncate * s;
        keep = (cy - ctr <= tile_y_hi) && (cy + ctr >= tile_y_lo) &&
               (cx - ctr <= tile_x_hi) && (cx + ctr >= tile_x_lo);
      }
    }
    // deterministic compaction of the kept cells, in cell order
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int cnt = s_warp_count[w];
      offset += (w < warp) ? cnt : 0;
      total += cnt;
    }
    if (keep) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
      s_v[pos] = cv;
      s_x[pos] = cx;
      s_y[pos] = cy;
      s_inv[pos] = cinv;
      s_tr[pos] = ctr;
    }
    __syncthreads();

    for (int s0 = 0; s0 < total; s0 += SUB) {
      const int ns = min(SUB, total - s0);
      for (int i = tid; i < ns * 2 * TILE; i += THREADS) {
        const int cell = i / (2 * TILE);
        const int j = i - cell * 2 * TILE;
        const int a = s0 + cell;
        if (j < TILE) {
          const float ys = __fadd_rn(__fmul_rn((float)(y0 + j), spacing), y_offset);
          const float dy = ys - s_y[a];
          float g = expf(-dy * dy * s_inv[a]);
          g = fabsf(dy) <= s_tr[a] ? g : 0.f;
          s_gy[cell][j] = g * s_v[a];
        } else {
          const int jx = j - TILE;
          const float xs = __fmul_rn((float)(x0 + jx), spacing);
          const float dx = xs - s_x[a];
          const float g = expf(-dx * dx * s_inv[a]);
          s_gx[cell][jx] = fabsf(dx) <= s_tr[a] ? g : 0.f;
        }
      }
      __syncthreads();
      for (int cell = 0; cell < ns; ++cell) {
        const float gxv = s_gx[cell][lane];
#pragma unroll
        for (int i = 0; i < OUT_PER_THREAD; ++i)
          acc[i] = fmaf(s_gy[cell][warp + WARPS * i], gxv, acc[i]);
      }
      __syncthreads();
    }
  }

  const int ox = x0 + lane;
  if (ox >= wh) return;
  float* ob = out + bf * (size_t)hh * wh;
#pragma unroll
  for (int i = 0; i < OUT_PER_THREAD; ++i) {
    const int oy = y0 + warp + WARPS * i;
    if (oy < hh) {
      float r = acc[i];
      if (clip) r = fminf(fmaxf(r, 0.f), 1.f);
      ob[(size_t)oy * wh + ox] = r;
    }
  }
}

}  // namespace

// v, x, y, sigma: (n_images_times_fields, n) float32, contiguous, on the card.
// out: (n_images_times_fields, hh, wh) float32.  Launches on `stream` without
// synchronizing; returns cudaGetLastError() of the launch.
extern "C" int cif_hr_accumulate_f32(const float* v, const float* x, const float* y,
                                     const float* sigma, float* out, int bf, int n,
                                     int hh, int wh, float spacing, float truncate,
                                     float y_offset, int clip, void* stream) {
  if (bf <= 0 || hh <= 0 || wh <= 0) return 0;
  const dim3 grid((wh + TILE - 1) / TILE, (hh + TILE - 1) / TILE, bf);
  cif_hr_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      v, x, y, sigma, out, n, hh, wh, spacing, truncate, y_offset, clip);
  return static_cast<int>(cudaGetLastError());
}

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
// for the whole field in VMEM and contracts them on the MXU.  On this card a
// block holds at most 227 KB of shared memory and blocks run in parallel, so
// the output is cut into TH x TW tiles, and a cell's blob meets only the few
// tiles under its truncation window (~3% of a served field's cells reach a
// 32 x 64 tile).  Two passes, both launched on the caller's stream:
//
// 1. bin_kernel: a CTA per 256 cells of an (image, field) — more when the
//    grid's masks do not fit its shared memory — reads the cells once,
//    coalesced.  For each cell with v != 0 it finds the tiles that its
//    truncation window, widened by 1 px, meets, and sets the cell's bit in
//    each such tile's bitmask in shared memory with atomicOr (an OR is
//    order-free, so the result is deterministic).  The masks go to a
//    (B*F, tiles, ceil(n/32)) scratch tensor.  The candidate tiles come from
//    the window over the tile's extent, widened by one tile on each side;
//    each candidate then takes the exact per-tile comparison (the same
//    __fmul_rn/__fadd_rn expressions as the plain binning,
//    ops/cif_hr.py::tile_bins_plain), so the masks equal the plain binning
//    bit for bit.
// 2. splat_kernel: one CTA per (image, field, tile), a warp per 16 x 32
//    block of the tile.  It turns the tile's mask words into an ascending
//    list of cell indices in shared memory (a __popc prefix) and gathers only
//    those cells from L2.  For each cell it finds the rows and columns of
//    the tile and the grid that its window may cover and the warp blocks
//    both meet, and builds the row and column profiles inside that window
//    only, 8 lanes per cell (expf, not __expf: the parity tolerance against
//    the plain version is 2e-5; zeros elsewhere).  Each warp then walks the cells that meet its
//    block in ascending order (a ballot over their block masks), each
//    thread accumulating a 4 x 4 register tile with fmaf in f32; it clips
//    and stores.  The 4 x 4 tiles keep the shared-memory reads of a cell
//    (8 wavefronts a warp) in step with its 16 fmaf a thread: one output
//    per thread (a row profile value broadcast to the warp for every fmaf)
//    left the accumulation bound by shared-memory bandwidth.
//
// Every output sums its cells in ascending cell order with the same expf and
// fmaf as the single-pass kernel this replaces; a cell left out of a tile
// contributes exactly 0 there (its window misses the tile), so the result
// equals that kernel's bit for bit.
//
// What bounds it: the output write (B*F*Hh*Wh*4 bytes; 56 MB for a batch of
// 8 at 641 px, 17 us at 3.35 TB/s).  The splat stays well above that: its
// time goes to the profiles (an expf per window entry and tile) and to the
// accumulation, which does a few times the useful fmaf because a warp's
// block is larger than the part of a cell's window inside it (PERF.md).
// Not used, and why:
// - tensor cores: the f32 operation bound is a quarter of the byte bound,
//   and TF32 would break the 2e-5 tolerance;
// - TMA stores: a 321-float output row is 1284 B, not a multiple of 16 B, so
//   there is no tensor map of the (B, F, Hh, Wh) output; padding it would
//   change the layout every reader of the grid uses (ops/seeds.py,
//   ops/caf_scored.py through common.gather_field_grouped).  A warp's
//   stores are whole 32-byte sectors instead (8 columns of 4 rows).

#include <cuda_runtime.h>

namespace {

// the output tile, rows x columns; of 32 x 32, 32 x 64, 64 x 32 and 64 x 64
// this was the fastest on the served inputs (PERF.md)
constexpr int TH = 32;
constexpr int TW = 64;
constexpr int BIN_THREADS = 256;
constexpr int WCHUNK = 64;             // mask words turned into indices at once
constexpr int SUB = 64;                // cells whose profiles are staged at once
constexpr int PROFILE_LANES = 8;       // lanes that build one cell's profiles
constexpr int BIN_SMEM = 48 * 1024;    // bytes of masks one bin CTA holds
constexpr int BIN_WORDS = BIN_THREADS / 32;  // mask words per bin CTA: a cell per thread

// the tile's extent in px, widened by 1 px: the binning only has to be
// conservative, the profiles apply the exact truncation test
__device__ __forceinline__ float row_lo(int r0, float sp, float y_off) {
  return __fsub_rn(__fadd_rn(__fmul_rn((float)r0, sp), y_off), 1.f);
}
__device__ __forceinline__ float row_hi(int r1, float sp, float y_off) {
  return __fadd_rn(__fadd_rn(__fmul_rn((float)r1, sp), y_off), 1.f);
}
__device__ __forceinline__ float col_lo(int c0, float sp) {
  return __fsub_rn(__fmul_rn((float)c0, sp), 1.f);
}
__device__ __forceinline__ float col_hi(int c1, float sp) {
  return __fadd_rn(__fmul_rn((float)c1, sp), 1.f);
}

// [first, last] tile along one axis that a window [lo, hi] (px, already
// shifted by the grid's offset) may meet: the window over the tile's extent
// in px (a product with its reciprocal), widened by 1 px and one tile on
// each side, then clamped (NaN lands on an empty range)
__device__ __forceinline__ void tile_range(float lo, float hi, float inv_extent_px,
                                           int n_tiles, int& first, int& last) {
  float a = floorf((lo - 1.f) * inv_extent_px) - 1.f;
  float b = floorf((hi + 1.f) * inv_extent_px) + 1.f;
  a = fmaxf(fminf(a, (float)n_tiles), 0.f);
  b = fmaxf(fminf(b, (float)(n_tiles - 1)), -1.f);
  first = (int)a;
  last = (int)b;
}

__global__ void __launch_bounds__(BIN_THREADS)
bin_kernel(const float* __restrict__ v, const float* __restrict__ x,
           const float* __restrict__ y, const float* __restrict__ sigma,
           unsigned* __restrict__ masks, int n, int words, int hh, int wh,
           int tiles_y, int tiles_x, int words_per_cta, int tiles_per_cta,
           float spacing, float truncate, float y_offset) {
  extern __shared__ unsigned s_mask[];   // [tiles_per_cta][words_per_cta]
  const int tid = threadIdx.x;
  const size_t bf = blockIdx.z;
  const int w0 = blockIdx.x * words_per_cta;
  const int w1 = min(w0 + words_per_cta, words);
  const int t0 = blockIdx.y * tiles_per_cta;
  const int t1 = min(t0 + tiles_per_cta, tiles_y * tiles_x);
  const int nw = w1 - w0;
  for (int i = tid; i < (t1 - t0) * nw; i += BIN_THREADS) s_mask[i] = 0u;
  __syncthreads();

  const float inv_th = 1.f / (spacing * TH), inv_tw = 1.f / (spacing * TW);
  const int c_end = min(w1 * 32, n);
  for (int c = w0 * 32 + tid; c < c_end; c += BIN_THREADS) {
    const size_t at = bf * n + c;
    const float cv = v[at], cx = x[at], cy = y[at], cs = sigma[at];
    if (cv == 0.f) continue;
    const float ctr = __fmul_rn(truncate, cs);
    const float ylo = __fsub_rn(cy, ctr), yhi = __fadd_rn(cy, ctr);
    const float xlo = __fsub_rn(cx, ctr), xhi = __fadd_rn(cx, ctr);
    int ty0, ty1, tx0, tx1;
    tile_range(ylo - y_offset, yhi - y_offset, inv_th, tiles_y, ty0, ty1);
    tile_range(xlo, xhi, inv_tw, tiles_x, tx0, tx1);
    const unsigned bit = 1u << (c & 31);
    const int word = (c >> 5) - w0;
    for (int ty = ty0; ty <= ty1; ++ty) {
      const int r0 = ty * TH;
      if (!(ylo <= row_hi(min(r0 + TH, hh) - 1, spacing, y_offset) &&
            yhi >= row_lo(r0, spacing, y_offset)))
        continue;
      for (int tx = tx0; tx <= tx1; ++tx) {
        const int q0 = tx * TW;
        const int t = ty * tiles_x + tx;
        if (t < t0 || t >= t1) continue;
        if (xlo <= col_hi(min(q0 + TW, wh) - 1, spacing) && xhi >= col_lo(q0, spacing))
          atomicOr(&s_mask[(t - t0) * nw + word], bit);
      }
    }
  }
  __syncthreads();

  unsigned* mb = masks + (bf * tiles_y * tiles_x) * words;
  for (int i = tid; i < (t1 - t0) * nw; i += BIN_THREADS) {
    const int t = t0 + i / nw;
    mb[(size_t)t * words + w0 + i % nw] = s_mask[i];
  }
}

// splat_kernel's warps: a (TH / 16) x (TW / 32) grid of 16 x 32 blocks
constexpr int SPLAT_THREADS = 32 * (TH / 16) * (TW / 32);

__global__ void __launch_bounds__(SPLAT_THREADS)
splat_kernel(const unsigned* __restrict__ masks, const float* __restrict__ v,
             const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ sigma, float* __restrict__ out, int n,
             int words, int hh, int wh, float spacing, float truncate,
             float y_offset, int clip) {
  // each warp owns a 16 x 32 block of the tile; lane (ly, lx) = (lane / 8,
  // lane % 8) owns rows 4 ly .. 4 ly + 3 and columns lx + 8 j (j < 4) of it:
  // per cell a warp loads its block's profiles in 8 shared-memory wavefronts
  // (rows as one float4 per quarter-warp, columns as 4 conflict-free words)
  // for 16 fmaf a thread
  constexpr int NT = SPLAT_THREADS;
  constexpr int NW = NT / 32;
  constexpr int WC = TW / 32;
  static_assert(TH % 16 == 0 && TW % 32 == 0 && NT >= WCHUNK && NT >= SUB, "tile shape");
  __shared__ int s_idx[WCHUNK * 32];
  __shared__ int s_wtotal[WCHUNK / 32];
  __shared__ float s_v[SUB], s_x[SUB], s_y[SUB], s_inv[SUB], s_tr[SUB];
  __shared__ int s_rows[SUB], s_cols[SUB];  // tile-local [lo, hi], lo | hi << 16
  __shared__ unsigned s_hit[SUB];           // bit w: the cell may touch warp w's block
  __shared__ __align__(16) float s_gy[SUB][TH];
  __shared__ __align__(16) float s_gx[SUB][TW];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int brow = (warp / WC) * 16 + (lane >> 3) * 4;   // the thread's first row
  const int bcol = (warp % WC) * 32 + (lane & 7);        // and column, in the tile
  const size_t bf = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const unsigned* mb =
      masks + (bf * gridDim.y * gridDim.x + blockIdx.y * gridDim.x + blockIdx.x) * words;
  const float* vb = v + bf * n;
  const float* xb = x + bf * n;
  const float* yb = y + bf * n;
  const float* sb = sigma + bf * n;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int w0 = 0; w0 < words; w0 += WCHUNK) {
    // the chunk's set bits, as ascending cell indices: a __popc prefix over
    // the mask words (one word per thread of the first WCHUNK)
    unsigned bits = 0u;
    if (tid < WCHUNK && w0 + tid < words) bits = mb[w0 + tid];
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31 && warp < WCHUNK / 32) s_wtotal[warp] = incl;
    __syncthreads();
    int pos = incl - cnt, total = 0;
#pragma unroll
    for (int w = 0; w < WCHUNK / 32; ++w) {
      const int t = s_wtotal[w];
      pos += (w < warp) ? t : 0;
      total += t;
    }
    const int cbase = (w0 + tid) * 32;
    while (bits) {
      s_idx[pos++] = cbase + __ffs(bits) - 1;
      bits &= bits - 1u;
    }
    __syncthreads();

    for (int s0 = 0; s0 < total; s0 += SUB) {
      const int ns = min(SUB, total - s0);
      // profiles are 0 outside each cell's window
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = tid; i < ns * TH / 4; i += NT)
        reinterpret_cast<float4*>(&s_gy[0][0])[i] = zero;
      for (int i = tid; i < ns * TW / 4; i += NT)
        reinterpret_cast<float4*>(&s_gx[0][0])[i] = zero;
      if (tid < ns) {
        // gather the cell; the tile-local rows and columns of the grid its
        // window may cover (widened by one on each side: the profiles apply
        // the exact test), and the warp blocks that both meet
        const int c = s_idx[s0 + tid];
        const float cy = yb[c], cx = xb[c], s = sb[c];
        const float tr = __fmul_rn(truncate, s);
        s_v[tid] = vb[c];
        s_x[tid] = cx;
        s_y[tid] = cy;
        s_inv[tid] = 0.5f / (s * s);
        s_tr[tid] = tr;
        const float inv_sp = 1.f / spacing;
        const float ra = fmaxf(ceilf((cy - tr - y_offset) * inv_sp) - 1.f - (float)y0, 0.f);
        const float rb = fminf(floorf((cy + tr - y_offset) * inv_sp) + 1.f - (float)y0,
                               (float)(min(TH, hh - y0) - 1));
        const float ca = fmaxf(ceilf((cx - tr) * inv_sp) - 1.f - (float)x0, 0.f);
        const float cb = fminf(floorf((cx + tr) * inv_sp) + 1.f - (float)x0,
                               (float)(min(TW, wh - x0) - 1));
        unsigned hit = 0u;
        int rows = 0, cols = 0;
        if (ra <= rb && ca <= cb) {
          const int r_lo = (int)ra, r_hi = (int)rb, c_lo = (int)ca, c_hi = (int)cb;
          rows = r_lo | (r_hi << 16);
          cols = c_lo | (c_hi << 16);
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const int br = (w / WC) * 16, bc = (w % WC) * 32;
            if (r_lo < br + 16 && r_hi >= br && c_lo < bc + 32 && c_hi >= bc) hit |= 1u << w;
          }
        }
        s_rows[tid] = rows;
        s_cols[tid] = cols;
        s_hit[tid] = hit;
      }
      __syncthreads();
      // the profiles inside each cell's window (zeros elsewhere), a group
      // of PROFILE_LANES lanes per cell; one branch-free loop over the
      // window's rows, then its columns: for a column the position takes
      // + 0.f (exact) and the value * 1.f (exact) in place of y_offset and v
      for (int cell = warp * (32 / PROFILE_LANES) + lane / PROFILE_LANES; cell < ns;
           cell += NW * (32 / PROFILE_LANES)) {
        if (s_hit[cell] == 0u) continue;
        const float cv = s_v[cell], cx = s_x[cell], cy = s_y[cell];
        const float inv = s_inv[cell], tr = s_tr[cell];
        const int rows = s_rows[cell], cols = s_cols[cell];
        const int r_lo = rows & 0xffff, c_lo = cols & 0xffff;
        const int nr = (rows >> 16) - r_lo + 1;
        const int m = nr + (cols >> 16) - c_lo + 1;
        for (int e = lane % PROFILE_LANES; e < m; e += PROFILE_LANES) {
          const bool is_row = e < nr;
          const int k = is_row ? r_lo + e : c_lo + e - nr;
          const float p = __fadd_rn(__fmul_rn((float)((is_row ? y0 : x0) + k), spacing),
                                    is_row ? y_offset : 0.f);
          const float d = p - (is_row ? cy : cx);
          float g = expf(-d * d * inv);
          g = fabsf(d) <= tr ? g : 0.f;
          (is_row ? &s_gy[cell][0] : &s_gx[cell][0])[k] = g * (is_row ? cv : 1.f);
        }
      }
      __syncthreads();
      // each warp walks, in ascending order, the cells that may touch its
      // block; the others add exactly 0 there (fmaf(0, g, a) == a)
      for (int c0 = 0; c0 < ns; c0 += 32) {
        unsigned hits =
            __ballot_sync(0xffffffffu, c0 + lane < ns && ((s_hit[c0 + lane] >> warp) & 1u));
        while (hits) {
          const int cell = c0 + __ffs(hits) - 1;
          hits &= hits - 1u;
          const float4 q = *reinterpret_cast<const float4*>(&s_gy[cell][brow]);
          const float gy[4] = {q.x, q.y, q.z, q.w};
          float gx[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) gx[j] = s_gx[cell][bcol + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gy[i], gx[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  // for each row, the warp stores four 32-byte runs of 8 columns
  float* ob = out + bf * (size_t)hh * wh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oy = y0 + brow + i;
    if (oy >= hh) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ox = x0 + bcol + 8 * j;
      if (ox < wh) {
        float r = acc[i][j];
        if (clip) r = fminf(fmaxf(r, 0.f), 1.f);
        ob[(size_t)oy * wh + ox] = r;
      }
    }
  }
}

// bin_kernel's launch: the words and tiles a CTA takes, so that its masks
// fit BIN_SMEM (groups of tiles once a single word of every tile does not)
int launch_bin(const float* v, const float* x, const float* y, const float* sigma,
               unsigned* masks, int bf, int n, int hh, int wh, float spacing,
               float truncate, float y_offset, cudaStream_t stream) {
  const int tiles_y = (hh + TH - 1) / TH, tiles_x = (wh + TW - 1) / TW;
  const int words = (n + 31) / 32, tiles = tiles_y * tiles_x;
  const int wpc = max(1, min(min(words, BIN_WORDS), BIN_SMEM / (4 * tiles)));
  const int tpc = min(tiles, BIN_SMEM / (4 * wpc));
  const dim3 grid(max(1, (words + wpc - 1) / wpc), (tiles + tpc - 1) / tpc, bf);
  bin_kernel<<<grid, BIN_THREADS, 4 * tpc * wpc, stream>>>(
      v, x, y, sigma, masks, n, words, hh, wh, tiles_y, tiles_x, wpc, tpc, spacing,
      truncate, y_offset);
  return static_cast<int>(cudaGetLastError());
}

int launch_both(const float* v, const float* x, const float* y, const float* sigma,
                unsigned* masks, float* out, int bf, int n, int hh, int wh,
                float spacing, float truncate, float y_offset, int clip,
                cudaStream_t stream) {
  const int rc = launch_bin(v, x, y, sigma, masks, bf, n, hh, wh, spacing, truncate,
                            y_offset, stream);
  if (rc != 0) return rc;
  const dim3 grid((wh + TW - 1) / TW, (hh + TH - 1) / TH, bf);
  splat_kernel<<<grid, SPLAT_THREADS, 0, stream>>>(
      masks, v, x, y, sigma, out, n, (n + 31) / 32, hh, wh, spacing, truncate,
      y_offset, clip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs `launch` with `device` as the current device, restoring the caller's.
template <typename F>
int on_device(int device, F launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch();
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

// Both entry points launch on `stream` of card `device` without
// synchronizing and return the first nonzero cudaGetLastError() of their
// launches.

// Pass 1 alone.  v, x, y, sigma: (bf, n) float32, contiguous, on the card.
// masks: (bf, ceil(hh/32) * ceil(wh/64), ceil(n/32)) uint32, tiles
// row-major; bit c % 32 of word c / 32 is set when cell c's widened window
// meets the tile.
extern "C" int cif_hr_bin_f32(const float* v, const float* x, const float* y,
                              const float* sigma, unsigned* masks, int bf, int n, int hh,
                              int wh, float spacing, float truncate, float y_offset,
                              int device, void* stream) {
  if (bf <= 0 || hh <= 0 || wh <= 0) return 0;
  return on_device(device, [&] {
    return launch_bin(v, x, y, sigma, masks, bf, n, hh, wh, spacing, truncate, y_offset,
                      static_cast<cudaStream_t>(stream));
  });
}

// Both passes.  masks: scratch as for cif_hr_bin_f32; out: (bf, hh, wh)
// float32.
extern "C" int cif_hr_accumulate_f32(const float* v, const float* x, const float* y,
                                     const float* sigma, unsigned* masks, float* out,
                                     int bf, int n, int hh, int wh, float spacing,
                                     float truncate, float y_offset, int clip, int device,
                                     void* stream) {
  if (bf <= 0 || hh <= 0 || wh <= 0) return 0;
  return on_device(device, [&] {
    return launch_both(v, x, y, sigma, masks, out, bf, n, hh, wh, spacing, truncate,
                       y_offset, clip, static_cast<cudaStream_t>(stream));
  });
}

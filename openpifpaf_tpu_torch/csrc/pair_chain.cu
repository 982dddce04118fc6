// Stride-1 ShuffleNetV2K chain on the parity pair, on Hopper (sm_90a): the
// port's kernel K2.
//
// Replaces the TPU kernel openpifpaf_tpu/ops/pallas_pair_chain.py::pair_chain_pallas
// (body _chain_math).  The pair (a, b), each (B, H, W, C) channels-last with
// q = C / 2, goes through n blocks with inference BatchNorm folded to
// per-channel (scale, bias):
//
//   t  = relu(s1 * (a[q:] @ W1[0::2] + b[q:] @ W1[1::2]) + o1)
//   u  = sdw * dw5x5_SAME(t) + odw
//   v  = relu(s2 * (u @ W2) + o2)
//   x1 = interleave(a[:q], b[:q])          -> the state becomes (x1, v)
//
// The Pallas kernel keeps a haloed row band of the whole chain in VMEM.  A
// Hopper block has at most 227 KB of shared memory and blocks run in
// parallel, so this design runs three kernels per block, with t the only
// intermediate in device memory:
//
// - interleave_kernel: x1, one pair of channels per thread and store.
// - expand_kernel, 64 consecutive pixels a CTA: the GEMM operand is
//   [a[q - o:], b[q - o:]] with o = q & 1, copied with 2-channel cp.async.
//   q is odd at sn2k16's stage 2 (87), so a[q:] starts on no 4-byte
//   boundary; starting one channel early keeps every copy aligned, and the
//   packed W1 has zero rows for the two extra channels.  Epilogue: s1, o1,
//   relu; t is written with a row pitch of Kp (its padding channels are
//   exact zeros).
// - project_kernel, one 8x8 pixel tile a CTA: for each chunk of channels it
//   copies t for the tile and its 2-px halo into shared memory (cp.async,
//   double-buffered; zero-fill outside the image, which is the SAME padding
//   of t: a zero input pixel would not give a zero t, since relu(o1) != 0),
//   computes the 5x5 stencil in float32 registers (each thread slides a
//   5-row window down one column of one channel) and stores u, rounded,
//   into the GEMM operand.  Epilogue: s2, o2, relu.
//
// In both GEMM kernels the CTA's whole operand (64 x Kp, Kp = C + 2o rounded
// up to 64) stays in shared memory, so the stencil runs once per pixel and
// channel, and the CTA walks over all 128-channel output tiles, streaming
// the weight tiles (64 deep) through a ring of three cp.async buffers (two
// where three would leave an SM a single CTA).  Storage is bfloat16 (the
// served path) with warp mma.sync m16n8k16 on the tensor cores, or float32
// with CUDA-core FMAs (no TF32), for the tight parity check.  Both
// accumulate in float32 and apply the epilogues in float32, storing two
// channels at a time.  Weights are zero-padded to (Np, Kp), N to 128, so a
// tile never reads past them; pixel and channel tails are masked.
//
// What bounds it: sn2k16's three chains at batch 8 are 345 GFLOP of tensor-
// core work against ~510 MB of pair traffic, so the card's bf16 rate bounds
// the two deeper chains and the bytes bound stage 2 (chip_smoke.py prints
// the bounds).  This design stays far from either.  Timing variants with
// parts of the kernels switched off (PERF.md) found no single limit: the
// pipeline's waits and barriers, the two-channel epilogue stores, the
// weight tiles streamed from L2 for every 64 pixels and, at stage 4 where a
// CTA's operand leaves an SM one CTA, mma.sync's latency with 8 warps.
// wgmma with TMA, larger pixel tiles sharing weight tiles across a cluster,
// and a chain kept on chip are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 64;      // pixels of a CTA
constexpr int BN = 128;     // output channels of a GEMM tile (N_TILE)
constexpr int KSTEP = 64;   // K padding of the weights (K_STEP)
constexpr int TH = 8;       // project_kernel's pixel tile: TH x TW = BM
constexpr int TW = 8;
constexpr int HALO_H = TH + 4;
constexpr int HALO_W = TW + 4;
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90

// reduction depth of one streamed weight tile, and channels of one stencil
// chunk, by storage type (both divide KSTEP)
template <typename T> struct Depth;
template <> struct Depth<__nv_bfloat16> { static constexpr int value = 64; };
template <> struct Depth<float> { static constexpr int value = 32; };
template <typename T> struct StencilDepth;
template <> struct StencilDepth<__nv_bfloat16> { static constexpr int value = 32; };
template <> struct StencilDepth<float> { static constexpr int value = 16; };

// row padding of the shared-memory tiles: 16 bytes, so rows stay 16-byte
// aligned and, for bf16, the fragment loads of 8 rows hit distinct banks
template <typename T> struct Pad {
  static constexpr int value = 16 / static_cast<int>(sizeof(T));
};
template <typename T> struct Ldb {
  static constexpr int value = Depth<T>::value + Pad<T>::value;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// dst[0] = x, dst[1] = y in one store (dst is 2-element aligned)
__device__ __forceinline__ void store_pair(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, __nv_bfloat16 x,
                                           __nv_bfloat16 y) {
  __nv_bfloat162 p;
  p.x = x;
  p.y = y;
  *reinterpret_cast<__nv_bfloat162*>(dst) = p;
}

// 16-byte cp.async; src_bytes == 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
// a 2-element cp.async (4 bytes for bf16, 8 for f32); src_bytes == 0 fills zeros
template <typename T>
__device__ __forceinline__ void cp_async_pair(T* smem, const T* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (sizeof(T) == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(valid ? 4 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The CTA's 64 x 128 product of one K chunk, acc[32] per thread.  As: the
// resident operand at the chunk's first column, row pitch lda; Bs: the
// weight tile, (128, Ldb).  A thread's accumulators come in 16 pairs of
// adjacent output channels (pair_acc: the index of the pair's first), on
// 4 column pairs (col: the first column of pair j).
template <typename T> struct Tile;

template <> struct Tile<__nv_bfloat16> {
  // 8 warps as 2 (pixels) x 4 (channels), 32 x 32 each: 2 x 4 mma tiles
  static __device__ __forceinline__ void product(const __nv_bfloat16* As, int lda,
                                                 const __nv_bfloat16* Bs,
                                                 float (&acc)[32]) {
    constexpr int LDB = Ldb<__nv_bfloat16>::value;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int ks = 0; ks < Depth<__nv_bfloat16>::value; ks += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p = As + (wm + mi * 16 + g) * lda + ks + 2 * t4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* p = Bs + (wn + ni * 8 + g) * LDB + ks + 2 * t4;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float* d = acc + (mi * 4 + ni) * 4;
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
              : "r"(af[mi][0]), "r"(af[mi][1]), "r"(af[mi][2]), "r"(af[mi][3]),
                "r"(bfr[ni][0]), "r"(bfr[ni][1]));
        }
      }
    }
  }
  // pair e = (mi, ni, upper half): rows g and g + 8 of mma tile (mi, ni)
  static __device__ __forceinline__ int col(int j) {
    return (threadIdx.x >> 6) * 32 + j * 8 + 2 * (threadIdx.x & 3);
  }
  static __device__ __forceinline__ void pair(int e, int& row, int& j, int& idx) {
    const int mi = e >> 3, half = e & 1;
    j = (e >> 1) & 3;
    row = ((threadIdx.x >> 5) & 1) * 32 + mi * 16 + ((threadIdx.x & 31) >> 2) + 8 * half;
    idx = (mi * 4 + j) * 4 + 2 * half;
  }
};

template <> struct Tile<float> {
  // each thread: 4 pixels x 4 pairs of channels (pairs 32 apart)
  static __device__ __forceinline__ void product(const float* As, int lda, const float* Bs,
                                                 float (&acc)[32]) {
    constexpr int LDB = Ldb<float>::value;
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
    for (int k = 0; k < Depth<float>::value; ++k) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[(tr * 4 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[(2 * tc + 32 * (j >> 1) + (j & 1)) * LDB + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
    }
  }
  static __device__ __forceinline__ int col(int j) { return 2 * (threadIdx.x & 15) + 32 * j; }
  static __device__ __forceinline__ void pair(int e, int& row, int& j, int& idx) {
    j = e & 3;
    row = (threadIdx.x >> 4) * 4 + (e >> 2);
    idx = (e >> 2) * 8 + 2 * j;
  }
};

// Bs[n][k] = W[n0 + n][k0 + k] from the padded (Np, Kp) weights
template <typename T>
__device__ __forceinline__ void load_weights_async(T* Bs, const T* __restrict__ W, int kp,
                                                   int n0, int k0) {
  constexpr int BK = Depth<T>::value, LDB = Ldb<T>::value;
  constexpr int VEC = 16 / sizeof(T), PER_ROW = BK / VEC;
  for (int i = threadIdx.x; i < BN * PER_ROW; i += THREADS) {
    const int n = i / PER_ROW, kc = (i - n * PER_ROW) * VEC;
    cp_async16(Bs + n * LDB + kc, W + (size_t)(n0 + n) * kp + k0 + kc, 16);
  }
}

// The resident operand As (64 x kp, pitch lda) times every 128-column tile
// of W^T (the padded (np, kp) weights), the weight tiles streamed through a
// ring of `stages` (2 or 3) buffers at Bbuf.  Each finished tile goes
// through y = relu(scale * acc + bias) (scale, bias padded to np) and
// store(row, col, f0, f1) for the output channels col, col + 1.  As must be
// complete, or in cp.async groups committed before the call (the first wait
// and barrier below publish it); Bbuf must not be in use by any thread.
template <typename T, typename Store>
__device__ __forceinline__ void gemm(const T* As, int lda, T* Bbuf, const T* __restrict__ W,
                                     int kp, int np, int stages,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ bias, Store store) {
  constexpr int BK = Depth<T>::value, TILE = BN * Ldb<T>::value;
  const int n_k = kp / BK, n_it = (np / BN) * n_k;
  float acc[32];
  float2 sv[4], bv[4];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int it = 0; it < stages - 1; ++it) {
    if (it < n_it) {
      const int nt = it / n_k;
      load_weights_async<T>(Bbuf + it * TILE, W, kp, nt * BN, (it - nt * n_k) * BK);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    const int nt = it / n_k, kc = it - nt * n_k;
    if (kc == 0) {  // this tile's scale and bias, long before the epilogue
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nt * BN + Tile<T>::col(j);
        sv[j] = *reinterpret_cast<const float2*>(scale + n);
        bv[j] = *reinterpret_cast<const float2*>(bias + n);
      }
    }
    const int ahead = it + stages - 1;
    if (ahead < n_it) {
      const int nt1 = ahead / n_k;
      load_weights_async<T>(Bbuf + (ahead % stages) * TILE, W, kp, nt1 * BN,
                            (ahead - nt1 * n_k) * BK);
    }
    cp_async_commit();
    if (stages == 3)
      cp_async_wait<2>();
    else
      cp_async_wait<1>();
    __syncthreads();
    Tile<T>::product(As + kc * BK, lda, Bbuf + (it % stages) * TILE, acc);
    if (kc == n_k - 1) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        int row, j, idx;
        Tile<T>::pair(e, row, j, idx);
        store(row, nt * BN + Tile<T>::col(j), fmaxf(fmaf(sv[j].x, acc[idx], bv[j].x), 0.f),
              fmaxf(fmaf(sv[j].y, acc[idx + 1], bv[j].y), 0.f));
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    }
    __syncthreads();
  }
}

// x1 = interleave(a[:q], b[:q]): one pair of channels per element
template <typename T>
__global__ void __launch_bounds__(THREADS)
interleave_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ x1,
                  long long n_pairs, int c, int q) {
  const long long step = (long long)gridDim.x * THREADS;
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < n_pairs; p += step) {
    const long long m = p / q;
    const long long i = p - m * q;
    const size_t row = (size_t)m * c;
    store_pair(x1 + row + 2 * i, a[row + i], b[row + i]);
  }
}

// t = relu(s1 * ([a[q:], b[q:]] @ W1) + o1) for 64 consecutive pixels.
// The operand's columns, with o = q & 1: [0, q + o) hold a[q - o:] and
// [q + o, C + 2o) hold b[q - o:], so every 2-element copy is aligned on both
// sides even where q is odd; the packed W1 has zero rows for the columns
// holding a[q - 1] and b[q - 1] (finite activations times zero) and for the
// zero-filled tail up to Kp.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
expand_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ t,
              const T* __restrict__ w1, const float* __restrict__ vec, int m_total, int c,
              int kp, int np, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = kp + Pad<T>::value;
  T* As = reinterpret_cast<T*>(smem);
  T* Bbuf = As + BM * lda;
  const int m0 = blockIdx.x * BM, q = c >> 1, o = q & 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = min(BM, m_total - m0);

  for (int r = warp; r < BM; r += WARPS) {
    const bool valid = r < rows;
    const size_t row = (size_t)(m0 + (valid ? r : 0)) * c;
    T* dst = As + r * lda;
    for (int j = 2 * lane; j < kp; j += 64) {
      const bool in_a = j < q + o, in_b = !in_a && j < c + 2 * o;
      const T* src = in_a ? a + row + q - o + j : (in_b ? b + row + j - 2 * o : a);
      cp_async_pair(dst + j, src, valid && (in_a || in_b));
    }
  }
  cp_async_commit();

  gemm<T>(As, lda, Bbuf, w1, kp, np, stages, vec, vec + np,
          [&](int row, int n, float f0, float f1) {
            const int m = m0 + row;
            if (m < m_total && n < kp)
              store_pair(t + (size_t)m * kp + n, from_f<T>(f0), from_f<T>(f1));
          });
}

// Shared memory of project_kernel's first phase, one of two buffers: t for
// the tile and its halo, the chunk's 25 taps and its sdw, odw.
template <typename T> struct StencilBuf {
  static constexpr int BK = StencilDepth<T>::value, LDT = BK + Pad<T>::value;
  static constexpr int T_BYTES = HALO_H * HALO_W * LDT * sizeof(T);
  static constexpr int W_BYTES = 25 * BK * 4;
  static constexpr int BYTES = T_BYTES + W_BYTES + 2 * BK * 4;
};

template <typename T>
__device__ __forceinline__ void load_stencil_async(unsigned char* buf, const T* __restrict__ t,
                                                   const float* __restrict__ dwk,
                                                   const float* __restrict__ sdw_odw,
                                                   int img, int y0, int x0, int h, int w,
                                                   int kp, int np, int k0) {
  using S = StencilBuf<T>;
  constexpr int VEC = 16 / sizeof(T), PER_POS = S::BK / VEC, PER_TAP = S::BK / 4;
  T* ts = reinterpret_cast<T*>(buf);
  float* ws = reinterpret_cast<float*>(buf + S::T_BYTES);
  float* so = reinterpret_cast<float*>(buf + S::T_BYTES + S::W_BYTES);
  for (int i = threadIdx.x; i < HALO_H * HALO_W * PER_POS; i += THREADS) {
    const int pos = i / PER_POS, kc = (i - pos * PER_POS) * VEC;
    const int yy = y0 - 2 + pos / HALO_W, xx = x0 - 2 + pos % HALO_W;
    const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < w;
    const T* src = inside ? t + (((size_t)img * h + yy) * w + xx) * kp + k0 + kc : t;
    cp_async16(ts + pos * S::LDT + kc, src, inside ? 16 : 0);
  }
  for (int i = threadIdx.x; i < 27 * PER_TAP; i += THREADS) {
    const int row = i / PER_TAP, kc = (i - row * PER_TAP) * 4;
    if (row < 25)
      cp_async16(ws + row * S::BK + kc, dwk + (size_t)row * np + k0 + kc, 16);
    else  // rows 25, 26: sdw, odw (vec rows 2, 3)
      cp_async16(so + (row - 25) * S::BK + kc, sdw_odw + (size_t)(row - 25) * np + k0 + kc, 16);
  }
}

// v = relu(s2 * ((sdw * dw5x5(t) + odw) @ W2) + o2) for one 8x8 pixel tile
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
project_kernel(const T* __restrict__ t, T* __restrict__ v, const T* __restrict__ w2,
               const float* __restrict__ vec, const float* __restrict__ dwk, int h, int w,
               int c, int kp, int np, int tiles_x, int tiles_y, int stages) {
  using S = StencilBuf<T>;
  constexpr int BK = S::BK;
  constexpr int GROUPS = THREADS / (BK * TW);  // row groups of the stencil
  constexpr int ROWS = TH / GROUPS;            // output rows per thread
  static_assert(GROUPS * ROWS == TH && TH * TW == BM, "stencil thread map");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = kp + Pad<T>::value;
  T* Us = reinterpret_cast<T*>(smem);
  unsigned char* work = smem + (size_t)BM * lda * sizeof(T);

  int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int img = tile / tiles_y;
  const int y0 = ty * TH, x0 = tx * TW;
  const int cc = threadIdx.x % BK;
  const int px = (threadIdx.x / BK) % TW;
  const int rg = threadIdx.x / (BK * TW);

  // phase 1: u for the tile's 64 pixels and all kp channels, into Us
  const int n_k = kp / BK;
  load_stencil_async<T>(work, t, dwk, vec + 2 * np, img, y0, x0, h, w, kp, np, 0);
  cp_async_commit();
  for (int kc = 0; kc < n_k; ++kc) {
    if (kc + 1 < n_k)
      load_stencil_async<T>(work + ((kc + 1) & 1) * S::BYTES, t, dwk, vec + 2 * np, img, y0,
                            x0, h, w, kp, np, (kc + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* buf = work + (kc & 1) * S::BYTES;
    const T* ts = reinterpret_cast<const T*>(buf);
    const float* ws = reinterpret_cast<const float*>(buf + S::T_BYTES);
    const float* so = reinterpret_cast<const float*>(buf + S::T_BYTES + S::W_BYTES);
    float wr[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) wr[i] = ws[i * BK + cc];
    float u[ROWS];
#pragma unroll
    for (int oy = 0; oy < ROWS; ++oy) u[oy] = 0.f;
#pragma unroll
    for (int hy = 0; hy < ROWS + 4; ++hy) {
      const T* src = ts + ((rg * ROWS + hy) * HALO_W + px) * S::LDT + cc;
      float tv[5];
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) tv[dx] = to_f(src[dx * S::LDT]);
#pragma unroll
      for (int oy = 0; oy < ROWS; ++oy) {
        const int dy = hy - oy;
        if (dy >= 0 && dy < 5) {
#pragma unroll
          for (int dx = 0; dx < 5; ++dx) u[oy] = fmaf(tv[dx], wr[dy * 5 + dx], u[oy]);
        }
      }
    }
    const float sdw = so[cc], odw = so[BK + cc];
#pragma unroll
    for (int oy = 0; oy < ROWS; ++oy)
      Us[((rg * ROWS + oy) * TW + px) * lda + kc * BK + cc] = from_f<T>(fmaf(u[oy], sdw, odw));
    __syncthreads();
  }

  // phase 2: Us @ W2, the weight tiles streamed through the same buffers
  gemm<T>(Us, lda, reinterpret_cast<T*>(work), w2, kp, np, stages, vec + 4 * np, vec + 5 * np,
          [&](int row, int n, float f0, float f1) {
            const int y = y0 + row / TW, x = x0 + row % TW;
            if (y < h && x < w && n < c)
              store_pair(v + (((size_t)img * h + y) * w + x) * c + n, from_f<T>(f0),
                         from_f<T>(f1));
          });
}

// A CTA's dynamic shared memory: the resident operand, then a region that
// holds the weight ring of `stages` tiles (and, in project_kernel, first the
// stencil buffers, `floor` bytes).
template <typename T>
size_t smem_bytes(size_t operand, size_t floor, int stages) {
  const size_t ring = (size_t)stages * BN * Ldb<T>::value * sizeof(T);
  return operand + (ring > floor ? ring : floor);
}

// Three weight tiles in flight, unless that leaves an SM fewer CTAs than two
// (the register budget of __launch_bounds__(THREADS, 2) allows two at most).
template <typename T>
int ring_stages(size_t operand, size_t floor) {
  constexpr size_t SM_BYTES = 233472, PER_CTA = 1024;  // sm_90: 228 KB, 1 KB per CTA
  const auto ctas = [&](int stages) {
    const size_t n = SM_BYTES / (smem_bytes<T>(operand, floor, stages) + PER_CTA);
    return n < 2 ? n : 2;
  };
  return ctas(3) >= ctas(2) ? 3 : 2;
}

template <typename T>
int run_chain(const T* a, const T* b, T* out_a, T* out_b, T* tmp_a, T* tmp_b, T* t,
              const T* w1, const T* w2, const float* vec, const float* dwk, int n_blocks,
              int batch, int h, int w, int c, cudaStream_t stream) {
  if (n_blocks <= 0 || batch <= 0 || h <= 0 || w <= 0 || c <= 0 || (c & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q = c / 2;
  const int kp = (c + 2 * (q & 1) + KSTEP - 1) / KSTEP * KSTEP;
  const int np = (c + BN - 1) / BN * BN;
  const int m_total = batch * h * w;
  const int tiles_x = (w + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
  const size_t operand = (size_t)BM * (kp + Pad<T>::value) * sizeof(T);
  const size_t stencil = 2 * (size_t)StencilBuf<T>::BYTES;
  const int stages_a = ring_stages<T>(operand, 0);
  const int stages_b = ring_stages<T>(operand, stencil);
  const size_t smem_a = smem_bytes<T>(operand, 0, stages_a);
  const size_t smem_b = smem_bytes<T>(operand, stencil, stages_b);
  if (smem_a > MAX_SMEM || smem_b > MAX_SMEM) return -1;
  cudaError_t err = cudaFuncSetAttribute(expand_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(project_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_pairs = (long long)m_total * q;
  const dim3 grid_x((unsigned)((n_pairs + THREADS - 1) / THREADS < 132 * 16
                                   ? (n_pairs + THREADS - 1) / THREADS
                                   : 132 * 16));
  const dim3 grid_a((m_total + BM - 1) / BM);
  const dim3 grid_b(batch * tiles_x * tiles_y);
  const T* src_a = a;
  const T* src_b = b;
  for (int i = 0; i < n_blocks; ++i) {
    // ping-pong between the two pairs so that the last block writes out_*
    const bool to_out = ((n_blocks - 1 - i) & 1) == 0;
    T* dst_a = to_out ? out_a : tmp_a;
    T* dst_b = to_out ? out_b : tmp_b;
    interleave_kernel<T><<<grid_x, THREADS, 0, stream>>>(src_a, src_b, dst_a, n_pairs, c, q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    expand_kernel<T><<<grid_a, THREADS, smem_a, stream>>>(
        src_a, src_b, t, w1 + (size_t)i * np * kp, vec + (size_t)i * 6 * np, m_total, c, kp,
        np, stages_a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    project_kernel<T><<<grid_b, THREADS, smem_b, stream>>>(
        t, dst_b, w2 + (size_t)i * np * kp, vec + (size_t)i * 6 * np,
        dwk + (size_t)i * 25 * np, h, w, c, kp, np, tiles_x, tiles_y, stages_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src_a = dst_a;
    src_b = dst_b;
  }
  return 0;
}

}  // namespace

// a, b: the (batch, h, w, c) input pair, contiguous, on the card.  out_*: the
// output pair; tmp_*: a second pair of the same shape (may alias out_* when
// n_blocks == 1); t: (batch * h * w, Kp) scratch.  w1, w2: (n_blocks, Np, Kp);
// vec: (n_blocks, 6, Np); dwk: (n_blocks, 25, Np), as ops/pair_chain.py::pack
// lays them out.  Launches 3 * n_blocks kernels on `stream` without
// synchronizing; returns the first nonzero CUDA error, else 0, or -1 before
// any launch when a CTA's operand (64 pixels x Kp) needs more shared memory
// than a block has (float32 beyond C = 704).
extern "C" int pair_chain_bf16(const void* a, const void* b, void* out_a, void* out_b,
                               void* tmp_a, void* tmp_b, void* t, const void* w1,
                               const void* w2, const float* vec, const float* dwk,
                               int n_blocks, int batch, int h, int w, int c,
                               void* stream) {
  using T = __nv_bfloat16;
  return run_chain<T>(static_cast<const T*>(a), static_cast<const T*>(b),
                      static_cast<T*>(out_a), static_cast<T*>(out_b), static_cast<T*>(tmp_a),
                      static_cast<T*>(tmp_b), static_cast<T*>(t), static_cast<const T*>(w1),
                      static_cast<const T*>(w2), vec, dwk, n_blocks, batch, h, w, c,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int pair_chain_f32(const void* a, const void* b, void* out_a, void* out_b,
                              void* tmp_a, void* tmp_b, void* t, const void* w1,
                              const void* w2, const float* vec, const float* dwk,
                              int n_blocks, int batch, int h, int w, int c, void* stream) {
  using T = float;
  return run_chain<T>(static_cast<const T*>(a), static_cast<const T*>(b),
                      static_cast<T*>(out_a), static_cast<T*>(out_b), static_cast<T*>(tmp_a),
                      static_cast<T*>(tmp_b), static_cast<T*>(t), static_cast<const T*>(w1),
                      static_cast<const T*>(w2), vec, dwk, n_blocks, batch, h, w, c,
                      static_cast<cudaStream_t>(stream));
}

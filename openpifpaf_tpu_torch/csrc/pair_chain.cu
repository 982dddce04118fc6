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
// parallel, so each block is two kernels here, with t (pitch Np) the only
// intermediate in device memory:
//
// - expand_kernel: t, and x1 from the same loads of the pair;
// - project_kernel: the 5x5 stencil of t into u, then v.
//
// What bounds it on this card: sn2k16's three chains at batch 8 are
// 345 GFLOP of tensor-core work against ~510 MB of pair traffic, so the bf16
// rate bounds the two deeper chains and the bytes bound stage 2
// (chip_smoke.py prints the bounds, PERF.md keeps them).  With t going
// through device memory, the pair read and written once per block, the
// floor is about 0.95 ms per served batch of 8.
//
// The bf16 path (the served one).  Each CTA is persistent (one per SM) and
// takes a contiguous run of units (pixel tile, output tile of N = 176 or
// 256 channels); warpgroup 0 is the producer, whose one thread issues every
// load by TMA or bulk copy into rings guarded by full/empty mbarriers, and
// one or two consumer warpgroups of 64 pixels each run wgmma.mma_async
// m64nNk16 (bf16 in, f32 accumulate) with both operands in shared memory,
// K-major in the 128-byte swizzle.  launch_plan in ops/pair_chain.py
// chooses tiles, ring depths, shared memory and grids per width, type and
// image size; the entry points validate its plan.  Against the six limits
// of the earlier mma.sync design:
//
// 1. Weights re-streamed from L2 for every 64 pixels: the weight tiles
//    (64-deep K chunks of the packed (Np, Kp) weights, one TMA tensor-map
//    load each) are read by both consumer groups of a CTA, so 128 pixels
//    share each tile where shared memory allows (stage 2's expand, stages 2
//    and 3's project); elsewhere 64.
// 2. N padded to 128: C is padded to 16; wgmma's N is 176 (sn2k16: 1, 2, 4
//    tiles) or 256 (sn2k30/44), whichever pads least and fits.
// 3. Fringe pixels of 8 x 8 tiles: project tiles are th x tw pixels
//    (tw even) chosen per image for the fewest tiles (7 x 18 at 161, 9 x 14
//    at 81); expand tiles are runs of consecutive pixels.
// 4. mma.sync from ld.shared fragments with a cp.async ring: wgmma from
//    shared memory fed by TMA rings, loads issued by a producer warp that
//    runs ahead of the consumers; the per-channel vectors (epilogue scale
//    and bias, the stencil's taps) sit in shared memory too, since loading
//    them from device memory in the consumers left those waiting on L2.
// 5. A separate interleave kernel: expand_kernel's producer brings each
//    consumer group's pixels of a and b as contiguous slabs (1-D bulk
//    copies, a ring of them), and the consumers write x1 from the slab
//    while placing a[q - o:], b[q - o:] into the swizzled operand, a
//    two-channel word at a time (o = q % 2: starting one channel early
//    where q is odd keeps every word aligned; pack gives the extra columns
//    zero rows in W1).
// 6. Wave quantisation: persistent CTAs split the units evenly.  project
//    computes the stencil once per pixel tile it meets, chunk by chunk
//    (t's haloed tile and the chunk's taps by TMA; coordinates outside the
//    image read as zeros, which is the SAME padding of t: a zero input
//    pixel would not give a zero t, since relu(o1) != 0), overlapping the
//    stencil of chunk k + 1 with the asynchronous wgmma of chunk k; later
//    output tiles of the same pixel tile reuse the resident u.
//
// The f32 path is the parity check (no path serves f32): CUDA-core FMAs, no
// TF32, one CTA of 256 threads per tile keeping its 64 pixels' whole
// operand in shared memory (32 where 64 do not fit, above C = 704) and
// streaming 128-channel weight tiles through a cp.async ring.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90
constexpr int KCHUNK = 64;        // K chunk of the bf16 GEMMs (128 bytes)

// The launch plan, ops/pair_chain.py::LaunchPlan, field for field.
struct Plan {
  int kp, np, n_tile, n_tiles;
  int expand_groups, expand_rows, expand_stages, expand_tiles, expand_grid, expand_smem;
  int project_groups, project_rows, project_stages, tile_h, tile_w, tiles_y, tiles_x;
  int halo_stages, project_tiles, project_grid, project_smem;
  int slab_half, slab_stages;
};
constexpr int PLAN_FIELDS = 23;
static_assert(sizeof(Plan) == PLAN_FIELDS * sizeof(int), "Plan layout");

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// wait for the phase of parity `parity` to complete; a wait of over 10 s
// means a broken pipeline, and traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 1023) {
      if (start == 0)
        start = global_ns();
      else if (global_ns() - start > 10000000000ull)
        __trap();
    }
  }
}
// a 2-D (K, rows) tile of a tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// a contiguous run of bytes (16-byte aligned, a multiple of 16) into shared
// memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// generic-proxy writes to shared memory, made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the 128 threads of consumer warpgroup g (named barrier 1 + g)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row atoms 1024 bytes apart (SBO), the atom 1024-aligned; a
// 16-deep K step inside the row advances the start address by 32 bytes
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t addr = smem_u32(p);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
// the element offset of (row, k) in a block of 64-wide K chunks, each
// `rows` x 128 bytes, 128-byte swizzled (16-byte piece k/8 of a row at
// piece (k/8) ^ (row % 8)), as TMA's SWIZZLE_128B writes and wgmma reads it
__device__ __forceinline__ int sw128_offset(int row, int k, int rows) {
  return (k >> 6) * rows * KCHUNK + row * KCHUNK + ((((k & 63) >> 3) ^ (row & 7)) << 3) +
         (k & 7);
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulate, A and B from shared
// memory (both K-major); d += A B^T, or d = A B^T where scale_d == 0
template <int BN> struct Wgmma;
template <> struct Wgmma<176> {
  static __device__ __forceinline__ void mma(float (&d)[88], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87 "
        "}, %88, %89, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127 "
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// ------------------------------------------------------------- bf16 path
constexpr int TAP_BYTES = 27 * 64 * 4;  // a chunk's 25 taps, sdw and odw (f32)
constexpr int PRODUCER_REGS = 40;   // setmaxnreg of the producer warpgroup
constexpr int CONSUMER_REGS = 232;  // and of the consumers (384 x 168 in all)

// One block's operands and sizes, as the bf16 kernels take them.
struct Bf16Block {
  const __nv_bfloat16* a;  // the input pair, (m_total, c) each
  const __nv_bfloat16* b;
  __nv_bfloat16* x1;       // the output pair's first half
  __nv_bfloat16* t;        // (m_total, np) scratch
  __nv_bfloat16* v;        // the output pair's second half
  const float* vec;        // (6, np): s1, o1, sdw, odw, s2, o2
  const float* dwk;        // (25, np)
  int m_total, h, w, c, kp, np, n_tiles, tiles, stages, halo_stages;
  int tile_h, tile_w, tiles_y, tiles_x, slab_half, slab_stages;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// the contiguous run of units of this persistent CTA
__device__ __forceinline__ void unit_range(int units, int& u0, int& u1) {
  u0 = static_cast<int>(static_cast<long long>(blockIdx.x) * units / gridDim.x);
  u1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * units / gridDim.x);
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// One 64-deep K chunk of a consumer warpgroup's 64 x BN product: four
// wgmma k16 steps on the chunk of the resident operand (64 rows of 128
// bytes at a_chunk) and the weight tile (BN rows of 128 bytes at b_tile),
// committed as one group.  first: overwrite the accumulators.
template <int BN>
__device__ __forceinline__ void mma_chunk(float (&acc)[BN / 2], const __nv_bfloat16* a_chunk,
                                          const unsigned char* b_tile, bool first) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KCHUNK / 16; ++s)
    Wgmma<BN>::mma(acc, sw128_desc(a_chunk + 16 * s), sw128_desc(b_tile + 32 * s),
                   (first && s == 0) ? 0 : 1);
  wgmma_commit();
}

// A consumer warpgroup's copy of an epilogue's scale and bias rows (2 np
// floats from src) into shared memory, so that the epilogue reads them
// from there; both groups write the same values, each before its first
// group_sync.
__device__ __forceinline__ void load_epilogue_vec(float* evec, const float* src, int np) {
  for (int i = threadIdx.x & 127; i < np / 2; i += 128)
    reinterpret_cast<float4*>(evec)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
}

// The expand operand comes from a slab of the group's 64 pixels in shared
// memory: each pixel's channels from s0 on of a, then of b, row pitch
// c - s0.  s0 = 0 (whole rows, one bulk copy each for a and b, x1 taken
// from the slab) or, where a row's second half starts 16-byte aligned and
// whole rows do not fit, s0 = q - o (one bulk copy per row and tensor; x1
// then read from device memory).
__host__ __device__ __forceinline__ int slab_from(const Bf16Block& p) {
  return p.slab_half ? (p.c >> 1) - ((p.c >> 1) & 1) : 0;
}
__host__ __device__ __forceinline__ int slab_buffer_bytes(const Bf16Block& p) {
  return (2 * 64 * 2 * (p.c - slab_from(p)) + 127) & ~127;
}

// wgmma.mma_async m64nNk16 with A from registers (four words a thread, the
// mma.sync m16n8k16 A fragment of the thread's warp) and B from shared
// memory: d += A B^T, or d = A B^T where scale_d == 0
template <int BN> struct WgmmaRS;
template <> struct WgmmaRS<176> {
  static __device__ __forceinline__ void mma(float (&d)[88], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %93, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87 "
        "}, {%88, %89, %90, %91}, %92, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <> struct WgmmaRS<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127 "
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// The A fragments of one 64-deep K chunk of consumer warpgroup g's
// operand [a[q - o:], b[q - o:], zeros to kp], read from the slab into
// registers (four k16 steps of four words: the mma.sync m16n8k16 A fragment
// of the thread's warp): column k holds a[q - o + k] below q + o, then
// b[k - 2 o] below c + 2 o (o = q % 2: every two-channel word is a word of
// the slab); rows past the last pixel are zeros.
__device__ __forceinline__ void load_fragments(uint32_t (&a)[KCHUNK / 16][4],
                                               const uint32_t* slab_a, const uint32_t* slab_b,
                                               const Bf16Block& p, int rows, int k0) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int q = p.c >> 1, o = q & 1, s0 = slab_from(p), pitch = (p.c - s0) >> 1;  // words
  const int r0 = warp * 16 + (lane >> 2), t2 = 2 * (lane & 3);
#pragma unroll
  for (int s = 0; s < KCHUNK / 16; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 8 * (i & 1), k = k0 + 16 * s + t2 + 8 * (i >> 1);
      uint32_t v = 0u;
      if (r < rows) {
        if (k < q + o)
          v = slab_a[r * pitch + ((q - o + k - s0) >> 1)];
        else if (k < p.c + 2 * o)
          v = slab_b[r * pitch + ((k - 2 * o - s0) >> 1)];
      }
      a[s][i] = v;
    }
  }
}

// One chunk's four wgmma k16 steps with A from registers and the weight
// tile from shared memory, committed as one group
template <int BN>
__device__ __forceinline__ void mma_chunk_rs(float (&acc)[BN / 2],
                                             const uint32_t (&a)[KCHUNK / 16][4],
                                             const unsigned char* b_tile, bool first) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KCHUNK / 16; ++s)
    WgmmaRS<BN>::mma(acc, a[s], sw128_desc(b_tile + 32 * s), (first && s == 0) ? 0 : 1);
  wgmma_commit();
}

// x1 = interleave(a[:q], b[:q]) for the group's rows: from the slab where
// it holds whole rows, else from device memory (rows then start 16 bytes
// aligned, c being a multiple of 8), 16 bytes of x1 at a time where they
// fall in one row.
__device__ __forceinline__ void write_x1(const Bf16Block& p, const unsigned char* buf, int m0,
                                         int rows) {
  const int c = p.c, q = c >> 1, tid = threadIdx.x & 127;
  const size_t base = static_cast<size_t>(m0) * c;
  const uint16_t* a16;
  const uint16_t* b16;
  if (p.slab_half) {
    a16 = reinterpret_cast<const uint16_t*>(p.a) + base;
    b16 = reinterpret_cast<const uint16_t*>(p.b) + base;
  } else {
    a16 = reinterpret_cast<const uint16_t*>(buf);
    b16 = reinterpret_cast<const uint16_t*>(buf + 64 * c * 2);
  }
  uint32_t* x1 = reinterpret_cast<uint32_t*>(p.x1 + base);  // word r * q + ch
  const int groups = (q + 3) >> 2;                            // four words per group
  for (int i = tid; i < rows * groups; i += 128) {
    const int r = i / groups, ch = (i - r * groups) * 4;
    const uint16_t* ar = a16 + static_cast<size_t>(r) * c;
    const uint16_t* br = b16 + static_cast<size_t>(r) * c;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = ch + j < q ? ar[ch + j] | (static_cast<uint32_t>(br[ch + j]) << 16) : 0u;
    uint32_t* dst = x1 + static_cast<size_t>(r) * q + ch;
    if (ch + 4 <= q && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int j = 0; j < 4 && ch + j < q; ++j) dst[j] = w[j];
    }
  }
}

// t = relu(s1 * ([a[q - o:], b[q - o:]] @ W1) + o1), x1 = interleave(a[:q], b[:q]).
// Warpgroup 0 is the producer: one thread issues the bulk copies of the
// pair's slabs (a ring of slab_stages per consumer group, so the next
// pixel tile's slab comes in while this one is multiplied) and the weight
// tiles' TMA loads.  Warpgroups 1 .. NWG consume: wgmma with A in registers
// read from the slab.  A unit is (pixel tile of 64 * NWG consecutive
// pixels, output tile of BN channels); x1 is written with the tile's first
// output tile, and the slab is released after the CTA's last unit of the
// tile.
template <int BN, int NWG>
__global__ void __launch_bounds__(384, 1)
expand_kernel(const __grid_constant__ CUtensorMap wmap, const Bf16Block p) {
  constexpr int ROWS = 64 * NWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* ring = smem;
  unsigned char* slab = ring + static_cast<size_t>(p.stages) * BN * 128;
  const int slab_bytes = slab_buffer_bytes(p);
  float* evec = reinterpret_cast<float*>(slab + NWG * p.slab_stages * slab_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(evec + 2 * p.np);
  uint64_t* empty = full + p.stages;
  uint64_t* sfull = empty + p.stages;  // slab ring of group g: [g * slab_stages, ...)
  uint64_t* sempty = sfull + NWG * p.slab_stages;
  const int n_k = p.kp / KCHUNK, s0 = slab_from(p), len = p.c - s0;
  int u0, u1;
  unit_range(p.tiles * p.n_tiles, u0, u1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);  // one arrival per consumer warp
    }
    for (int s = 0; s < NWG * p.slab_stages; ++s) {
      mbar_init(sfull + s, 1);
      mbar_init(sempty + s, 4);  // the warps of one group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int group = threadIdx.x >> 7;
  if (group == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int stage = 0, cur = -1, sst[NWG] = {};
      uint32_t phase = 0, sph[NWG] = {};
      for (int u = u0; u < u1; ++u) {
        const int tile = u / p.n_tiles, n0 = (u - tile * p.n_tiles) * BN;
        if (tile != cur) {  // the slabs of a new pixel tile
          cur = tile;
          for (int g = 0; g < NWG; ++g) {
            const int m = tile * ROWS + g * 64, n = max(0, min(64, p.m_total - m));
            const int s = g * p.slab_stages + sst[g];
            unsigned char* buf = slab + s * slab_bytes;
            mbar_wait(sempty + s, sph[g] ^ 1);
            if (p.slab_half) {  // a row each, 16-byte aligned by the plan
              mbar_expect_tx(sfull + s, 4u * n * len);
              for (int r = 0; r < n; ++r) {
                const size_t e = static_cast<size_t>(m + r) * p.c + s0;
                bulk_load(buf + r * len * 2, p.a + e, len * 2, sfull + s);
                bulk_load(buf + (64 + r) * len * 2, p.b + e, len * 2, sfull + s);
              }
            } else {  // the run of whole rows, but its last bytes past 16
              const uint32_t bytes = (static_cast<uint32_t>(n) * p.c * 2) & ~15u;
              mbar_expect_tx(sfull + s, 2 * bytes);
              if (bytes) {
                const size_t e = static_cast<size_t>(m) * p.c;
                bulk_load(buf, p.a + e, bytes, sfull + s);
                bulk_load(buf + 64 * p.c * 2, p.b + e, bytes, sfull + s);
              }
            }
            advance(sst[g], sph[g], p.slab_stages);
          }
        }
        for (int k = 0; k < n_k; ++k) {
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect_tx(full + stage, BN * 128);
          tma_load_2d(ring + stage * BN * 128, &wmap, full + stage, k * KCHUNK, n0);
          advance(stage, phase, p.stages);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int g = group - 1, tid = threadIdx.x & 127, lane = tid & 31;
    load_epilogue_vec(evec, p.vec, p.np);  // s1, o1
    float acc[BN / 2];
    int stage = 0, sst = 0;
    uint32_t phase = 0, sph = 0;
    for (int u = u0; u < u1; ++u) {
      const int tile = u / p.n_tiles, nt = u - tile * p.n_tiles;
      const int m0 = tile * ROWS + g * 64;
      const int rows = max(0, min(64, p.m_total - m0));
      const bool fresh = u == u0 || nt == 0;
      const bool last = u + 1 == u1 || nt + 1 == p.n_tiles;
      unsigned char* buf = slab + (g * p.slab_stages + sst) * slab_bytes;
      if (fresh) {
        mbar_wait(sfull + g * p.slab_stages + sst, sph);
        if (!p.slab_half) {  // the last pixels' bytes the bulk copies left out
          const int done = ((rows * p.c * 2) & ~15) >> 1;
          uint16_t* sa = reinterpret_cast<uint16_t*>(buf);
          const size_t e0 = static_cast<size_t>(m0) * p.c;
          const uint16_t* ga = reinterpret_cast<const uint16_t*>(p.a) + e0;
          const uint16_t* gb = reinterpret_cast<const uint16_t*>(p.b) + e0;
          for (int e = done + tid; e < rows * p.c; e += 128) {
            sa[e] = ga[e];
            sa[64 * p.c + e] = gb[e];
          }
          group_sync(g);
        }
        if (nt == 0) write_x1(p, buf, m0, rows);
      }
      const uint32_t* slab_a = reinterpret_cast<const uint32_t*>(buf);
      const uint32_t* slab_b = reinterpret_cast<const uint32_t*>(buf + 64 * len * 2);
      // two sets of A fragments: chunk k + 1's are read from the slab while
      // chunk k's wgmma runs
      uint32_t fa[KCHUNK / 16][4], fb[KCHUNK / 16][4];
      int prev = -1;
      const auto step = [&](const uint32_t (&f)[KCHUNK / 16][4], uint32_t (&next)[KCHUNK / 16][4],
                            int k) {
        mbar_wait(full + stage, phase);
        mma_chunk_rs<BN>(acc, f, ring + stage * BN * 128, k == 0);
        wgmma_wait<1>();  // chunk k - 1 is done: its fragments and weight tile are free
        if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
        prev = stage;
        advance(stage, phase, p.stages);
        if (k + 1 < n_k) load_fragments(next, slab_a, slab_b, p, rows, (k + 1) * KCHUNK);
      };
      load_fragments(fa, slab_a, slab_b, p, rows, 0);
      for (int k = 0; k < n_k; k += 2) {
        step(fa, fb, k);
        if (k + 1 < n_k) step(fb, fa, k + 1);
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + prev);
      fence_operands(acc);
      if (last) {  // the slab's last reader in this CTA
        fence_proxy_async();  // the tail written above, before the next bulk copy
        __syncwarp();
        if (lane == 0) mbar_arrive(sempty + g * p.slab_stages + sst);
        advance(sst, sph, p.slab_stages);
      }
      // epilogue: rows r0 and r0 + 8 of this warp.  A thread holds channel
      // pairs 8 j + 2 (lane % 4); the four lanes of a quad trade them so that
      // each holds 8 consecutive channels of a row (t's rows are 16-byte
      // aligned): one 16-byte store instead of four 4-byte ones
      const int r0 = (tid >> 5) * 16 + (lane >> 2), t4 = lane & 3;
      const auto relu2 = [&](int j, int i) {
        const int n = nt * BN + 8 * j + 2 * t4;
        const float2 sc = *reinterpret_cast<const float2*>(evec + n);
        const float2 bi = *reinterpret_cast<const float2*>(evec + p.np + n);
        const __nv_bfloat162 y =
            __floats2bfloat162_rn(fmaxf(fmaf(sc.x, acc[4 * j + i], bi.x), 0.f),
                                  fmaxf(fmaf(sc.y, acc[4 * j + i + 1], bi.y), 0.f));
        return *reinterpret_cast<const uint32_t*>(&y);
      };
      const auto pick = [](const uint32_t (&v)[4], int i) {
        return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
      };
#pragma unroll
      for (int j0 = 0; j0 + 4 <= BN / 8; j0 += 4) {
        const int n = nt * BN + 8 * (j0 + t4);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t v[4], got[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            v[jj] = nt * BN + 8 * (j0 + jj) < p.np ? relu2(j0 + jj, 2 * half) : 0u;
#pragma unroll
          for (int r = 0; r < 4; ++r)  // round r: lane t4 gets pair (t4 - r) % 4 of block j0 + t4
            got[r] = __shfl_sync(0xffffffffu, pick(v, (t4 + r) & 3),
                                 (lane & ~3) | ((t4 - r) & 3));
          const int row = r0 + 8 * half;
          if (row < rows && n < p.np)
            *reinterpret_cast<uint4*>(p.t + static_cast<size_t>(m0 + row) * p.np + n) =
                make_uint4(pick(got, t4), pick(got, (t4 + 3) & 3), pick(got, (t4 + 2) & 3),
                           pick(got, (t4 + 1) & 3));
        }
      }
#pragma unroll
      for (int j = BN / 8 / 4 * 4; j < BN / 8; ++j) {  // the last j-blocks, 4 bytes a store
        const int n = nt * BN + 8 * j + 2 * t4;
        if (n < p.np) {
          if (r0 < rows)
            *reinterpret_cast<uint32_t*>(p.t + static_cast<size_t>(m0 + r0) * p.np + n) =
                relu2(j, 0);
          if (r0 + 8 < rows)
            *reinterpret_cast<uint32_t*>(p.t + static_cast<size_t>(m0 + r0 + 8) * p.np + n) =
                relu2(j, 2);
        }
      }
    }
  }
}

// u for channels k * 64 .. + 64 of consumer warpgroup g's 64 tile rows,
// from t's haloed tile (the TMA box: (tile_h + 4) x (tile_w + 4) positions
// of 64 channels, 128 bytes each; behind it the chunk's 25 taps, sdw and
// odw as 27 rows of 64 floats) into operand chunk k.  Each thread takes
// one channel pair and 16 consecutive rows, two neighbouring pixels of a
// tile row at a time (6 x 5 positions of t read for their 2 x 25 taps),
// and accumulates in bf16x2 FMAs, as the plain version rounds each step to
// bf16 (one chain per window row, then their sum); rows outside the tile
// or the image and channels >= c get exact zeros.
template <int ROWS>
__device__ __forceinline__ void stencil_chunk(uint16_t* Us, int g, const unsigned char* halo,
                                              const Bf16Block& p, int k, int y0, int x0) {
  const int tid = threadIdx.x & 127, cp = tid & 31;
  const int ch = k * KCHUNK + 2 * cp, hw = p.tile_w + 4, n_rows = p.tile_h * p.tile_w;
  const bool live = ch < p.c;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  // the chunk's taps, then sdw and odw, 64 floats a row, behind t's box
  const float2* taps = reinterpret_cast<const float2*>(halo + 128 * hw * (p.tile_h + 4)) + cp;
  __nv_bfloat162 wt[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) wt[i] = __float22bfloat162_rn(taps[32 * i]);
  const __nv_bfloat162 sd = __float22bfloat162_rn(taps[32 * 25]);
  const __nv_bfloat162 od = __float22bfloat162_rn(taps[32 * 26]);
  const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(halo) + cp;
  const int r0 = g * 64 + (tid >> 5) * 16;  // even, and tile_w is even: pairs share a row
  int ty = r0 / p.tile_w, tx = r0 - ty * p.tile_w;
#pragma unroll
  for (int i = 0; i < 16; i += 2) {
    const int r = r0 + i;
    __nv_bfloat162 u0 = zero, u1 = zero;
    if (live && r < n_rows && y0 + ty < p.h && x0 + tx < p.w) {
      const __nv_bfloat162* src = hv + (ty * hw + tx) * 32;
      __nv_bfloat162 s0[5], s1[5];  // one chain per window row and pixel, for ILP
#pragma unroll
      for (int dy = 0; dy < 5; ++dy) {
        __nv_bfloat162 v[6];
#pragma unroll
        for (int dx = 0; dx < 6; ++dx) v[dx] = src[(dy * hw + dx) * 32];
        s0[dy] = __hmul2(v[0], wt[dy * 5]);
        s1[dy] = __hmul2(v[1], wt[dy * 5]);
#pragma unroll
        for (int dx = 1; dx < 5; ++dx) {
          s0[dy] = __hfma2(v[dx], wt[dy * 5 + dx], s0[dy]);
          s1[dy] = __hfma2(v[dx + 1], wt[dy * 5 + dx], s1[dy]);
        }
      }
      u0 = __hfma2(__hadd2(__hadd2(s0[0], s0[1]), __hadd2(__hadd2(s0[2], s0[3]), s0[4])), sd, od);
      if (x0 + tx + 1 < p.w)
        u1 = __hfma2(__hadd2(__hadd2(s1[0], s1[1]), __hadd2(__hadd2(s1[2], s1[3]), s1[4])), sd,
                     od);
    }
    __nv_bfloat16* us = reinterpret_cast<__nv_bfloat16*>(Us);
    *reinterpret_cast<__nv_bfloat162*>(us + sw128_offset(r, ch, ROWS)) = u0;
    *reinterpret_cast<__nv_bfloat162*>(us + sw128_offset(r + 1, ch, ROWS)) = u1;
    tx += 2;
    if (tx == p.tile_w) {
      tx = 0;
      ++ty;
    }
  }
}

// v = relu(s2 * ((sdw * dw5x5(t) + odw) @ W2) + o2).  A unit is (tile of
// tile_h x tile_w pixels of one image, output tile of BN channels).  For
// each pixel tile the CTA meets, the producer brings t's haloed tile chunk
// by chunk (4-D TMA; coordinates outside the image read as zeros, t's SAME
// padding) and the consumers compute the stencil of chunk k while the
// wgmma of chunk k - 1 runs; later output tiles of the same pixel tile
// reuse the resident u.
template <int BN, int NWG>
__global__ void __launch_bounds__(384, 1)
project_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap tmap,
               const __grid_constant__ CUtensorMap dmap, const __grid_constant__ CUtensorMap vmap,
               const Bf16Block p) {
  constexpr int ROWS = 64 * NWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint16_t* Us = reinterpret_cast<uint16_t*>(smem);
  const uint32_t box_bytes = 128u * (p.tile_h + 4) * (p.tile_w + 4);
  const uint32_t halo_tx = box_bytes + TAP_BYTES;
  const int halo_bytes = (halo_tx + 1023) & ~1023;
  unsigned char* halo = smem + static_cast<size_t>(ROWS) * p.kp * 2;
  unsigned char* ring = halo + static_cast<size_t>(p.halo_stages) * halo_bytes;
  float* evec = reinterpret_cast<float*>(ring + static_cast<size_t>(p.stages) * BN * 128);
  uint64_t* full = reinterpret_cast<uint64_t*>(evec + 2 * p.np);
  uint64_t* empty = full + p.stages;
  uint64_t* hfull = empty + p.stages;
  uint64_t* hempty = hfull + p.halo_stages;
  const int n_k = p.kp / KCHUNK;
  int u0, u1;
  unit_range(p.tiles * p.n_tiles, u0, u1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);
    }
    for (int s = 0; s < p.halo_stages; ++s) {
      mbar_init(hfull + s, 1);
      mbar_init(hempty + s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int group = threadIdx.x >> 7;
  if (group == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int stage = 0, hstage = 0, cur = -1;
      uint32_t phase = 0, hphase = 0;
      for (int u = u0; u < u1; ++u) {
        const int tile = u / p.n_tiles, nt = u - tile * p.n_tiles;
        const bool fresh = tile != cur;
        cur = tile;
        const int tx = tile % p.tiles_x, ty = (tile / p.tiles_x) % p.tiles_y;
        const int img = tile / (p.tiles_x * p.tiles_y);
        for (int k = 0; k < n_k; ++k) {
          if (fresh) {
            mbar_wait(hempty + hstage, hphase ^ 1);
            mbar_expect_tx(hfull + hstage, halo_tx);
            unsigned char* dst = halo + hstage * halo_bytes;
            tma_load_4d(dst, &tmap, hfull + hstage, k * KCHUNK, tx * p.tile_w - 2,
                        ty * p.tile_h - 2, img);
            tma_load_2d(dst + box_bytes, &dmap, hfull + hstage, k * KCHUNK, 0);
            tma_load_2d(dst + box_bytes + 25 * 256, &vmap, hfull + hstage, k * KCHUNK, 2);
            advance(hstage, hphase, p.halo_stages);
          }
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect_tx(full + stage, BN * 128);
          tma_load_2d(ring + stage * BN * 128, &wmap, full + stage, k * KCHUNK, nt * BN);
          advance(stage, phase, p.stages);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int g = group - 1, tid = threadIdx.x & 127, lane = tid & 31;
    load_epilogue_vec(evec, p.vec + 4 * p.np, p.np);  // s2, o2
    const __nv_bfloat16* u_rows = reinterpret_cast<const __nv_bfloat16*>(Us) + g * 64 * KCHUNK;
    float acc[BN / 2];
    int cur = -1, stage = 0, hstage = 0;
    uint32_t phase = 0, hphase = 0;
    for (int u = u0; u < u1; ++u) {
      const int tile = u / p.n_tiles, nt = u - tile * p.n_tiles;
      const bool fresh = tile != cur;
      cur = tile;
      const int tx = tile % p.tiles_x, ty = (tile / p.tiles_x) % p.tiles_y;
      const int img = tile / (p.tiles_x * p.tiles_y);
      const int y0 = ty * p.tile_h, x0 = tx * p.tile_w;
      int prev = 0;
      for (int k = 0; k < n_k; ++k) {
        if (fresh) {
          mbar_wait(hfull + hstage, hphase);
          stencil_chunk<ROWS>(Us, g, halo + hstage * halo_bytes, p, k, y0, x0);
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(hempty + hstage);
          advance(hstage, hphase, p.halo_stages);
          group_sync(g);
        }
        mbar_wait(full + stage, phase);
        mma_chunk<BN>(acc, u_rows + k * ROWS * KCHUNK, ring + stage * BN * 128, k == 0);
        if (k > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + prev);
        }
        prev = stage;
        advance(stage, phase, p.stages);
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty + prev);
      const int r0 = g * 64 + (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        const int y = y0 + r / p.tile_w, x = x0 + r % p.tile_w;
        if (r >= p.tile_h * p.tile_w || y >= p.h || x >= p.w) continue;
        __nv_bfloat16* dst = p.v + ((static_cast<size_t>(img) * p.h + y) * p.w + x) * p.c;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = nt * BN + 8 * j + 2 * (lane & 3);
          if (n < p.c) {
            const float2 s = *reinterpret_cast<const float2*>(evec + n);
            const float2 o = *reinterpret_cast<const float2*>(evec + p.np + n);
            store_bf16x2(dst + n, fmaxf(fmaf(s.x, acc[4 * j + 2 * half], o.x), 0.f),
                         fmaxf(fmaf(s.y, acc[4 * j + 2 * half + 1], o.y), 0.f));
          }
        }
      }
    }
  }
}

// -------------------------------------------------------------- f32 path
constexpr int F32_THREADS = 256;
constexpr int F32_WARPS = F32_THREADS / 32;
constexpr int F32_BN = 128;    // output channels of a weight tile
constexpr int F32_DEPTH = 32;  // reduction depth of a weight tile
constexpr int F32_LDB = 36;    // its row pitch (16 bytes of padding)
constexpr int F32_SD = 16;     // channels of a stencil chunk
constexpr int F32_LDT = 20;
constexpr int F32_TH = 8;      // project tile: 8 x BM / 8 pixels

// 16-byte cp.async; src_bytes == 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}
// one float; valid == false fills a zero
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The CTA's BM x 128 product of one K chunk: each thread BM / 16 pixels x
// 4 pairs of channels (pairs 32 apart), acc[BM / 2].  Pair e of a thread:
// row (tid / 16) * R + e / 4, first channel col(e % 4), acc index idx.
template <int BM> struct F32Tile {
  static constexpr int R = BM / 16;
  static __device__ __forceinline__ void product(const float* As, int lda, const float* Bs,
                                                 float (&acc)[BM / 2]) {
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
    for (int k = 0; k < F32_DEPTH; ++k) {
      float av[R], bv[8];
#pragma unroll
      for (int i = 0; i < R; ++i) av[i] = As[(tr * R + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[(2 * tc + 32 * (j >> 1) + (j & 1)) * F32_LDB + k];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
    }
  }
  static __device__ __forceinline__ int col(int j) { return 2 * (threadIdx.x & 15) + 32 * j; }
  static __device__ __forceinline__ void pair(int e, int& row, int& j, int& idx) {
    j = e & 3;
    row = (threadIdx.x >> 4) * R + (e >> 2);
    idx = (e >> 2) * 8 + 2 * j;
  }
};

// Bs[n][k] = W[n0 + n][k0 + k] from the (np, kp) weights, zeros past np
__device__ __forceinline__ void load_weights_f32(float* Bs, const float* __restrict__ W, int kp,
                                                 int np, int n0, int k0) {
  constexpr int PER_ROW = F32_DEPTH / 4;
  for (int i = threadIdx.x; i < F32_BN * PER_ROW; i += F32_THREADS) {
    const int n = i / PER_ROW, kc = (i - n * PER_ROW) * 4;
    const bool valid = n0 + n < np;
    cp_async16(Bs + n * F32_LDB + kc, valid ? W + (size_t)(n0 + n) * kp + k0 + kc : W,
               valid ? 16 : 0);
  }
}

// The resident operand As (BM x kp, pitch lda) times every 128-column tile
// of W^T, the weight tiles streamed through a ring of `stages` buffers at
// Bbuf; each finished tile goes through y = relu(scale * acc + bias) and
// store(row, col, f0, f1) for output channels col, col + 1 (< np).
template <int BM, typename Store>
__device__ __forceinline__ void gemm_f32(const float* As, int lda, float* Bbuf,
                                         const float* __restrict__ W, int kp, int np, int stages,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias, Store store) {
  constexpr int TILE = F32_BN * F32_LDB, NP = BM / 4;  // pairs a thread stores
  const int n_k = kp / F32_DEPTH, n_it = (np + F32_BN - 1) / F32_BN * n_k;
  float acc[BM / 2];
  float2 sv[4], bv[4];
#pragma unroll
  for (int e = 0; e < BM / 2; ++e) acc[e] = 0.f;
  for (int it = 0; it < stages - 1; ++it) {
    if (it < n_it) {
      const int nt = it / n_k;
      load_weights_f32(Bbuf + it * TILE, W, kp, np, nt * F32_BN, (it - nt * n_k) * F32_DEPTH);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    const int nt = it / n_k, kc = it - nt * n_k;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nt * F32_BN + F32Tile<BM>::col(j);
        const bool in = n < np;
        sv[j] = in ? *reinterpret_cast<const float2*>(scale + n) : make_float2(0.f, 0.f);
        bv[j] = in ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
      }
    }
    const int ahead = it + stages - 1;
    if (ahead < n_it) {
      const int nt1 = ahead / n_k;
      load_weights_f32(Bbuf + (ahead % stages) * TILE, W, kp, np, nt1 * F32_BN,
                       (ahead - nt1 * n_k) * F32_DEPTH);
    }
    cp_async_commit();
    if (stages == 3)
      cp_async_wait<2>();
    else
      cp_async_wait<1>();
    __syncthreads();
    F32Tile<BM>::product(As + kc * F32_DEPTH, lda, Bbuf + (it % stages) * TILE, acc);
    if (kc == n_k - 1) {
#pragma unroll
      for (int e = 0; e < NP; ++e) {
        int row, j, idx;
        F32Tile<BM>::pair(e, row, j, idx);
        const int n = nt * F32_BN + F32Tile<BM>::col(j);
        if (n < np)
          store(row, n, fmaxf(fmaf(sv[j].x, acc[idx], bv[j].x), 0.f),
                fmaxf(fmaf(sv[j].y, acc[idx + 1], bv[j].y), 0.f));
      }
#pragma unroll
      for (int e = 0; e < BM / 2; ++e) acc[e] = 0.f;
    }
    __syncthreads();
  }
}

// t and x1 for BM consecutive pixels: the operand row is [a[q - o:],
// b[q - o:]] with o = q % 2, then zeros (pack's layout), copied a float at
// a time; x1 = interleave(a[:q], b[:q]) is copied alongside.
template <int BM>
__global__ void __launch_bounds__(F32_THREADS, 2)
expand_f32(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ x1,
           float* __restrict__ t, const float* __restrict__ w1, const float* __restrict__ vec,
           int m_total, int c, int kp, int np, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = kp + 4;
  float* As = reinterpret_cast<float*>(smem);
  float* Bbuf = As + BM * lda;
  const int m0 = blockIdx.x * BM, q = c >> 1, o = q & 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = min(BM, m_total - m0);
  for (int r = warp; r < BM; r += F32_WARPS) {
    const bool valid = r < rows;
    const size_t row = (size_t)(m0 + (valid ? r : 0)) * c;
    for (int j = lane; j < kp; j += 32) {
      const float* src =
          j < q + o ? a + row + q - o + j : (j < c + 2 * o ? b + row + j - 2 * o : a);
      cp_async4(As + r * lda + j, src, valid && j < c + 2 * o);
    }
  }
  cp_async_commit();
  for (int r = warp; r < rows; r += F32_WARPS) {
    const size_t row = (size_t)(m0 + r) * c;
    for (int i = lane; i < q; i += 32)
      *reinterpret_cast<float2*>(x1 + row + 2 * i) = make_float2(a[row + i], b[row + i]);
  }
  gemm_f32<BM>(As, lda, Bbuf, w1, kp, np, stages, vec, vec + np,
               [&](int row, int n, float f0, float f1) {
                 const int m = m0 + row;
                 if (m < m_total)
                   *reinterpret_cast<float2*>(t + (size_t)m * np + n) = make_float2(f0, f1);
               });
}

// Shared memory of project_f32's first phase, one of two buffers: t for the
// tile and its halo, the chunk's 25 taps and its sdw, odw.
template <int TW> struct F32StencilBuf {
  static constexpr int T_BYTES = (F32_TH + 4) * (TW + 4) * F32_LDT * 4;
  static constexpr int W_BYTES = 25 * F32_SD * 4;
  static constexpr int BYTES = T_BYTES + W_BYTES + 2 * F32_SD * 4;
};

template <int TW>
__device__ __forceinline__ void load_stencil_f32(unsigned char* buf, const float* __restrict__ t,
                                                 const float* __restrict__ dwk,
                                                 const float* __restrict__ sdw_odw, int img,
                                                 int y0, int x0, int h, int w, int np, int k0) {
  using S = F32StencilBuf<TW>;
  constexpr int HW = TW + 4, PER_POS = F32_SD / 4;
  float* ts = reinterpret_cast<float*>(buf);
  float* ws = reinterpret_cast<float*>(buf + S::T_BYTES);
  float* so = reinterpret_cast<float*>(buf + S::T_BYTES + S::W_BYTES);
  const bool in_np = k0 < np;  // np is a multiple of 16: a chunk is all in or all out
  for (int i = threadIdx.x; i < (F32_TH + 4) * HW * PER_POS; i += F32_THREADS) {
    const int pos = i / PER_POS, kc = (i - pos * PER_POS) * 4;
    const int yy = y0 - 2 + pos / HW, xx = x0 - 2 + pos % HW;
    const bool inside = in_np && yy >= 0 && yy < h && xx >= 0 && xx < w;
    const float* src = inside ? t + (((size_t)img * h + yy) * w + xx) * np + k0 + kc : t;
    cp_async16(ts + pos * F32_LDT + kc, src, inside ? 16 : 0);
  }
  for (int i = threadIdx.x; i < 27 * PER_POS; i += F32_THREADS) {
    const int row = i / PER_POS, kc = (i - row * PER_POS) * 4;
    if (row < 25)
      cp_async16(ws + row * F32_SD + kc, in_np ? dwk + (size_t)row * np + k0 + kc : dwk,
                 in_np ? 16 : 0);
    else  // rows 25, 26: sdw, odw (vec rows 2, 3)
      cp_async16(so + (row - 25) * F32_SD + kc,
                 in_np ? sdw_odw + (size_t)(row - 25) * np + k0 + kc : sdw_odw, in_np ? 16 : 0);
  }
}

// v = relu(s2 * ((sdw * dw5x5(t) + odw) @ W2) + o2) for one 8 x BM / 8 tile
template <int BM>
__global__ void __launch_bounds__(F32_THREADS, 2)
project_f32(const float* __restrict__ t, float* __restrict__ v, const float* __restrict__ w2,
            const float* __restrict__ vec, const float* __restrict__ dwk, int h, int w, int c,
            int kp, int np, int tiles_x, int tiles_y, int stages) {
  constexpr int TW = BM / F32_TH, HW = TW + 4;
  using S = F32StencilBuf<TW>;
  constexpr int GROUPS = F32_THREADS / (F32_SD * TW);  // row groups of the stencil
  constexpr int ROWS = F32_TH / GROUPS;                // output rows per thread
  static_assert(GROUPS * ROWS == F32_TH, "stencil thread map");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = kp + 4;
  float* Us = reinterpret_cast<float*>(smem);
  unsigned char* work = smem + (size_t)BM * lda * 4;

  int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int img = tile / tiles_y;
  const int y0 = ty * F32_TH, x0 = tx * TW;
  const int cc = threadIdx.x % F32_SD;
  const int px = (threadIdx.x / F32_SD) % TW;
  const int rg = threadIdx.x / (F32_SD * TW);

  // phase 1: u for the tile's pixels and all kp channels, into Us
  const int n_k = kp / F32_SD;
  load_stencil_f32<TW>(work, t, dwk, vec + 2 * np, img, y0, x0, h, w, np, 0);
  cp_async_commit();
  for (int kc = 0; kc < n_k; ++kc) {
    if (kc + 1 < n_k)
      load_stencil_f32<TW>(work + ((kc + 1) & 1) * S::BYTES, t, dwk, vec + 2 * np, img, y0, x0,
                           h, w, np, (kc + 1) * F32_SD);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* buf = work + (kc & 1) * S::BYTES;
    const float* ts = reinterpret_cast<const float*>(buf);
    const float* ws = reinterpret_cast<const float*>(buf + S::T_BYTES);
    const float* so = reinterpret_cast<const float*>(buf + S::T_BYTES + S::W_BYTES);
    float wr[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) wr[i] = ws[i * F32_SD + cc];
    float u[ROWS];
#pragma unroll
    for (int oy = 0; oy < ROWS; ++oy) u[oy] = 0.f;
#pragma unroll
    for (int hy = 0; hy < ROWS + 4; ++hy) {
      const float* src = ts + ((rg * ROWS + hy) * HW + px) * F32_LDT + cc;
      float tv[5];
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) tv[dx] = src[dx * F32_LDT];
#pragma unroll
      for (int oy = 0; oy < ROWS; ++oy) {
        const int dy = hy - oy;
        if (dy >= 0 && dy < 5) {
#pragma unroll
          for (int dx = 0; dx < 5; ++dx) u[oy] = fmaf(tv[dx], wr[dy * 5 + dx], u[oy]);
        }
      }
    }
    const float sdw = so[cc], odw = so[F32_SD + cc];
#pragma unroll
    for (int oy = 0; oy < ROWS; ++oy)
      Us[((rg * ROWS + oy) * TW + px) * lda + kc * F32_SD + cc] = fmaf(u[oy], sdw, odw);
    __syncthreads();
  }

  // phase 2: Us @ W2, the weight tiles streamed through the same buffers
  gemm_f32<BM>(Us, lda, reinterpret_cast<float*>(work), w2, kp, np, stages, vec + 4 * np,
               vec + 5 * np, [&](int row, int n, float f0, float f1) {
                 const int y = y0 + row / TW, x = x0 + row % TW;
                 if (y < h && x < w && n < c)
                   *reinterpret_cast<float2*>(v + (((size_t)img * h + y) * w + x) * c + n) =
                       make_float2(f0, f1);
               });
}

// ------------------------------------------------------------------ host
// bytes: 1 KB to align the base, the weight ring, the epilogue's scale and
// bias, the barriers; then the expand kernel's slab rings or the project
// kernel's resident operand and halo ring (ops/pair_chain.py, the same)
int bf16_common_smem(int np, int n_tile, int stages) {
  return 1024 + stages * n_tile * 128 + 8 * np + 256;
}
int bf16_expand_smem(int groups, int np, int n_tile, int stages, int c, int slab_half,
                     int slab_stages) {
  const int q = c / 2, s0 = slab_half ? q - (q & 1) : 0;
  return bf16_common_smem(np, n_tile, stages) +
         groups * slab_stages * round_up(256 * (c - s0), 128);
}
int bf16_project_smem(int groups, int kp, int np, int n_tile, int stages, int th, int tw,
                      int hs) {
  return bf16_common_smem(np, n_tile, stages) + 128 * groups * kp +
         hs * round_up(128 * (th + 4) * (tw + 4) + TAP_BYTES, 1024);
}
int f32_smem(int rows, int kp, int stages, int tile_w) {
  const int ring = stages * F32_BN * F32_LDB * 4;
  const int stencil =
      tile_w ? 2 * ((F32_TH + 4) * (tile_w + 4) * F32_LDT * 4 + 25 * F32_SD * 4 + 2 * F32_SD * 4)
             : 0;
  return rows * (kp + 4) * 4 + (ring > stencil ? ring : stencil);
}

// The plan against the shapes: every field the kernels rely on.
bool plan_fits(const Plan& p, bool bf16, int batch, int h, int w, int c) {
  const long long m = (long long)batch * h * w;
  bool ok = p.kp == round_up(c + 2 * ((c / 2) & 1), KCHUNK) && p.np == round_up(c, 16) &&
            p.n_tiles == (p.np + p.n_tile - 1) / p.n_tile && p.tile_h > 0 && p.tile_w > 0 &&
            p.tile_h * p.tile_w <= p.project_rows && (long long)p.tiles_y * p.tile_h >= h &&
            (long long)p.tiles_x * p.tile_w >= w && p.tiles_y == (h + p.tile_h - 1) / p.tile_h &&
            p.tiles_x == (w + p.tile_w - 1) / p.tile_w &&
            p.project_tiles == batch * p.tiles_y * p.tiles_x &&
            (long long)p.expand_tiles * p.expand_rows >= m &&
            (long long)(p.expand_tiles - 1) * p.expand_rows < m && p.expand_smem <= MAX_SMEM &&
            p.project_smem <= MAX_SMEM;
  if (!ok) return false;
  if (bf16)
    return (p.n_tile == 176 || p.n_tile == 256) && (p.expand_groups == 1 || p.expand_groups == 2) &&
           (p.project_groups == 1 || p.project_groups == 2) &&
           p.expand_rows == 64 * p.expand_groups && p.project_rows == 64 * p.project_groups &&
           p.expand_stages >= 2 && p.expand_stages <= 4 && p.project_stages >= 2 &&
           p.project_stages <= 4 && p.halo_stages >= 1 && p.halo_stages <= 4 &&
           p.tile_h + 4 <= 256 && p.tile_w + 4 <= 256 && p.tile_w % 2 == 0 &&
           p.expand_grid >= 1 && p.expand_grid <= p.expand_tiles * p.n_tiles &&
           p.project_grid >= 1 && p.project_grid <= p.project_tiles * p.n_tiles &&
           (p.slab_half == 0 ||
            (p.slab_half == 1 && (c / 2 - ((c / 2) & 1)) % 8 == 0 && c % 8 == 0)) &&
           (p.slab_stages == 1 || p.slab_stages == 2) &&
           p.expand_smem == bf16_expand_smem(p.expand_groups, p.np, p.n_tile, p.expand_stages, c,
                                             p.slab_half, p.slab_stages) &&
           p.project_smem == bf16_project_smem(p.project_groups, p.kp, p.np, p.n_tile,
                                               p.project_stages, p.tile_h, p.tile_w,
                                               p.halo_stages);
  return p.n_tile == F32_BN && (p.expand_rows == 64 || p.expand_rows == 32) &&
         p.project_rows == p.expand_rows && p.tile_h == F32_TH &&
         p.tile_w == p.expand_rows / F32_TH && p.expand_stages >= 2 && p.expand_stages <= 3 &&
         p.project_stages >= 2 && p.project_stages <= 3 && p.expand_grid == p.expand_tiles &&
         p.project_grid == p.project_tiles &&
         p.expand_smem == f32_smem(p.expand_rows, p.kp, p.expand_stages, 0) &&
         p.project_smem == f32_smem(p.project_rows, p.kp, p.project_stages, p.tile_w);
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (rows, kp) bf16 weights, boxes of 64 x box_rows, 128-byte swizzled
bool weight_map(CUtensorMap* map, const void* w, int kp, int rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kp * 2};
  const cuuint32_t box[2] = {KCHUNK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides,
                   box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// rows x np float32 (taps or folded vectors), boxes of 64 x box_rows
bool f32_map(CUtensorMap* map, const float* x, int np, int rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)np, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)np * 4};
  const cuuint32_t box[2] = {KCHUNK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, strides,
                   box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_NONE,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// t as (batch, h, w, np), boxes of 64 channels x (tw + 4) x (th + 4) x 1;
// coordinates outside read as zeros
bool halo_map(CUtensorMap* map, const void* t, int batch, int h, int w, int np, int th, int tw) {
  const cuuint64_t dims[4] = {(cuuint64_t)np, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)np * 2, (cuuint64_t)w * np * 2,
                                 (cuuint64_t)h * w * np * 2};
  const cuuint32_t box[4] = {KCHUNK, (cuuint32_t)(tw + 4), (cuuint32_t)(th + 4), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t), dims, strides,
                   box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A parameter tensor's map (bf16 weights or f32 taps and vectors, told
// apart by their width in elements), encoded once per address and shape:
// a model's packed chains keep their tensors, and encoding a map costs
// host time on every call otherwise.
template <typename T>
const CUtensorMap* cached_map(const T* x, int inner, int rows, int box_rows) {
  struct Entry {
    const void* ptr;
    int inner, rows, box_rows;
    CUtensorMap map;
  };
  static std::deque<Entry> cache;  // stable addresses as it grows
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (const Entry& e : cache)
    if (e.ptr == x && e.inner == inner && e.rows == rows && e.box_rows == box_rows) return &e.map;
  Entry e{x, inner, rows, box_rows, {}};
  const bool ok = sizeof(T) == 2 ? weight_map(&e.map, x, inner, rows, box_rows)
                                 : f32_map(&e.map, reinterpret_cast<const float*>(x), inner, rows,
                                           box_rows);
  if (!ok) return nullptr;
  cache.push_back(e);
  return &cache.back().map;
}

// a kernel's dynamic shared memory limit raised to a block's maximum, once
template <typename Fn>
cudaError_t allow_max_smem(Fn fn) {
  static std::vector<const void*> done;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (const void* f : done)
    if (f == reinterpret_cast<const void*>(fn)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess) done.push_back(reinterpret_cast<const void*>(fn));
  return err;
}

using ExpandFn = void (*)(CUtensorMap, Bf16Block);
using ProjectFn = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, Bf16Block);

ExpandFn expand_fn(int n_tile, int groups) {
  if (n_tile == 176) return groups == 2 ? expand_kernel<176, 2> : expand_kernel<176, 1>;
  return groups == 2 ? expand_kernel<256, 2> : expand_kernel<256, 1>;
}
ProjectFn project_fn(int n_tile, int groups) {
  if (n_tile == 176) return groups == 2 ? project_kernel<176, 2> : project_kernel<176, 1>;
  return groups == 2 ? project_kernel<256, 2> : project_kernel<256, 1>;
}

constexpr int ERR_NO_ENCODER = 1001;  // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_TENSOR_MAP = 1002;  // a tensor map was refused

int run_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* out_a,
             __nv_bfloat16* out_b, __nv_bfloat16* tmp_a, __nv_bfloat16* tmp_b, __nv_bfloat16* t,
             const __nv_bfloat16* w1, const __nv_bfloat16* w2, const float* vec, const float* dwk,
             int n_blocks, int batch, int h, int w, int c, const Plan& p, cudaStream_t stream) {
  if (encoder() == nullptr) return ERR_NO_ENCODER;
  const ExpandFn ek = expand_fn(p.n_tile, p.expand_groups);
  const ProjectFn pk = project_fn(p.n_tile, p.project_groups);
  cudaError_t err = allow_max_smem(ek);
  if (err == cudaSuccess) err = allow_max_smem(pk);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tmap;
  if (!halo_map(&tmap, t, batch, h, w, p.np, p.tile_h, p.tile_w)) return ERR_TENSOR_MAP;
  Bf16Block blk{};
  blk.t = t;
  blk.m_total = batch * h * w;
  blk.h = h;
  blk.w = w;
  blk.c = c;
  blk.kp = p.kp;
  blk.np = p.np;
  blk.n_tiles = p.n_tiles;
  blk.tile_h = p.tile_h;
  blk.tile_w = p.tile_w;
  blk.tiles_y = p.tiles_y;
  blk.tiles_x = p.tiles_x;
  blk.halo_stages = p.halo_stages;
  blk.slab_half = p.slab_half;
  blk.slab_stages = p.slab_stages;
  const __nv_bfloat16* src_a = a;
  const __nv_bfloat16* src_b = b;
  for (int i = 0; i < n_blocks; ++i) {
    // ping-pong between the two pairs so that the last block writes out_*
    const bool to_out = ((n_blocks - 1 - i) & 1) == 0;
    __nv_bfloat16* dst_a = to_out ? out_a : tmp_a;
    __nv_bfloat16* dst_b = to_out ? out_b : tmp_b;
    const CUtensorMap* map1 = cached_map(w1 + (size_t)i * p.np * p.kp, p.kp, p.np, p.n_tile);
    const CUtensorMap* map2 = cached_map(w2 + (size_t)i * p.np * p.kp, p.kp, p.np, p.n_tile);
    const CUtensorMap* dmap = cached_map(dwk + (size_t)i * 25 * p.np, p.np, 25, 25);
    const CUtensorMap* vmap = cached_map(vec + (size_t)i * 6 * p.np, p.np, 6, 2);
    if (!map1 || !map2 || !dmap || !vmap) return ERR_TENSOR_MAP;
    blk.a = src_a;
    blk.b = src_b;
    blk.x1 = dst_a;
    blk.v = dst_b;
    blk.vec = vec + (size_t)i * 6 * p.np;
    blk.dwk = dwk + (size_t)i * 25 * p.np;
    blk.tiles = p.expand_tiles;
    blk.stages = p.expand_stages;
    ek<<<p.expand_grid, 128 * (p.expand_groups + 1), p.expand_smem, stream>>>(*map1, blk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    blk.tiles = p.project_tiles;
    blk.stages = p.project_stages;
    pk<<<p.project_grid, 128 * (p.project_groups + 1), p.project_smem, stream>>>(
        *map2, tmap, *dmap, *vmap, blk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src_a = dst_a;
    src_b = dst_b;
  }
  return 0;
}

int run_f32(const float* a, const float* b, float* out_a, float* out_b, float* tmp_a,
            float* tmp_b, float* t, const float* w1, const float* w2, const float* vec,
            const float* dwk, int n_blocks, int h, int w, int c, const Plan& p,
            cudaStream_t stream) {
  const bool wide = p.expand_rows == 64;
  const auto ek = wide ? expand_f32<64> : expand_f32<32>;
  const auto pk = wide ? project_f32<64> : project_f32<32>;
  cudaError_t err = cudaFuncSetAttribute(ek, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.expand_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pk, cudaFuncAttributeMaxDynamicSharedMemorySize, p.project_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_total = p.project_tiles / (p.tiles_x * p.tiles_y) * h * w;
  const float* src_a = a;
  const float* src_b = b;
  for (int i = 0; i < n_blocks; ++i) {
    const bool to_out = ((n_blocks - 1 - i) & 1) == 0;
    float* dst_a = to_out ? out_a : tmp_a;
    float* dst_b = to_out ? out_b : tmp_b;
    const float* vi = vec + (size_t)i * 6 * p.np;
    ek<<<p.expand_grid, F32_THREADS, p.expand_smem, stream>>>(
        src_a, src_b, dst_a, t, w1 + (size_t)i * p.np * p.kp, vi, m_total, c, p.kp, p.np,
        p.expand_stages);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    pk<<<p.project_grid, F32_THREADS, p.project_smem, stream>>>(
        t, dst_b, w2 + (size_t)i * p.np * p.kp, vi, dwk + (size_t)i * 25 * p.np, h, w, c, p.kp,
        p.np, p.tiles_x, p.tiles_y, p.project_stages);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src_a = dst_a;
    src_b = dst_b;
  }
  return 0;
}

}  // namespace

// a, b: the (batch, h, w, c) input pair, contiguous, 16-byte aligned, on the
// card.  out_*: the output pair; tmp_*: a second pair of the same shape (may
// alias out_* when n_blocks == 1); t: (batch * h * w, Np) scratch.  w1, w2:
// (n_blocks, Np, Kp); vec: (n_blocks, 6, Np); dwk: (n_blocks, 25, Np), as
// ops/pair_chain.py::pack lays them out; plan: the 21 ints of
// ops/pair_chain.py::LaunchPlan.  Launches 2 * n_blocks kernels on `stream`
// without synchronizing; returns cudaErrorInvalidValue before any launch
// when the plan does not fit the shapes, ERR_* when a tensor map cannot be
// made, else the first nonzero CUDA error, else 0.
extern "C" int pair_chain_bf16(const void* a, const void* b, void* out_a, void* out_b,
                               void* tmp_a, void* tmp_b, void* t, const void* w1,
                               const void* w2, const float* vec, const float* dwk,
                               int n_blocks, int batch, int h, int w, int c, const int* plan,
                               void* stream) {
  using T = __nv_bfloat16;
  Plan p;
  std::memcpy(&p, plan, sizeof(Plan));
  if (n_blocks <= 0 || batch <= 0 || h <= 0 || w <= 0 || c <= 0 || (c & 1) ||
      !plan_fits(p, true, batch, h, w, c) || (reinterpret_cast<uintptr_t>(a) & 15) ||
      (reinterpret_cast<uintptr_t>(b) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_bf16(static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out_a),
                  static_cast<T*>(out_b), static_cast<T*>(tmp_a), static_cast<T*>(tmp_b),
                  static_cast<T*>(t), static_cast<const T*>(w1), static_cast<const T*>(w2), vec,
                  dwk, n_blocks, batch, h, w, c, p, static_cast<cudaStream_t>(stream));
}

extern "C" int pair_chain_f32(const void* a, const void* b, void* out_a, void* out_b,
                              void* tmp_a, void* tmp_b, void* t, const void* w1, const void* w2,
                              const float* vec, const float* dwk, int n_blocks, int batch, int h,
                              int w, int c, const int* plan, void* stream) {
  using T = float;
  Plan p;
  std::memcpy(&p, plan, sizeof(Plan));
  if (n_blocks <= 0 || batch <= 0 || h <= 0 || w <= 0 || c <= 0 || (c & 1) ||
      !plan_fits(p, false, batch, h, w, c))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_f32(static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out_a),
                 static_cast<T*>(out_b), static_cast<T*>(tmp_a), static_cast<T*>(tmp_b),
                 static_cast<T*>(t), static_cast<const T*>(w1), static_cast<const T*>(w2), vec,
                 dwk, n_blocks, h, w, c, p, static_cast<cudaStream_t>(stream));
}

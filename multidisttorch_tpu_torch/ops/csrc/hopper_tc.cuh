// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels:
// the host-side tensor-map encoding, the mbarrier ring, TMA loads, wgmma
// shared-memory descriptors, the wgmma products, and the split of an f32
// operand into bf16 terms.
//
// Tiles. Every operand tile is 64 rows of a (BH, T, D) bf16 slab, staged
// by TMA as D / 64 column panels of 64 rows x 128 bytes with the 128-byte
// swizzle. A panel is 8 KB and starts on a 1024-byte boundary, so one
// swizzle atom (8 rows x 128 bytes) is the unit of both the K-major and
// the MN-major descriptors below.
//
// Fragments. A thread of a consumer warpgroup (warp w, lane l) owns rows
// 16 w + l / 4 and 16 w + l / 4 + 8 of a 64 x N f32 accumulator; its element
// i sits in the first of those rows for (i & 2) == 0, at column
// 8 (i / 4) + 2 (l % 4) + (i & 1). Packed to bf16 in pairs, accumulator
// columns 16 kk .. 16 kk + 15 are the register A operand of the next
// product's k-step kk (see split_fragment), split into bf16 terms so the
// f32 operand loses (almost) nothing.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kTileRows = 64;               // rows of every staged tile
constexpr int kPanelBytes = kTileRows * 128;  // one 64-row, 64-column bf16 panel

// ---------------------------------------------------------------- host side

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query, so the library needs no -lcuda. Null if libcuda has none.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Error codes of the tensor-map encoding, beside the CUDA runtime's: libcuda
// has no encoder, or it refused the map (10000 + its CUresult).
constexpr int kErrNoEncoder = 9999;
constexpr int kErrEncodeBase = 10000;

// A 3-D map (D, T, BH) over a contiguous bf16 slab with 64-column x 64-row
// boxes, 128-byte swizzled. The box never crosses into the next head: rows
// at or past T are zero-filled. Returns 0 or an error code.
inline int bf16_tile_map(CUtensorMap* map, const void* base, int bh, int t, int d) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {64, kTileRows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncodeBase + (int)res;
}

// -------------------------------------------------------- shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (the swizzle atom's alignment).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// After every mbar_init, before any thread uses the barriers.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive, and expect `bytes` more from TMA in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// outlasts 2^30 polls (seconds; a tile takes microseconds) can only be a
// lost arrival: trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++polls == (1u << 30)) __trap();
  } while (!done);
}

// A ring of `Stages` buffers: the consumer waits on full[s], the producer
// on empty[s]. Tile j lives in stage j % Stages; its phase parity is
// (j / Stages) & 1 for the consumer, flipped for the producer, whose first
// pass over the ring finds every buffer free.
template <int Stages>
struct Ring {
  __device__ __forceinline__ static int stage(int j) { return j % Stages; }
  __device__ __forceinline__ static int full_parity(int j) { return (j / Stages) & 1; }
  __device__ __forceinline__ static int empty_parity(int j) { return ((j / Stages) & 1) ^ 1; }
};

// ------------------------------------------------------------------- TMA

// One 64 x 64 box at (column c0, row c1, head c2) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_3d(const CUtensorMap* map, void* dst, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Rows [row0, row0 + 64) of head bh, all D columns, as D / 64 panels.
template <int D>
__device__ __forceinline__ void tma_load_tile(const CUtensorMap* map, uint8_t* dst, uint64_t* bar,
                                              int row0, int bh) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p) tma_load_3d(map, dst + p * kPanelBytes, bar, 64 * p, row0, bh);
}

// ------------------------------------------------------ wgmma descriptors

// A shared-memory matrix descriptor with the 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// K-major operand: the 64 rows of a staged tile, its 16 columns
// 16 kk .. 16 kk + 15 (panel kk / 4, 32 bytes in per step); 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 16, 1024);
}

// MN-major operand (rows of the tile are the reduction): its rows
// 16 kk .. 16 kk + 15 across all D columns; 8-row groups 1024 bytes apart,
// 64-column panels kPanelBytes apart.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, kPanelBytes, 1024);
}

// ------------------------------------------------------------------ wgmma

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

// Pin registers at this point of the instruction stream: reads after a
// wgmma_wait see the product, writes before a wgmma_fence reach it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(r[i][j][k])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64), B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) B (16 x 128), B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x N) += A (64 x 16, registers) B (16 x N, MN-major), N = 64 or 128.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_m64n64k16(d, a, desc_b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_m64n128k16(d, a, desc_b);
}

// ------------------------------------------------ the bf16 term split

// x = t_0 + t_1 + ... + t_{Terms-1} + r with t_0 = bf16(x) and each next
// term the bf16 of what is left: |r| <= 2^-(8 Terms + 1) |x| or so. Two
// terms (hi, lo) keep an f32 operand to about 16 bits, three to about 24,
// where one rounding to bf16 keeps 8. A product is then summed over the
// terms, each exact in the tensor cores, in f32.

// A 64 x 64 f32 accumulator fragment as the register A operand of four
// k-steps, once per term. Packs the lower column of each pair low.
template <int Terms>
__device__ __forceinline__ void split_fragment(const float (&x)[32],
                                               uint32_t (&parts)[Terms][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
#pragma unroll
      for (int n = 0; n < Terms; ++n) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
        parts[n][kk][r] = *reinterpret_cast<const uint32_t*>(&h);
        const float2 hf = __bfloat1622float2(h);
        a -= hf.x;  // exact: hf is a rounded to 8 bits
        b -= hf.y;
      }
    }
}

// D (64 x N) += X B with X split into terms as above and B (64 x N) a
// staged MN-major tile: 4 Terms wgmmas, issued, not waited for.
template <int N, int Terms>
__device__ __forceinline__ void wgmma_split_product(float (&d)[N],
                                                    const uint32_t (&parts)[Terms][4][4],
                                                    uint32_t b_tile) {
#pragma unroll
  for (int n = 0; n < Terms; ++n)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, parts[n][kk], mnmajor_desc(b_tile, kk));
}

// ------------------------------------------------------- row reductions

// Over the four threads of a quad, which share the accumulator's rows.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace hopper

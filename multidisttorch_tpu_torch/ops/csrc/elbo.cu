// Fused negative-ELBO forward and backward kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of multidisttorch_tpu/ops/pallas_elbo.py:
//   elbo_fwd: _fwd_kernel, launched by _fwd (pallas_call at :134);
//   elbo_bwd: _bwd_kernel, launched by _bwd (pallas_call at :163).
//
// What bounds them: bytes. At the flagship shape (batch 128, 784 pixels,
// latent 20, f32) the forward reads 823,296 B, about 0.25 us at 3.35 TB/s,
// and the backward reads the same and writes 421,888 B, about 0.37 us. A
// kernel launch costs more than either, so at that shape both kernels are
// launch-bound. The design therefore keeps each pass to one read of every
// input and nothing more:
//   - 16-byte vector loads and stores where the pointers are aligned, with a
//     scalar tail for ragged lengths (and a scalar path for unaligned views);
//   - f32 math whatever the storage type, accumulated in registers;
//   - forward: a fixed grid of at most ~2 blocks per SM walks the flat wide
//     (B*D) and narrow (B*L) arrays with a grid-stride loop, reduces with warp
//     shuffles and shared memory, and writes one partial per block; a second
//     one-block kernel sums the partials in a fixed order. No float atomics,
//     so a rerun gives the same bits. (The TPU kernel carried its sum across
//     a sequential grid in SMEM; Hopper's blocks run in no order.)
//   - backward: one elementwise grid-stride kernel over the wide and narrow
//     parts that reads the upstream cotangent g from device memory (no host
//     sync) and folds it in before the single rounding to each primal's type.
//
// Plain C interface, loaded with ctypes (multidisttorch_tpu_torch/ops/_build.py).
// Every entry takes the device index and a cudaStream_t, launches on that
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError(). dtype codes: bit 0 logits, bit 1 x, bit 2 mu,
// bit 3 logvar; a set bit means __nv_bfloat16, a clear bit float.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Elements per vector step: one 16-byte load of bf16, two of f32.
constexpr int kVec = 8;

using f32 = float;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Eight consecutive elements from a 16-byte aligned pointer, as f32.
__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Stable BCE from logits: max(l,0) - l*x + log1p(exp(-|l|)).
struct BceTerm {
  __device__ __forceinline__ float operator()(float l, float x) const {
    return fmaxf(l, 0.f) - l * x + log1pf(expf(-fabsf(l)));
  }
};
// The summand of the Gaussian KL: 1 + logvar - mu^2 - exp(logvar).
struct KlTerm {
  __device__ __forceinline__ float operator()(float m, float lv) const {
    return 1.f + lv - m * m - expf(lv);
  }
};
struct DLogits {
  float g;
  __device__ __forceinline__ float operator()(float l, float x) const {
    return g * (1.f / (1.f + expf(-l)) - x);
  }
};
struct DMu {
  float gb;  // g * beta
  __device__ __forceinline__ float operator()(float m) const { return gb * m; }
};
struct DLogvar {
  float gb;  // g * beta
  __device__ __forceinline__ float operator()(float lv) const {
    return gb * 0.5f * (expf(lv) - 1.f);
  }
};

// This thread's share of sum(op(a[i], b[i])) under a grid-stride loop.
template <typename TA, typename TB, typename Op>
__device__ __forceinline__ float pair_sum(const TA* a, const TB* b, int64_t n,
                                          bool vec, Op op) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n_vec = vec ? n / kVec : 0;
  float acc = 0.f;
  for (int64_t i = tid; i < n_vec; i += stride) {
    float va[kVec], vb[kVec];
    load8(a + i * kVec, va);
    load8(b + i * kVec, vb);
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc += op(va[k], vb[k]);
  }
  for (int64_t j = n_vec * kVec + tid; j < n; j += stride)
    acc += op(to_f32(a[j]), to_f32(b[j]));
  return acc;
}

// out[i] = op(a[i], b[i]) under a grid-stride loop.
template <typename TA, typename TB, typename TO, typename Op>
__device__ __forceinline__ void pair_map(const TA* a, const TB* b, TO* out,
                                         int64_t n, bool vec, Op op) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n_vec = vec ? n / kVec : 0;
  for (int64_t i = tid; i < n_vec; i += stride) {
    float va[kVec], vb[kVec], vo[kVec];
    load8(a + i * kVec, va);
    load8(b + i * kVec, vb);
#pragma unroll
    for (int k = 0; k < kVec; ++k) vo[k] = op(va[k], vb[k]);
    store8(out + i * kVec, vo);
  }
  for (int64_t j = n_vec * kVec + tid; j < n; j += stride)
    out[j] = from_f32<TO>(op(to_f32(a[j]), to_f32(b[j])));
}

// out[i] = op(a[i]) under a grid-stride loop.
template <typename TA, typename TO, typename Op>
__device__ __forceinline__ void unary_map(const TA* a, TO* out, int64_t n,
                                          bool vec, Op op) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n_vec = vec ? n / kVec : 0;
  for (int64_t i = tid; i < n_vec; i += stride) {
    float va[kVec], vo[kVec];
    load8(a + i * kVec, va);
#pragma unroll
    for (int k = 0; k < kVec; ++k) vo[k] = op(va[k]);
    store8(out + i * kVec, vo);
  }
  for (int64_t j = n_vec * kVec + tid; j < n; j += stride)
    out[j] = from_f32<TO>(op(to_f32(a[j])));
}

// Sum of v over the block, in a fixed order; the result is valid in thread 0.
// Called at most once per kernel (it owns one shared array).
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename TL, typename TX, typename TM, typename TV>
__global__ void __launch_bounds__(kThreads)
    elbo_fwd_partials(const TL* logits, const TX* x, int64_t n_wide, bool vec_wide,
                      const TM* mu, const TV* logvar, int64_t n_narrow,
                      bool vec_narrow, float beta, float* partials) {
  const float bce = pair_sum(logits, x, n_wide, vec_wide, BceTerm{});
  const float kl = pair_sum(mu, logvar, n_narrow, vec_narrow, KlTerm{});
  const float part = block_sum(bce + beta * (-0.5f * kl));
  if (threadIdx.x == 0) partials[blockIdx.x] = part;
}

__global__ void __launch_bounds__(kThreads)
    elbo_fwd_finish(const float* partials, int n, float* out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

template <typename TL, typename TX, typename TM, typename TV>
__global__ void __launch_bounds__(kThreads)
    elbo_bwd_kernel(const TL* logits, const TX* x, TL* dlogits, int64_t n_wide,
                    bool vec_wide, const TM* mu, TM* dmu, bool vec_mu,
                    const TV* logvar, TV* dlogvar, bool vec_logvar,
                    int64_t n_narrow, float beta, const float* g_ptr) {
  const float g = *g_ptr;
  pair_map(logits, x, dlogits, n_wide, vec_wide, DLogits{g});
  unary_map(mu, dmu, n_narrow, vec_mu, DMu{g * beta});
  unary_map(logvar, dlogvar, n_narrow, vec_logvar, DLogvar{g * beta});
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename TL, typename TX, typename TM, typename TV>
void launch_fwd(const void* logits, const void* x, const void* mu,
                const void* logvar, int64_t n_wide, int64_t n_narrow, float beta,
                float* partials, int grid, float* out, cudaStream_t stream) {
  elbo_fwd_partials<TL, TX, TM, TV><<<grid, kThreads, 0, stream>>>(
      static_cast<const TL*>(logits), static_cast<const TX*>(x), n_wide,
      aligned16(logits) && aligned16(x), static_cast<const TM*>(mu),
      static_cast<const TV*>(logvar), n_narrow, aligned16(mu) && aligned16(logvar),
      beta, partials);
  elbo_fwd_finish<<<1, kThreads, 0, stream>>>(partials, grid, out);
}

template <typename TL, typename TX, typename TM, typename TV>
void launch_bwd(const void* logits, const void* x, const void* mu,
                const void* logvar, int64_t n_wide, int64_t n_narrow, float beta,
                const float* g, void* dlogits, void* dmu, void* dlogvar, int grid,
                cudaStream_t stream) {
  elbo_bwd_kernel<TL, TX, TM, TV><<<grid, kThreads, 0, stream>>>(
      static_cast<const TL*>(logits), static_cast<const TX*>(x),
      static_cast<TL*>(dlogits), n_wide,
      aligned16(logits) && aligned16(x) && aligned16(dlogits),
      static_cast<const TM*>(mu), static_cast<TM*>(dmu),
      aligned16(mu) && aligned16(dmu), static_cast<const TV*>(logvar),
      static_cast<TV*>(dlogvar), aligned16(logvar) && aligned16(dlogvar),
      n_narrow, beta, g);
}

}  // namespace

// One case per dtype code (bit 0 logits, bit 1 x, bit 2 mu, bit 3 logvar).
#define MDT_ELBO_DISPATCH(FN, ...)                              \
  switch (dtypes) {                                             \
    case 0: FN<f32, f32, f32, f32>(__VA_ARGS__); break;         \
    case 1: FN<bf16, f32, f32, f32>(__VA_ARGS__); break;        \
    case 2: FN<f32, bf16, f32, f32>(__VA_ARGS__); break;        \
    case 3: FN<bf16, bf16, f32, f32>(__VA_ARGS__); break;       \
    case 4: FN<f32, f32, bf16, f32>(__VA_ARGS__); break;        \
    case 5: FN<bf16, f32, bf16, f32>(__VA_ARGS__); break;       \
    case 6: FN<f32, bf16, bf16, f32>(__VA_ARGS__); break;       \
    case 7: FN<bf16, bf16, bf16, f32>(__VA_ARGS__); break;      \
    case 8: FN<f32, f32, f32, bf16>(__VA_ARGS__); break;        \
    case 9: FN<bf16, f32, f32, bf16>(__VA_ARGS__); break;       \
    case 10: FN<f32, bf16, f32, bf16>(__VA_ARGS__); break;      \
    case 11: FN<bf16, bf16, f32, bf16>(__VA_ARGS__); break;     \
    case 12: FN<f32, f32, bf16, bf16>(__VA_ARGS__); break;      \
    case 13: FN<bf16, f32, bf16, bf16>(__VA_ARGS__); break;     \
    case 14: FN<f32, bf16, bf16, bf16>(__VA_ARGS__); break;     \
    case 15: FN<bf16, bf16, bf16, bf16>(__VA_ARGS__); break;    \
    default: return (int)cudaErrorInvalidValue;                 \
  }

// Summed negative ELBO into out (one f32). partials holds `grid` floats.
extern "C" int mdt_elbo_fwd(int device, const void* logits, const void* x,
                            const void* mu, const void* logvar, int64_t n_wide,
                            int64_t n_narrow, int dtypes, float beta,
                            void* partials, int grid, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  MDT_ELBO_DISPATCH(launch_fwd, logits, x, mu, logvar, n_wide, n_narrow, beta,
                    static_cast<float*>(partials), grid, static_cast<float*>(out),
                    static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Cotangents of the summed negative ELBO, scaled by the f32 cotangent at g,
// each written in its primal's dtype.
extern "C" int mdt_elbo_bwd(int device, const void* logits, const void* x,
                            const void* mu, const void* logvar, int64_t n_wide,
                            int64_t n_narrow, int dtypes, float beta,
                            const void* g, void* dlogits, void* dmu,
                            void* dlogvar, int grid, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  MDT_ELBO_DISPATCH(launch_bwd, logits, x, mu, logvar, n_wide, n_narrow, beta,
                    static_cast<const float*>(g), dlogits, dmu, dlogvar, grid,
                    static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Flash-attention forward, dQ and dK/dV kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of multidisttorch_tpu/ops/pallas_attention.py:
//   flash_fwd:     _fwd_kernel (:91), launched by _fwd_call (pallas_call at :160);
//   flash_bwd_dq:  _bwd_dq_kernel (:199), launched by _bwd_call (pallas_call at :332);
//   flash_bwd_dkv: _bwd_dkv_kernel (:250), launched by _bwd_call (pallas_call at :346).
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous (BH, T, D) slabs in one
// dtype (float or __nv_bfloat16); lse and delta are (BH, T) float. All math
// is f32; outputs are rounded once to the input dtype.
//
// What bounds them on an H100: at the LM's full width (BH 128, T 512, D 64,
// causal, bf16) the forward moves 33.8 MB (about 10 us at 3.35 TB/s) and does
// about 4.3 GFLOP (4.3 us on the bf16 tensor cores), so the byte bound sets
// the floor. These first kernels do their products as f32 FMAs on the CUDA
// cores (67 TFLOP/s peak), so their own floor is the FMA rate: about 64 us
// for that forward. Tensor cores (mma.sync / wgmma), TMA and warp
// specialisation are later work.
//
// Design, against what the TPU kernels leaned on:
//   - The TPU walked a sequential (BH, nq, nk) grid and carried the running
//     max, sum and accumulator in VMEM scratch across the innermost axis.
//     Here one block owns one (bh, q-tile) and loops over the K tiles itself,
//     with the carry in registers (dK/dV: one block per (bh, k-tile), looping
//     over the Q tiles). Causal blocks skip the tiles above the diagonal.
//   - Tiles are B x B (B = 64, or 32 at head dims above 128) staged in shared
//     memory as f32, rows padded to DP + 1 floats so the column walks hit 32
//     distinct banks. DP is the head dim rounded up to 32, 64, 128 or 256,
//     zero-filled past D. 256 threads form a 16 x 16 grid; each thread owns
//     a (B/16) x (B/16) patch of the score tile and rows of the accumulator.
//   - A ragged last tile (T % B != 0) is masked: its missing keys get p = 0
//     exactly, its missing queries are not written. The TPU needed whole
//     128-row tiles or one whole-sequence block; the function is the same.
//   - No float atomics: dQ and dK/dV each have a single writer per output
//     row, so a rerun gives the same bits.
//   - The causal mask uses the TPU kernel's finite sentinel -1e30.
//
// Plain C interface, loaded with ctypes (multidisttorch_tpu_torch/ops/_build.py).
// Every entry takes the device index and a cudaStream_t, launches on that
// stream, does not synchronise, allocates nothing, and returns a CUDA error
// code (0 on success). dtype: 0 float, 1 __nv_bfloat16. Head dims up to 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr float kNegInf = -1e30f;

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

// Rows [row0, row0 + B) of a (t, d) slab into a (B, DP) f32 tile with row
// stride DP + 1; zero past t and past d.
template <int B, int DP, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int t, int d) {
  for (int i = threadIdx.x; i < B * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i - r * DP;
    const int gr = row0 + r;
    dst[r * (DP + 1) + c] =
        (gr < t && c < d) ? to_f32(src[(int64_t)gr * d + c]) : 0.f;
  }
}

// s[i][j] = sum_c a[ty + 16i][c] * b[tx + 16j][c] over two (B, DP) tiles.
template <int B, int DP>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         float (&s)[B / 16][B / 16]) {
  constexpr int R = B / 16;
  constexpr int LD = DP + 1;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; ++c) {
    float av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(ty + 16 * i) * LD + c];
#pragma unroll
    for (int j = 0; j < R; ++j) bv[j] = b[(tx + 16 * j) * LD + c];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// Max and sum over the 16 threads of a row (one half-warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int B, int DP, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int t, int d, float scale,
                     int causal) {
  constexpr int R = B / 16, C = DP / 16, LD = DP + 1, LS = B + 1;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + B * LD;
  float* v_s = k_s + B * LD;
  float* p_s = v_s + B * LD;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * B;
  const int64_t base = (int64_t)bh * t * d;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  load_tile<B, DP>(q_s, q + base, q0, t, d);
  float m[R], l[R], acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int nk = (t + B - 1) / B;
  // Causal: K tiles strictly above the diagonal contribute nothing.
  const int k_end = causal ? min(nk, (int)blockIdx.y + 1) : nk;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * B;
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    load_tile<B, DP>(k_s, k + base, k0, t, d);
    load_tile<B, DP>(v_s, v + base, k0, t, d);
    __syncthreads();
    float s[R][R];
    tile_dot<B, DP>(q_s, k_s, s);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = k0 + tx + 16 * j;
        float sv = s[i][j] * scale;
        if (causal && col > row) sv = kNegInf;
        if (col >= t) sv = -INFINITY;  // a ragged tile's missing keys: p = 0
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        p_s[(ty + 16 * i) * LS + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < B; ++kk) {
      float pv[R], vv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = p_s[(ty + 16 * i) * LS + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = v_s[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    const float denom = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < d) o[base + (int64_t)row * d + col] = from_f32<T>(acc[i][c] / denom);
    }
    // The per-row logsumexp: the one residual the backward needs.
    if (tx == 0) lse[(int64_t)bh * t + row] = m[i] + logf(denom);
  }
}

// p and ds for one (Q tile, K tile) pair from the score and dO V^T tiles:
// p = exp(s * scale - lse) with the causal sentinel, 0 outside the sequence;
// ds = p * (dp - delta) * scale.
template <int R>
__device__ __forceinline__ void probs_and_dscores(
    float (&s)[R][R], float (&dp)[R][R], const float* lse, const float* delta,
    int64_t row_base, int q0, int k0, int t, float scale, int causal) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool row_in = row < t;
    const float lse_r = row_in ? lse[row_base + row] : 0.f;
    const float delta_r = row_in ? delta[row_base + row] : 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = k0 + tx + 16 * j;
      float sv = s[i][j] * scale;
      if (causal && col > row) sv = kNegInf;
      const float p = (row_in && col < t) ? expf(sv - lse_r) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_r) * scale;
    }
  }
}

template <int B, int DP, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int t, int d, float scale, int causal) {
  constexpr int R = B / 16, C = DP / 16, LD = DP + 1, LS = B + 1;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + B * LD;
  float* k_s = do_s + B * LD;
  float* v_s = k_s + B * LD;
  float* ds_s = v_s + B * LD;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * B;
  const int64_t base = (int64_t)bh * t * d;
  const int64_t row_base = (int64_t)bh * t;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  load_tile<B, DP>(q_s, q + base, q0, t, d);
  load_tile<B, DP>(do_s, dout + base, q0, t, d);
  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  const int nk = (t + B - 1) / B;
  const int k_end = causal ? min(nk, (int)blockIdx.y + 1) : nk;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * B;
    __syncthreads();
    load_tile<B, DP>(k_s, k + base, k0, t, d);
    load_tile<B, DP>(v_s, v + base, k0, t, d);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<B, DP>(q_s, k_s, s);
    tile_dot<B, DP>(do_s, v_s, dp);
    probs_and_dscores<R>(s, dp, lse, delta, row_base, q0, k0, t, scale, causal);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) ds_s[(ty + 16 * i) * LS + tx + 16 * j] = dp[i][j];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < B; ++kk) {
      float dsv[R], kv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = ds_s[(ty + 16 * i) * LS + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = k_s[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < d) dq[base + (int64_t)row * d + col] = from_f32<T>(acc[i][c]);
    }
  }
}

template <int B, int DP, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int t, int d, float scale,
                         int causal) {
  constexpr int R = B / 16, C = DP / 16, LD = DP + 1, LS = B + 1;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + B * LD;
  float* q_s = v_s + B * LD;
  float* do_s = q_s + B * LD;
  float* p_s = do_s + B * LD;
  float* ds_s = p_s + B * LS;

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int k0 = kt * B;
  const int64_t base = (int64_t)bh * t * d;
  const int64_t row_base = (int64_t)bh * t;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  load_tile<B, DP>(k_s, k + base, k0, t, d);
  load_tile<B, DP>(v_s, v + base, k0, t, d);
  // Thread (ty, tx) owns key rows k0 + ty + 16i and head columns tx + 16c.
  float dk_acc[R][C], dv_acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (t + B - 1) / B;
  // Causal: Q tiles strictly above the diagonal see none of these keys.
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * B;
    __syncthreads();
    load_tile<B, DP>(q_s, q + base, q0, t, d);
    load_tile<B, DP>(do_s, dout + base, q0, t, d);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<B, DP>(q_s, k_s, s);
    tile_dot<B, DP>(do_s, v_s, dp);
    probs_and_dscores<R>(s, dp, lse, delta, row_base, q0, k0, t, scale, causal);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        p_s[(ty + 16 * i) * LS + tx + 16 * j] = s[i][j];
        ds_s[(ty + 16 * i) * LS + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < B; ++r) {
      float pv[R], dsv[R], dov[C], qv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = p_s[r * LS + ty + 16 * i];
        dsv[i] = ds_s[r * LS + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dov[c] = do_s[r * LD + tx + 16 * c];
        qv[c] = q_s[r * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv_acc[i][c] = fmaf(pv[i], dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= t) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dk[base + (int64_t)row * d + col] = from_f32<T>(dk_acc[i][c]);
        dv[base + (int64_t)row * d + col] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

// Dynamic shared memory of each kernel, in bytes: (B, DP + 1) f32 tiles
// plus (B, B + 1) f32 score tiles.
template <int B, int DP>
constexpr size_t smem_bytes(int wide_tiles, int score_tiles) {
  return (size_t)(wide_tiles * B * (DP + 1) + score_tiles * B * (B + 1)) * sizeof(float);
}

constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared-memory limit once per device (`ready` is
// the calling instantiation's own flags). Setting it once, and not before
// every launch, keeps the launches capturable in a CUDA graph.
template <typename K>
cudaError_t prepare(K kernel, size_t smem, int device, std::atomic<bool>* ready) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[device].load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) ready[device].store(true);
  return err;
}

template <int B, int DP, typename T>
int launch_fwd(int device, const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int t, int d, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<B, DP>(3, 1);
  static std::atomic<bool> ready[kMaxDevices];
  cudaError_t err = prepare(flash_fwd_kernel<B, DP, T>, smem, device, ready);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<B, DP, T><<<dim3(bh, (t + B - 1) / B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), t, d, scale, causal);
  return (int)cudaGetLastError();
}

template <int B, int DP, typename T>
int launch_dq(int device, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta, void* dq,
              int bh, int t, int d, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<B, DP>(4, 1);
  static std::atomic<bool> ready[kMaxDevices];
  cudaError_t err = prepare(flash_bwd_dq_kernel<B, DP, T>, smem, device, ready);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<B, DP, T><<<dim3(bh, (t + B - 1) / B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), t, d, scale, causal);
  return (int)cudaGetLastError();
}

template <int B, int DP, typename T>
int launch_dkv(int device, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta, void* dk,
               void* dv, int bh, int t, int d, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<B, DP>(4, 2);
  static std::atomic<bool> ready[kMaxDevices];
  cudaError_t err = prepare(flash_bwd_dkv_kernel<B, DP, T>, smem, device, ready);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<B, DP, T><<<dim3(bh, (t + B - 1) / B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      t, d, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// One instantiation per (tile rows, padded head dim) and dtype; head dims
// above 256 are refused.
#define MDT_FLASH_CASE(FN, B, DP, ...)                                       \
  return dtype ? FN<B, DP, bf16>(__VA_ARGS__) : FN<B, DP, float>(__VA_ARGS__)
#define MDT_FLASH_DISPATCH(FN, ...)                                 \
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue; \
  if (d <= 32) MDT_FLASH_CASE(FN, 64, 32, __VA_ARGS__);            \
  if (d <= 64) MDT_FLASH_CASE(FN, 64, 64, __VA_ARGS__);            \
  if (d <= 128) MDT_FLASH_CASE(FN, 64, 128, __VA_ARGS__);          \
  if (d <= 256) MDT_FLASH_CASE(FN, 32, 256, __VA_ARGS__);          \
  return (int)cudaErrorInvalidValue

// o (BH, T, D) in the input dtype and lse (BH, T) f32.
extern "C" int mdt_flash_fwd(int device, const void* q, const void* k,
                             const void* v, void* o, void* lse, int bh, int t,
                             int d, float scale, int causal, int dtype,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  MDT_FLASH_DISPATCH(launch_fwd, device, q, k, v, o, lse, bh, t, d, scale, causal,
                     static_cast<cudaStream_t>(stream));
}

// dq (BH, T, D) from q, k, v, dO, lse and delta = rowsum(dO * O) - g_lse.
extern "C" int mdt_flash_bwd_dq(int device, const void* q, const void* k,
                                const void* v, const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int t, int d,
                                float scale, int causal, int dtype, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  MDT_FLASH_DISPATCH(launch_dq, device, q, k, v, dout, lse, delta, dq, bh, t, d, scale,
                     causal, static_cast<cudaStream_t>(stream));
}

// dk and dv (BH, T, D) from the same operands.
extern "C" int mdt_flash_bwd_dkv(int device, const void* q, const void* k,
                                 const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int bh,
                                 int t, int d, float scale, int causal, int dtype,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  MDT_FLASH_DISPATCH(launch_dkv, device, q, k, v, dout, lse, delta, dk, dv, bh, t, d,
                     scale, causal, static_cast<cudaStream_t>(stream));
}

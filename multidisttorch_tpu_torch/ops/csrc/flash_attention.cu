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
// Two variants. Each kernel has a tensor-core variant (flash_fwd_wgmma_kernel,
// flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel, below the SIMT
// kernels) for bf16 operands at head dim 64 or 128 on 16-byte-aligned
// bases: TMA-fed wgmma products, described where they are defined, with the
// pieces they share in hopper_tc.cuh. Every other input runs the SIMT
// kernels described next. ops/attention.py picks the variant before the
// launch; each has its own C entry.
//
// What bounds them on an H100: at the LM's full width (BH 128, T 512, D 64,
// causal, bf16) the forward moves 33.8 MB (about 10 us at 3.35 TB/s) and does
// about 4.3 GFLOP (4.3 us on the bf16 tensor cores), so the byte bound sets
// the floor. The SIMT kernels do their products as f32 FMAs on the CUDA
// cores (67 TFLOP/s peak), so their own floor is the FMA rate: about 64 us
// for that forward.
//
// Design of the SIMT kernels, against what the TPU kernels leaned on:
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
// code (0 on success; the tensor-core entries also return hopper_tc.cuh's
// tensor-map codes, 9999 and above). dtype: 0 float, 1 __nv_bfloat16. Head
// dims up to 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>
#include <utility>

#include "hopper_tc.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core variants of flash_fwd, flash_bwd_dq and flash_bwd_dkv:
// bf16 operands, head dim 64 or 128, 16-byte-aligned bases
// (ops/attention.py chooses).
//
// A CTA is consumer warpgroups of 64 rows each (one in dQ and dK/dV; the
// forward's count is kFwdWarpgroups) and one producer warp after them. The
// producer stages 64-row tiles by TMA into a two-stage ring; the consumers
// run the products as wgmmas (bf16 in, f32 accumulate) and the softmax in
// registers on the accumulator fragment.
//
// The second product of each kernel takes an f32 operand (p, or ds) split
// into bf16 terms, each multiplied and all summed in f32: one rounding of p
// or ds to bf16 would miss the port's f32 contract (o, dQ, dK and dV within
// one bf16 ulp of the f32 math). The forward takes two terms (hi, lo): o is
// normalised by the row sum, so the residual, 2^-17 of each p, stays
// relative to o. dQ takes two as well: it sums ds over a row of p, which
// sums to 1, so the residual stays near 2^-17 of scale |dp - delta|.
// dK and dV sum over a column of p, which does not, and can cancel to far
// below the terms they sum (a dV element of 2e-6 from terms near 1), so
// the residual must be small against the tolerance's 5e-6 absolute floor:
// they take three terms (residual about 2^-25). Exponentials are exp2 with
// log2(e) folded into the scale; lse stays the natural log. No atomics:
// each output row has one writer, so a rerun gives the same bits.
// ---------------------------------------------------------------------------

constexpr int kTcStages = 2;
constexpr int kFwdTerms = 2;  // bf16 terms of p in O += P V
constexpr int kBwdTerms = 3;  // of p and ds in dV += P^T dO, dK += dS^T Q
constexpr int kDqTerms = 2;   // of ds in dQ += dS K
constexpr int kTcConsumers = 128;  // dQ, dK/dV: one consumer warpgroup
constexpr int kTcThreads = kTcConsumers + 32;
// The forward: consumer warpgroups of 64 query rows each, sharing every
// K/V tile, plus the producer warp. One measured faster than two at the
// LM's (128, 512, 64) causal bf16 (ops/flash_ablation.py, variant fwd_wg2).
constexpr int kFwdWarpgroups = 1;
constexpr int kFwdThreads = kFwdWarpgroups * 128 + 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
__host__ __device__ constexpr int tc_tile_bytes() {
  return D / 64 * hopper::kPanelBytes;
}
// Q (a tile per warpgroup), then the ring's (K, V) stages, then the
// barriers; 1024 bytes of slack to align the tiles to the swizzle atom.
template <int D>
constexpr size_t fwd_wgmma_smem() {
  return 1024 + (size_t)(kFwdWarpgroups + 2 * kTcStages) * tc_tile_bytes<D>() +
         8 * (1 + 2 * kTcStages);
}
// Q and dO, then the ring's (K, V) stages, then the barriers.
template <int D>
constexpr size_t dq_wgmma_smem() {
  return 1024 + (size_t)(2 + 2 * kTcStages) * tc_tile_bytes<D>() + 8 * (1 + 2 * kTcStages);
}
// K and V, then the ring's (Q, dO) stages, the stages' lse and delta rows,
// then the barriers.
template <int D>
constexpr size_t dkv_wgmma_smem() {
  return 1024 + (size_t)(2 + 2 * kTcStages) * tc_tile_bytes<D>() +
         kTcStages * 2 * hopper::kTileRows * sizeof(float) + 8 * (1 + 2 * kTcStages);
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, D == 64 ? 2 : 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                           float* __restrict__ lse, int t, float scale_log2, int causal) {
  using namespace hopper;
  using R = Ring<kTcStages>;
  constexpr int kTile = tc_tile_bytes<D>();
  constexpr int kConsumers = kFwdWarpgroups * 128;
  constexpr int kCtaRows = kFwdWarpgroups * kTileRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);  // one 64-row Q tile per warpgroup
  uint8_t* kv_s = q_s + kFwdWarpgroups * kTile;  // stage s: K at kv_s + 2 s kTile, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + 2 * kTcStages * kTile);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kTcStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kCtaRows;  // the heaviest causal tiles first
  const int nk = (t + kTileRows - 1) / kTileRows;
  // Causal: K tiles strictly above the CTA's last row contribute nothing.
  const int n_tiles = causal ? min(nk, (q0 + kCtaRows - 1) / kTileRows + 1) : nk;
  // Warpgroups whose rows start at or past T load and compute nothing.
  const int n_active = min(kFwdWarpgroups, (t - q0 + kTileRows - 1) / kTileRows);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp; one lane issues
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(q_full, n_active * kTile);
      for (int w = 0; w < n_active; ++w)
        tma_load_tile<D>(&tm_q, q_s + w * kTile, q_full, q0 + w * kTileRows, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = R::stage(j);
        mbar_wait(&empty[s], R::empty_parity(j));
        mbar_arrive_expect_tx(&full[s], 2 * kTile);
        tma_load_tile<D>(&tm_k, kv_s + 2 * s * kTile, &full[s], j * kTileRows, bh);
        tma_load_tile<D>(&tm_v, kv_s + (2 * s + 1) * kTile, &full[s], j * kTileRows, bh);
      }
    }
    return;
  }

  // Warpgroup wg owns query rows q0w .. q0w + 63 and runs tiles 0 .. n_own - 1;
  // it waits for and releases every tile of the ring all the same, so each
  // stage's phases stay in step across the warpgroups.
  const int wg = threadIdx.x >> 7;
  const int q0w = q0 + wg * kTileRows;
  const int n_own = wg >= n_active ? 0 : causal ? min(nk, q0w / kTileRows + 1) : nk;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows r0 and r0 + 8
  const int c2 = 2 * (lane & 3);           // and columns 8 j + c2, + 1
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in log2 units
  const uint32_t q_addr = smem_u32(q_s + wg * kTile);
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = R::stage(j);
    const uint32_t k_addr = smem_u32(kv_s + 2 * s * kTile);
    const uint32_t v_addr = k_addr + kTile;
    mbar_wait(&full[s], R::full_parity(j));
    if (j >= n_own) {
      mbar_arrive(&empty[s]);
      continue;
    }

    // S = Q K^T over D / 16 k-steps.
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(sc, kmajor_desc(q_addr, kk), kmajor_desc(k_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    const int k0 = j * kTileRows;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
    // Only the diagonal tile crosses the causal mask, only a ragged last
    // tile the sequence's end.
    const bool diag = causal && k0 == q0w;
    if (diag || k0 + kTileRows > t) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = q0w + r0 + (i & 2) * 4;
        const int col = k0 + 8 * (i >> 2) + c2 + (i & 1);
        if (diag && col > row) sc[i] = kNegInf;
        if (col >= t) sc[i] = -INFINITY;  // missing keys: p = 0
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == h) mx = fmaxf(mx, sc[i]);
      const float m_new = fmaxf(m[h], quad_max(mx));
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = exp2f(sc[i] - m[h]);
      l[h] += sc[i];  // this thread's share of the row; summed over the quad at the end
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V, P as bf16 hi + lo.
    uint32_t p_parts[kFwdTerms][4][4];
    split_fragment(sc, p_parts);
    fence_regs(acc);
    fence_regs(p_parts);
    wgmma_fence();
    wgmma_split_product(acc, p_parts, v_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0w + r0 + 8 * h;
    const float sum = quad_sum(l[h]);
    if (row >= t) continue;
    const float denom = sum > 0.f ? sum : 1.f;
    bf16* dst = o + ((int64_t)bh * t + row) * D + c2;
#pragma unroll
    for (int jc = 0; jc < D / 8; ++jc)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jc) =
          __floats2bfloat162_rn(acc[4 * jc + 2 * h] / denom, acc[4 * jc + 2 * h + 1] / denom);
    // The per-row logsumexp, natural log: the one residual the backward needs.
    if ((lane & 3) == 0) lse[(int64_t)bh * t + row] = m[h] * kLn2 + logf(denom);
  }
}

// dQ for one 64-row Q tile: queries are the M rows of every product, so
// S = Q K^T and dP = dO V^T come out with this thread's two query rows, whose
// lse and delta it keeps in registers, and dS is already the register A
// operand of dQ += dS K. The staged K tile is the K-major B operand of S and
// the MN-major B operand of dQ.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq, int t, float scale, int causal) {
  using namespace hopper;
  using R = Ring<kTcStages>;
  constexpr int kTile = tc_tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* do_s = q_s + kTile;
  uint8_t* kv_s = do_s + kTile;  // stage s: K at kv_s + 2 s kTile, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + 2 * kTcStages * kTile);
  uint64_t* qdo_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kTcStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileRows;  // the heaviest causal tiles first
  const int nk = (t + kTileRows - 1) / kTileRows;
  // Causal: K tiles strictly above the diagonal contribute nothing.
  const int n_tiles = causal ? min(nk, q0 / kTileRows + 1) : nk;
  const int64_t row_base = (int64_t)bh * t;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {  // the producer warp; its first lane starts the copies
    if (threadIdx.x == kTcConsumers) {
      mbar_arrive_expect_tx(qdo_full, 2 * kTile);
      tma_load_tile<D>(&tm_q, q_s, qdo_full, q0, bh);
      tma_load_tile<D>(&tm_do, do_s, qdo_full, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = R::stage(j);
        mbar_wait(&empty[s], R::empty_parity(j));
        mbar_arrive_expect_tx(&full[s], 2 * kTile);
        tma_load_tile<D>(&tm_k, kv_s + 2 * s * kTile, &full[s], j * kTileRows, bh);
        tma_load_tile<D>(&tm_v, kv_s + (2 * s + 1) * kTile, &full[s], j * kTileRows, bh);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2);  // query rows r0 and r0 + 8 of the tile
  const int c2 = 2 * (lane & 3);           // key (or head) columns 8 j + c2, + 1
  const float scale_log2 = scale * kLog2e;
  // The two rows' lse in log2 units and delta; queries past the sequence
  // get lse +inf (p = 0) and delta 0, and read nothing.
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    lse2[h] = row < t ? lse[row_base + row] * kLog2e : INFINITY;
    dl[h] = row < t ? delta[row_base + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
  mbar_wait(qdo_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = R::stage(j);
    const uint32_t k_addr = smem_u32(kv_s + 2 * s * kTile);
    const uint32_t v_addr = k_addr + kTile;
    mbar_wait(&full[s], R::full_parity(j));

    // S = Q K^T and dP = dO V^T: rows are queries, columns keys.
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(sc, kmajor_desc(q_addr, kk), kmajor_desc(k_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(dp, kmajor_desc(do_addr, kk), kmajor_desc(v_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp(S scale - lse), dS = P (dP - delta) scale.
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = exp2f(sc[i] * scale_log2 - lse2[(i >> 1) & 1]);
    // Only the diagonal tile crosses the causal mask, only a ragged last
    // tile the sequence's end, whose missing keys are zero rows of K: their
    // score 0 gives p = exp(-lse), which must be cut to 0.
    const int k0 = j * kTileRows;
    const bool diag = causal && k0 == q0;
    if (diag || k0 + kTileRows > t) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = q0 + r0 + (i & 2) * 4;
        const int col = k0 + 8 * (i >> 2) + c2 + (i & 1);
        if ((diag && col > row) || col >= t) sc[i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]) * scale;

    // dQ += dS K, dS as kDqTerms bf16 terms, K MN-major.
    uint32_t ds_parts[kDqTerms][4][4];
    split_fragment(dp, ds_parts);
    fence_regs(acc);
    fence_regs(ds_parts);
    wgmma_fence();
    wgmma_split_product(acc, ds_parts, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (row >= t) continue;
    bf16* dst = dq + (row_base + row) * D + c2;
#pragma unroll
    for (int jc = 0; jc < D / 8; ++jc)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jc) =
          __floats2bfloat162_rn(acc[4 * jc + 2 * h], acc[4 * jc + 2 * h + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int t, float scale,
                               int causal) {
  using namespace hopper;
  using R = Ring<kTcStages>;
  constexpr int kTile = tc_tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align_1024(smem_raw);
  uint8_t* v_s = k_s + kTile;
  uint8_t* qdo_s = v_s + kTile;  // stage s: Q at qdo_s + 2 s kTile, dO after it
  // Stage s's rows: lse in log2 units, then delta.
  float* rows_s = reinterpret_cast<float*>(qdo_s + 2 * kTcStages * kTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows_s + kTcStages * 2 * kTileRows);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kTcStages;

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // the first, heaviest causal tiles start first
  const int k0 = kt * kTileRows;
  const int nq = (t + kTileRows - 1) / kTileRows;
  // Causal: Q tiles strictly above the diagonal see none of these keys.
  const int qt0 = causal ? kt : 0;
  const int n_tiles = nq - qt0;
  const int64_t row_base = (int64_t)bh * t;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA lane's expect_tx, then all 32 lanes
      mbar_init(&empty[s], kTcConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {  // the producer warp
    const int lane = threadIdx.x - kTcConsumers;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * kTile);
      tma_load_tile<D>(&tm_k, k_s, kv_full, k0, bh);
      tma_load_tile<D>(&tm_v, v_s, kv_full, k0, bh);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = R::stage(j);
      const int q0 = (qt0 + j) * kTileRows;
      mbar_wait(&empty[s], R::empty_parity(j));
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * kTile);
        tma_load_tile<D>(&tm_q, qdo_s + 2 * s * kTile, &full[s], q0, bh);
        tma_load_tile<D>(&tm_do, qdo_s + (2 * s + 1) * kTile, &full[s], q0, bh);
      }
      // Queries past the sequence get lse +inf (p = 0) and delta 0.
      float* lse2 = rows_s + s * 2 * kTileRows;
      for (int r = lane; r < kTileRows; r += 32) {
        const int row = q0 + r;
        lse2[r] = row < t ? lse[row_base + row] * kLog2e : INFINITY;
        lse2[kTileRows + r] = row < t ? delta[row_base + row] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2);  // key rows r0 and r0 + 8 of the tile
  const int c2 = 2 * (lane & 3);           // query (or head) columns 8 j + c2, + 1
  const float scale_log2 = scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  mbar_wait(kv_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = R::stage(j);
    const int q0 = (qt0 + j) * kTileRows;
    const uint32_t q_addr = smem_u32(qdo_s + 2 * s * kTile);
    const uint32_t do_addr = q_addr + kTile;
    const float* lse2 = rows_s + s * 2 * kTileRows;
    const float* dl = lse2 + kTileRows;
    mbar_wait(&full[s], R::full_parity(j));

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries.
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(st, kmajor_desc(k_addr, kk), kmajor_desc(q_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(dpt, kmajor_desc(v_addr, kk), kmajor_desc(do_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale.
    const bool diag = causal && q0 == k0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + c2 + (i & 1);
      float p = exp2f(st[i] * scale_log2 - lse2[col]);
      if (diag && col < r0 + (i & 2) * 4) p = 0.f;  // query before key
      st[i] = p;
      dpt[i] = p * (dpt[i] - dl[col]) * scale;
    }

    // dV += P^T dO, then dK += dS^T Q, each f32 operand as three bf16
    // terms; dS is split while the dV products run.
    uint32_t p_parts[kBwdTerms][4][4];
    split_fragment(st, p_parts);
    fence_regs(dv_acc);
    fence_regs(p_parts);
    wgmma_fence();
    wgmma_split_product(dv_acc, p_parts, do_addr);
    wgmma_commit();
    uint32_t ds_parts[kBwdTerms][4][4];
    split_fragment(dpt, ds_parts);
    fence_regs(dk_acc);
    fence_regs(ds_parts);
    wgmma_fence();
    wgmma_split_product(dk_acc, ds_parts, q_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + r0 + 8 * h;
    if (row >= t) continue;
    const int64_t off = (row_base + row) * D + c2;
#pragma unroll
    for (int jc = 0; jc < D / 8; ++jc) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * jc) =
          __floats2bfloat162_rn(dk_acc[4 * jc + 2 * h], dk_acc[4 * jc + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * jc) =
          __floats2bfloat162_rn(dv_acc[4 * jc + 2 * h], dv_acc[4 * jc + 2 * h + 1]);
    }
  }
}

// Encode one tile map per operand; 0 or the first error.
inline int tile_maps(std::initializer_list<std::pair<CUtensorMap*, const void*>> maps, int bh,
                     int t, int d) {
  for (const auto& m : maps) {
    if (reinterpret_cast<uintptr_t>(m.second) % 16) return (int)cudaErrorInvalidValue;
    const int err = hopper::bf16_tile_map(m.first, m.second, bh, t, d);
    if (err) return err;
  }
  return 0;
}

template <int D>
int launch_fwd_wgmma(int device, const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int t, float scale, int causal, cudaStream_t stream) {
  const int nq = (t + kFwdWarpgroups * hopper::kTileRows - 1) / (kFwdWarpgroups * hopper::kTileRows);
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err = tile_maps({{&mq, q}, {&mk, k}, {&mv, v}}, bh, t, D);
  if (err) return err;
  constexpr size_t smem = fwd_wgmma_smem<D>();
  static std::atomic<bool> ready[kMaxDevices];
  err = (int)prepare(flash_fwd_wgmma_kernel<D>, smem, device, ready);
  if (err) return err;
  flash_fwd_wgmma_kernel<D><<<dim3(bh, nq), kFwdThreads, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), t, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_wgmma(int device, const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int bh, int t, float scale,
                    int causal, cudaStream_t stream) {
  const int nq = (t + hopper::kTileRows - 1) / hopper::kTileRows;
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  int err = tile_maps({{&mq, q}, {&mk, k}, {&mv, v}, {&mdo, dout}}, bh, t, D);
  if (err) return err;
  constexpr size_t smem = dq_wgmma_smem<D>();
  static std::atomic<bool> ready[kMaxDevices];
  err = (int)prepare(flash_bwd_dq_wgmma_kernel<D>, smem, device, ready);
  if (err) return err;
  flash_bwd_dq_wgmma_kernel<D><<<dim3(bh, nq), kTcThreads, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), t, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(int device, const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int bh, int t,
                     float scale, int causal, cudaStream_t stream) {
  const int nk = (t + hopper::kTileRows - 1) / hopper::kTileRows;
  if (nk > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  int err = tile_maps({{&mq, q}, {&mk, k}, {&mv, v}, {&mdo, dout}}, bh, t, D);
  if (err) return err;
  constexpr size_t smem = dkv_wgmma_smem<D>();
  static std::atomic<bool> ready[kMaxDevices];
  err = (int)prepare(flash_bwd_dkv_wgmma_kernel<D>, smem, device, ready);
  if (err) return err;
  flash_bwd_dkv_wgmma_kernel<D><<<dim3(bh, nk), kTcThreads, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), t, scale, causal);
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

// The tensor-core variants: bf16 only, d 64 or 128, 16-byte-aligned bases.
extern "C" int mdt_flash_fwd_wgmma(int device, const void* q, const void* k, const void* v,
                                   void* o, void* lse, int bh, int t, int d, float scale,
                                   int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd_wgmma<64>(device, q, k, v, o, lse, bh, t, scale, causal, st);
  if (d == 128) return launch_fwd_wgmma<128>(device, q, k, v, o, lse, bh, t, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mdt_flash_bwd_dq_wgmma(int device, const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int bh, int t, int d, float scale, int causal,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dq_wgmma<64>(device, q, k, v, dout, lse, delta, dq, bh, t, scale, causal, st);
  if (d == 128)
    return launch_dq_wgmma<128>(device, q, k, v, dout, lse, delta, dq, bh, t, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mdt_flash_bwd_dkv_wgmma(int device, const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int t, int d, float scale,
                                       int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dkv_wgmma<64>(device, q, k, v, dout, lse, delta, dk, dv, bh, t, scale, causal, st);
  if (d == 128)
    return launch_dkv_wgmma<128>(device, q, k, v, dout, lse, delta, dk, dv, bh, t, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int wgmma_smem(int kernel) {
  switch (kernel) {
    case 0: return (int)fwd_wgmma_smem<D>();
    case 1: return (int)dq_wgmma_smem<D>();
    case 2: return (int)dkv_wgmma_smem<D>();
    default: return -1;
  }
}

// The dynamic shared memory a tensor-core launch asks for, in bytes, of
// kernel 0 (flash_fwd), 1 (flash_bwd_dq) or 2 (flash_bwd_dkv); -1 for
// another kernel or a head dim without a variant.
extern "C" int mdt_flash_wgmma_smem(int kernel, int d) {
  if (d == 64) return wgmma_smem<64>(kernel);
  if (d == 128) return wgmma_smem<128>(kernel);
  return -1;
}

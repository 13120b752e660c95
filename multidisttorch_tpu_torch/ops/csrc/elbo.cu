// Fused negative-ELBO forward and backward kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of multidisttorch_tpu/ops/pallas_elbo.py:
//   elbo_fwd: _fwd_kernel, launched by _fwd (pallas_call at :134);
//   elbo_bwd: _bwd_kernel, launched by _bwd (pallas_call at :163);
// and the same two for K stacked trials in one launch each
// (elbo_fwd_lanes_kernel, elbo_bwd_lanes_kernel, after the launchers below).
//
// What bounds them: the launch and the dependent chain, not bytes. At the
// main path's shape (batch 128, 784 pixels, latent 20, f32) the forward
// reads 823,296 B, about 0.25 us at 3.35 TB/s, and the backward reads the
// same and writes 421,888 B, about 0.37 us; an empty launch alone takes
// about 0.9 us on the device. So each call is one launch, with nothing that
// a CUDA-graph replay would have to reset, and a short chain of dependent
// steps inside it:
//   - the work is one flat index space of 8-element vector steps: the wide
//     (B*D) logits/x steps, then the narrow (B*L) mu/logvar steps. Thread t
//     of S takes steps t, t+S, ... in rounds of kSteps, and issues every
//     16-byte load of a round before any arithmetic or synchronisation;
//     scalar tails cover ragged lengths, and a scalar path unaligned views;
//   - f32 math whatever the storage type, accumulated in registers;
//   - forward: ONE grid launch, up to four CTAs of 128 threads per SM (one
//     vector step per thread at the main path's shape). Each CTA reduces
//     in-block with warp shuffles, writes its partial to a workspace, and
//     takes a ticket on an integer counter there; the CTA that takes the
//     last ticket sums the partials in index order and sets the counter
//     back to 0. No float atomics, and the sum's order does not depend on
//     which CTA is last, so a rerun and every replay give the same bits;
//     the counter resets itself, so a replay needs no memset. (The TPU
//     kernel carried its sum across a sequential grid in SMEM; Hopper's
//     CTAs run in no order.) Two launches must never share a workspace at
//     the same time: the wrapper gives each stream one, and each captured
//     CUDA graph one of its own.
//   - backward: one elementwise launch, sized for one vector step per
//     thread at the main path's shape; it reads the upstream cotangent g
//     from device memory (no host sync) after its other loads are issued,
//     and folds it in before the single rounding to each primal's type.
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

// Threads of a CTA: the forward's grid, the backward's.
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
// Elements per vector step: one 16-byte load of bf16, two of f32.
constexpr int kVec = 8;
// Vector steps per thread whose loads are all issued before any arithmetic.
constexpr int kSteps = 2;

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

// One vector step of one operand in registers, as loaded: two 16-byte
// loads of f32, one of bf16 (b unused). Wide and narrow steps share it.
struct Raw {
  uint4 a, b;
};

__device__ __forceinline__ void load_raw(const float* p, Raw& r) {
  r.a = __ldg(reinterpret_cast<const uint4*>(p));
  r.b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
}
__device__ __forceinline__ void load_raw(const bf16* p, Raw& r) {
  r.a = __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void unpack(const Raw& r, float (&v)[kVec]);
template <>
__device__ __forceinline__ void unpack<float>(const Raw& r, float (&v)[kVec]) {
  v[0] = __uint_as_float(r.a.x); v[1] = __uint_as_float(r.a.y);
  v[2] = __uint_as_float(r.a.z); v[3] = __uint_as_float(r.a.w);
  v[4] = __uint_as_float(r.b.x); v[5] = __uint_as_float(r.b.y);
  v[6] = __uint_as_float(r.b.z); v[7] = __uint_as_float(r.b.w);
}
template <>
__device__ __forceinline__ void unpack<bf16>(const Raw& r, float (&v)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
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
__device__ __forceinline__ float bce_term(float l, float x) {
  return fmaxf(l, 0.f) - l * x + log1pf(expf(-fabsf(l)));
}
// The summand of the Gaussian KL: 1 + logvar - mu^2 - exp(logvar).
__device__ __forceinline__ float kl_term(float m, float lv) {
  return 1.f + lv - m * m - expf(lv);
}

// The operands of one call, with the vector-step counts of the flat index
// space: steps [0, n_vw) are wide, [n_vw, n_vw + n_vn) narrow.
template <typename TL, typename TX, typename TM, typename TV>
struct Operands {
  const TL* logits;
  const TX* x;
  const TM* mu;
  const TV* logvar;
  int64_t n_wide, n_narrow;  // elements
  int64_t n_vw, n_vn;        // vector steps (0 on the scalar path)
};

// The loads of one round: vector steps base, base+S, ..., (kSteps of them);
// a wide step loads (logits, x), a narrow one (mu, logvar), one past the end
// nothing.
template <typename TL, typename TX, typename TM, typename TV>
__device__ __forceinline__ void load_round(const Operands<TL, TX, TM, TV>& op, int64_t base,
                                           int64_t S, Raw (&ra)[kSteps], Raw (&rb)[kSteps]) {
  const int64_t n_steps = op.n_vw + op.n_vn;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t i = base + s * S;
    if (i < op.n_vw) {
      load_raw(op.logits + i * kVec, ra[s]);
      load_raw(op.x + i * kVec, rb[s]);
    } else if (i < n_steps) {
      const int64_t j = i - op.n_vw;
      load_raw(op.mu + j * kVec, ra[s]);
      load_raw(op.logvar + j * kVec, rb[s]);
    }
  }
}

// Thread t of S's share of the forward: sum of the BCE terms and of the KL
// summands over its vector steps t, t+S, ..., in that order, then over its
// elements of the scalar tails; returns bce + beta * -0.5 * kl.
template <typename TL, typename TX, typename TM, typename TV>
__device__ __forceinline__ float fwd_thread_part(const Operands<TL, TX, TM, TV>& op,
                                                 float beta, int64_t t, int64_t S) {
  const int64_t n_steps = op.n_vw + op.n_vn;
  float bce = 0.f, kl = 0.f;
  for (int64_t base = t; base < n_steps; base += kSteps * S) {
    // Every load of the round first: wide steps load (logits, x), narrow
    // ones (mu, logvar), past the end nothing.
    Raw ra[kSteps], rb[kSteps];
    load_round(op, base, S, ra, rb);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int64_t i = base + s * S;
      float a[kVec], b[kVec];
      if (i < op.n_vw) {
        unpack<TL>(ra[s], a);
        unpack<TX>(rb[s], b);
#pragma unroll
        for (int k = 0; k < kVec; ++k) bce += bce_term(a[k], b[k]);
      } else if (i < n_steps) {
        unpack<TM>(ra[s], a);
        unpack<TV>(rb[s], b);
#pragma unroll
        for (int k = 0; k < kVec; ++k) kl += kl_term(a[k], b[k]);
      }
    }
  }
  for (int64_t j = op.n_vw * kVec + t; j < op.n_wide; j += S)
    bce += bce_term(to_f32(op.logits[j]), to_f32(op.x[j]));
  for (int64_t j = op.n_vn * kVec + t; j < op.n_narrow; j += S)
    kl += kl_term(to_f32(op.mu[j]), to_f32(op.logvar[j]));
  return bce + beta * (-0.5f * kl);
}

// Sum of v over a CTA of kBlock threads, in a fixed order (warp shuffles,
// then warp 0 over the warps' sums in `warp_sums`, kBlock/32 floats of
// shared memory); the result is valid in thread 0.
template <int kBlock>
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  static_assert(kBlock % 32 == 0 && kBlock <= 1024, "one warp sums the warps");
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kBlock / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The forward as one grid launch of kFwdThreads-thread CTAs. ws is the
// stream's workspace: ws[0] the ticket counter (0 between launches), then
// one float partial per CTA.
template <typename TL, typename TX, typename TM, typename TV>
__global__ void __launch_bounds__(kFwdThreads)
    elbo_fwd_kernel(Operands<TL, TX, TM, TV> op, float beta, unsigned* ws, float* out) {
  __shared__ float warp_sums[kFwdThreads / 32];
  __shared__ bool last;
  const int64_t S = (int64_t)gridDim.x * kFwdThreads;
  const int64_t t = (int64_t)blockIdx.x * kFwdThreads + threadIdx.x;
  const float part = block_sum<kFwdThreads>(fwd_thread_part(op, beta, t, S), warp_sums);
  float* partials = reinterpret_cast<float*>(ws + 1);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = part;
    __threadfence();  // the partial is visible before the ticket is
    last = atomicAdd(ws, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last CTA: every other CTA's partial is visible from here. Sum them
  // in index order (strided per thread, then the block's fixed tree).
  __threadfence();
  float acc = 0.f;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += kFwdThreads) acc += __ldcg(partials + i);
  __syncthreads();  // warp_sums is reused
  acc = block_sum<kFwdThreads>(acc, warp_sums);
  if (threadIdx.x == 0) {
    *out = acc;
    *ws = 0u;  // for the next launch on this workspace
  }
}

template <typename TL, typename TM, typename TV>
struct Cotangents {
  TL* dlogits;
  TM* dmu;
  TV* dlogvar;
};

// The backward over the same flat index space; thread t of S takes vector
// steps t, t+S, ... in rounds of kSteps: the round's loads, then g, then
// arithmetic and stores.
template <typename TL, typename TX, typename TM, typename TV>
__global__ void __launch_bounds__(kBwdThreads)
    elbo_bwd_kernel(Operands<TL, TX, TM, TV> op, Cotangents<TL, TM, TV> ct,
                    float beta, const float* g_ptr) {
  const int64_t S = (int64_t)gridDim.x * kBwdThreads;
  const int64_t t = (int64_t)blockIdx.x * kBwdThreads + threadIdx.x;
  const int64_t n_steps = op.n_vw + op.n_vn;
  bool have_g = false;
  float g = 0.f;
  for (int64_t base = t; base < n_steps; base += kSteps * S) {
    Raw ra[kSteps], rb[kSteps];
    load_round(op, base, S, ra, rb);
    if (!have_g) {
      g = *g_ptr;
      have_g = true;
    }
    const float gb = g * beta;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int64_t i = base + s * S;
      float a[kVec], b[kVec], o[kVec];
      if (i < op.n_vw) {
        unpack<TL>(ra[s], a);
        unpack<TX>(rb[s], b);
#pragma unroll
        for (int k = 0; k < kVec; ++k) o[k] = g * (1.f / (1.f + expf(-a[k])) - b[k]);
        store8(ct.dlogits + i * kVec, o);
      } else if (i < n_steps) {
        const int64_t j = i - op.n_vw;
        unpack<TM>(ra[s], a);
        unpack<TV>(rb[s], b);
#pragma unroll
        for (int k = 0; k < kVec; ++k) o[k] = gb * a[k];
        store8(ct.dmu + j * kVec, o);
#pragma unroll
        for (int k = 0; k < kVec; ++k) o[k] = gb * 0.5f * (expf(b[k]) - 1.f);
        store8(ct.dlogvar + j * kVec, o);
      }
    }
  }
  // Scalar tails (and the whole of an unaligned operand pair).
  const int64_t w0 = op.n_vw * kVec + t, n0 = op.n_vn * kVec + t;
  if (w0 >= op.n_wide && n0 >= op.n_narrow) return;
  if (!have_g) g = *g_ptr;
  const float gb = g * beta;
  for (int64_t j = w0; j < op.n_wide; j += S) {
    const float l = to_f32(op.logits[j]);
    ct.dlogits[j] = from_f32<TL>(g * (1.f / (1.f + expf(-l)) - to_f32(op.x[j])));
  }
  for (int64_t j = n0; j < op.n_narrow; j += S) {
    ct.dmu[j] = from_f32<TM>(gb * to_f32(op.mu[j]));
    ct.dlogvar[j] = from_f32<TV>(gb * 0.5f * (expf(to_f32(op.logvar[j])) - 1.f));
  }
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename TL, typename TX, typename TM, typename TV>
__host__ __device__ Operands<TL, TX, TM, TV> operands(const void* logits, const void* x, const void* mu,
                                  const void* logvar, int64_t n_wide, int64_t n_narrow,
                                  bool vec_wide, bool vec_narrow) {
  Operands<TL, TX, TM, TV> op;
  op.logits = static_cast<const TL*>(logits);
  op.x = static_cast<const TX*>(x);
  op.mu = static_cast<const TM*>(mu);
  op.logvar = static_cast<const TV*>(logvar);
  op.n_wide = n_wide;
  op.n_narrow = n_narrow;
  op.n_vw = vec_wide ? n_wide / kVec : 0;
  op.n_vn = vec_narrow ? n_narrow / kVec : 0;
  return op;
}

template <typename TL, typename TX, typename TM, typename TV>
void launch_fwd(const void* logits, const void* x, const void* mu, const void* logvar,
                int64_t n_wide, int64_t n_narrow, float beta, int grid, unsigned* ws, float* out,
                cudaStream_t stream) {
  const auto op = operands<TL, TX, TM, TV>(logits, x, mu, logvar, n_wide, n_narrow,
                                           aligned16(logits) && aligned16(x),
                                           aligned16(mu) && aligned16(logvar));
  elbo_fwd_kernel<TL, TX, TM, TV><<<grid, kFwdThreads, 0, stream>>>(op, beta, ws, out);
}

template <typename TL, typename TX, typename TM, typename TV>
void launch_bwd(const void* logits, const void* x, const void* mu, const void* logvar,
                int64_t n_wide, int64_t n_narrow, float beta, const float* g, void* dlogits,
                void* dmu, void* dlogvar, int grid, cudaStream_t stream) {
  const auto op = operands<TL, TX, TM, TV>(
      logits, x, mu, logvar, n_wide, n_narrow,
      aligned16(logits) && aligned16(x) && aligned16(dlogits),
      aligned16(mu) && aligned16(logvar) && aligned16(dmu) && aligned16(dlogvar));
  Cotangents<TL, TM, TV> ct{static_cast<TL*>(dlogits), static_cast<TM*>(dmu),
                            static_cast<TV*>(dlogvar)};
  elbo_bwd_kernel<TL, TX, TM, TV><<<grid, kBwdThreads, 0, stream>>>(op, ct, beta, g);
}

// ---- Lane-batched kernels: K same-shape trials in one launch each ----
//
// The stacked train step (K trials as one program, train/steps.py) takes the
// ELBO of (K, B, D) logits/x and (K, B, L) mu/logvar with a beta per lane,
// and wants K sums. Each lane is one single-trial problem, so each kernel
// runs the single-trial kernel's work once per lane: gridDim.y = K lanes,
// blockIdx.y the lane, gridDim.x the single-trial grid of one lane's
// (B, D) + (B, L) slices. Lane k thus computes exactly what one
// elbo_fwd/elbo_bwd launch computes on its slices (the same threads, steps,
// order and combine), so a stacked trial's loss and cotangents equal its
// unstacked twin's bits wherever the slices' alignment agrees. beta[k] and
// the cotangent g[k] are read from device memory, so one captured CUDA graph
// serves every mix of lanes and hypers. What bounds them is the same as
// above: at K 8, B 128, f32 the forward reads 6.59 MB (about 2 us at
// 3.35 TB/s), so K lanes in one launch pay one launch instead of K.
//
// The forward's workspace holds K ticket counters (0 between launches),
// then K rows of gridDim.x float partials: each lane combines its own
// partials in index order, in its last CTA, and sets its counter back to 0.

// Lane k's operands: the k-th slices, each pair on the vector path where
// lane k's pointers are 16-byte aligned (and the cotangents', `out_w` and
// `out_n`, for the backward), else on the scalar path.
template <typename TL, typename TX, typename TM, typename TV>
__device__ __forceinline__ Operands<TL, TX, TM, TV> lane_operands(
    const Operands<TL, TX, TM, TV>& all, int64_t k, bool out_w, bool out_n) {
  const TL* l = all.logits + k * all.n_wide;
  const TX* x = all.x + k * all.n_wide;
  const TM* m = all.mu + k * all.n_narrow;
  const TV* v = all.logvar + k * all.n_narrow;
  return operands<TL, TX, TM, TV>(l, x, m, v, all.n_wide, all.n_narrow,
                                  out_w && aligned16(l) && aligned16(x),
                                  out_n && aligned16(m) && aligned16(v));
}

// `all` holds the (K, ...) bases and one lane's element counts.
template <typename TL, typename TX, typename TM, typename TV>
__global__ void __launch_bounds__(kFwdThreads)
    elbo_fwd_lanes_kernel(Operands<TL, TX, TM, TV> all, const float* beta, unsigned* ws,
                          float* out) {
  __shared__ float warp_sums[kFwdThreads / 32];
  __shared__ bool lane_done;
  const int64_t k = blockIdx.y;
  const auto op = lane_operands(all, k, true, true);
  const int64_t S = (int64_t)gridDim.x * kFwdThreads;
  const int64_t t = (int64_t)blockIdx.x * kFwdThreads + threadIdx.x;
  const float part = block_sum<kFwdThreads>(fwd_thread_part(op, beta[k], t, S), warp_sums);
  unsigned* ticket = ws + k;
  float* partials = reinterpret_cast<float*>(ws + gridDim.y) + k * gridDim.x;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = part;
    __threadfence();  // this lane's partial is visible before its ticket
    lane_done = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!lane_done) return;
  __threadfence();  // the lane's last CTA: its other partials are visible from here
  float acc = 0.f;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += kFwdThreads) acc += __ldcg(partials + i);
  __syncthreads();  // warp_sums is reused
  acc = block_sum<kFwdThreads>(acc, warp_sums);
  if (threadIdx.x == 0) {
    out[k] = acc;
    *ticket = 0u;  // for the next launch on this workspace
  }
}

// The backward of lane blockIdx.y: elbo_bwd_kernel's loop on the lane's
// slices, with g[k] and beta[k].
template <typename TL, typename TX, typename TM, typename TV>
__global__ void __launch_bounds__(kBwdThreads)
    elbo_bwd_lanes_kernel(Operands<TL, TX, TM, TV> all, Cotangents<TL, TM, TV> cts,
                          const float* beta_lanes, const float* g_lanes) {
  const int64_t k = blockIdx.y;
  const Cotangents<TL, TM, TV> ct{cts.dlogits + k * all.n_wide, cts.dmu + k * all.n_narrow,
                                  cts.dlogvar + k * all.n_narrow};
  const auto op = lane_operands(all, k, aligned16(ct.dlogits),
                                aligned16(ct.dmu) && aligned16(ct.dlogvar));
  const float beta = beta_lanes[k];
  const int64_t S = (int64_t)gridDim.x * kBwdThreads;
  const int64_t t = (int64_t)blockIdx.x * kBwdThreads + threadIdx.x;
  const int64_t n_steps = op.n_vw + op.n_vn;
  bool have_g = false;
  float g = 0.f;
  for (int64_t base = t; base < n_steps; base += kSteps * S) {
    Raw ra[kSteps], rb[kSteps];
    load_round(op, base, S, ra, rb);
    if (!have_g) {
      g = g_lanes[k];
      have_g = true;
    }
    const float gb = g * beta;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int64_t i = base + s * S;
      float a[kVec], b[kVec], o[kVec];
      if (i < op.n_vw) {
        unpack<TL>(ra[s], a);
        unpack<TX>(rb[s], b);
#pragma unroll
        for (int e = 0; e < kVec; ++e) o[e] = g * (1.f / (1.f + expf(-a[e])) - b[e]);
        store8(ct.dlogits + i * kVec, o);
      } else if (i < n_steps) {
        const int64_t j = i - op.n_vw;
        unpack<TM>(ra[s], a);
        unpack<TV>(rb[s], b);
#pragma unroll
        for (int e = 0; e < kVec; ++e) o[e] = gb * a[e];
        store8(ct.dmu + j * kVec, o);
#pragma unroll
        for (int e = 0; e < kVec; ++e) o[e] = gb * 0.5f * (expf(b[e]) - 1.f);
        store8(ct.dlogvar + j * kVec, o);
      }
    }
  }
  const int64_t w0 = op.n_vw * kVec + t, n0 = op.n_vn * kVec + t;
  if (w0 >= op.n_wide && n0 >= op.n_narrow) return;
  if (!have_g) g = g_lanes[k];
  const float gb = g * beta;
  for (int64_t j = w0; j < op.n_wide; j += S) {
    const float l = to_f32(op.logits[j]);
    ct.dlogits[j] = from_f32<TL>(g * (1.f / (1.f + expf(-l)) - to_f32(op.x[j])));
  }
  for (int64_t j = n0; j < op.n_narrow; j += S) {
    ct.dmu[j] = from_f32<TM>(gb * to_f32(op.mu[j]));
    ct.dlogvar[j] = from_f32<TV>(gb * 0.5f * (expf(to_f32(op.logvar[j])) - 1.f));
  }
}

template <typename TL, typename TX, typename TM, typename TV>
void launch_fwd_lanes(const void* logits, const void* x, const void* mu, const void* logvar,
                      int64_t n_wide, int64_t n_narrow, int lanes, const float* beta, int grid,
                      unsigned* ws, float* out, cudaStream_t stream) {
  const auto all = operands<TL, TX, TM, TV>(logits, x, mu, logvar, n_wide, n_narrow, false, false);
  elbo_fwd_lanes_kernel<TL, TX, TM, TV><<<dim3(grid, lanes), kFwdThreads, 0, stream>>>(
      all, beta, ws, out);
}

template <typename TL, typename TX, typename TM, typename TV>
void launch_bwd_lanes(const void* logits, const void* x, const void* mu, const void* logvar,
                      int64_t n_wide, int64_t n_narrow, int lanes, const float* beta,
                      const float* g, void* dlogits, void* dmu, void* dlogvar, int grid,
                      cudaStream_t stream) {
  const auto all = operands<TL, TX, TM, TV>(logits, x, mu, logvar, n_wide, n_narrow, false, false);
  Cotangents<TL, TM, TV> ct{static_cast<TL*>(dlogits), static_cast<TM*>(dmu),
                            static_cast<TV*>(dlogvar)};
  elbo_bwd_lanes_kernel<TL, TX, TM, TV><<<dim3(grid, lanes), kBwdThreads, 0, stream>>>(
      all, ct, beta, g);
}

// Selects `device` for the launch if it is not current, and puts the
// caller's device back when it goes out of scope.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    else prev = -1;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// One case per dtype code (bit 0 logits, bit 1 x, bit 2 mu, bit 3 logvar).
#define MDT_ELBO_DISPATCH(FN, ...)                            \
  switch (dtypes) {                                           \
    case 0: FN<f32, f32, f32, f32>(__VA_ARGS__); break;       \
    case 1: FN<bf16, f32, f32, f32>(__VA_ARGS__); break;      \
    case 2: FN<f32, bf16, f32, f32>(__VA_ARGS__); break;      \
    case 3: FN<bf16, bf16, f32, f32>(__VA_ARGS__); break;     \
    case 4: FN<f32, f32, bf16, f32>(__VA_ARGS__); break;      \
    case 5: FN<bf16, f32, bf16, f32>(__VA_ARGS__); break;     \
    case 6: FN<f32, bf16, bf16, f32>(__VA_ARGS__); break;     \
    case 7: FN<bf16, bf16, bf16, f32>(__VA_ARGS__); break;    \
    case 8: FN<f32, f32, f32, bf16>(__VA_ARGS__); break;      \
    case 9: FN<bf16, f32, f32, bf16>(__VA_ARGS__); break;     \
    case 10: FN<f32, bf16, f32, bf16>(__VA_ARGS__); break;    \
    case 11: FN<bf16, bf16, f32, bf16>(__VA_ARGS__); break;   \
    case 12: FN<f32, f32, bf16, bf16>(__VA_ARGS__); break;    \
    case 13: FN<bf16, f32, bf16, bf16>(__VA_ARGS__); break;   \
    case 14: FN<f32, bf16, bf16, bf16>(__VA_ARGS__); break;   \
    case 15: FN<bf16, bf16, bf16, bf16>(__VA_ARGS__); break;  \
    default: return (int)cudaErrorInvalidValue;               \
  }

// Summed negative ELBO into out (one f32): `grid` CTAs of 128 threads with
// the workspace `ws` (a zero counter, then `grid` floats), which no other
// launch uses until this one has finished.
extern "C" int mdt_elbo_fwd(int device, const void* logits, const void* x,
                            const void* mu, const void* logvar, int64_t n_wide,
                            int64_t n_narrow, int dtypes, float beta, int grid, void* ws,
                            void* out, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  MDT_ELBO_DISPATCH(launch_fwd, logits, x, mu, logvar, n_wide, n_narrow, beta, grid,
                    static_cast<unsigned*>(ws), static_cast<float*>(out),
                    static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Cotangents of the summed negative ELBO, scaled by the f32 cotangent at g,
// each written in its primal's dtype; `grid` CTAs of 256 threads.
extern "C" int mdt_elbo_bwd(int device, const void* logits, const void* x,
                            const void* mu, const void* logvar, int64_t n_wide,
                            int64_t n_narrow, int dtypes, float beta, const void* g,
                            void* dlogits, void* dmu, void* dlogvar, int grid,
                            void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  MDT_ELBO_DISPATCH(launch_bwd, logits, x, mu, logvar, n_wide, n_narrow, beta,
                    static_cast<const float*>(g), dlogits, dmu, dlogvar, grid,
                    static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The lane-batched forward: out[k] = the summed negative ELBO of lane k's
// (B, D) and (B, L) slices (n_wide and n_narrow elements each) with
// beta[k]; a grid of `grid` x `lanes` CTAs of 128 threads and the workspace
// `ws` (`lanes` zero counters, then lanes x grid floats), which no other
// launch uses until this one has finished.
extern "C" int mdt_elbo_fwd_lanes(int device, const void* logits, const void* x,
                                  const void* mu, const void* logvar, int64_t n_wide,
                                  int64_t n_narrow, int lanes, int dtypes, const void* beta,
                                  int grid, void* ws, void* out, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  MDT_ELBO_DISPATCH(launch_fwd_lanes, logits, x, mu, logvar, n_wide, n_narrow, lanes,
                    static_cast<const float*>(beta), grid, static_cast<unsigned*>(ws),
                    static_cast<float*>(out), static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The lane-batched backward: each lane's cotangents scaled by g[k], with
// beta[k]; a grid of `grid` x `lanes` CTAs of 256 threads.
extern "C" int mdt_elbo_bwd_lanes(int device, const void* logits, const void* x,
                                  const void* mu, const void* logvar, int64_t n_wide,
                                  int64_t n_narrow, int lanes, int dtypes, const void* beta,
                                  const void* g, void* dlogits, void* dmu, void* dlogvar,
                                  int grid, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  MDT_ELBO_DISPATCH(launch_bwd_lanes, logits, x, mu, logvar, n_wide, n_narrow, lanes,
                    static_cast<const float*>(beta), static_cast<const float*>(g), dlogits, dmu,
                    dlogvar, grid, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

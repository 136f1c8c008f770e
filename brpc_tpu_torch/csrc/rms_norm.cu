// K3: RMSNorm over the last axis, out = T(x32 * rsqrt(mean(x32^2) + eps) * g),
// and its fused form with the residual add before it (`add_rms_norm`).
//
// Replaces: brpc_tpu/models/transformer.py:102 `_rms_norm` (XLA-fused in the
// JAX package; run 2L+1 times per decode step and per prefill).
// Bound on the card: bytes. Each row is read once and written once
// (2 x rows x D x sizeof(T), plus D floats of gain) against the H100 SXM's
// 3.35 TB/s (data sheet, 700 W power limit); the
// arithmetic is a few operations per element.
// Design: one block per row, 256 threads striding the row (coalesced), the
// sum of squares in f32 reduced through warp shuffles and one shared-memory
// pass, then a second sweep that scales and casts on store. The row is read
// twice; at D = 4096 the second read hits L1/L2, so device memory sees it
// once. Math follows the reference: f32 throughout, mean as sum / D, the
// correctly rounded 1 / sqrtf (no fast-math rsqrt), (x * scale) * g.
//
// add_rms_norm: every norm of a forward but the first follows a residual
// add (x + attention out before ln_mlp, x + MLP out before the next
// ln_attn or ln_out), which the JAX package leaves to XLA to fuse. Alone,
// the add is one more launch of a few microseconds on ~64 KB (8 decode rows
// at D 4096), which is what the step pays: both are launch-bound. The fused
// kernel reads x and delta once with 16-byte loads, rounds the sum to T as
// torch's `x + delta` does (f32 add, round to nearest even), writes it out
// as the new residual stream s, keeps the rounded row in registers (D 4096:
// 16 values a thread), and writes h = T(s32 * rsqrt(mean(s32^2) + eps) * g)
// in the same pass. Bound: bytes, 2 reads and 2 writes of the row.
#include "rms_norm.cuh"

namespace brpc_tpu_torch {
namespace {

using norm::block_sum;
using norm::Chunk16;
using norm::kNormThreads;

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    rms_norm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                    T* __restrict__ out, int d, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* outr = out + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kNormThreads) {
    const float v = to_f32<T>(xr[i]);
    ss += v * v;
  }
  const float scale =
      1.0f / sqrtf(block_sum(ss) / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kNormThreads) {
    outr[i] = from_f32<T>(to_f32<T>(xr[i]) * scale * g[i]);
  }
}

// One block per row; thread t holds chunks t, t + 256, ... (kChunks of
// them, 16 bytes each) in registers between the sum and the scaling.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kNormThreads)
    add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                        const float* __restrict__ g, T* __restrict__ s_out,
                        T* __restrict__ h_out, int d, float eps) {
  using C = Chunk16<T>;
  constexpr int kN = C::kN;
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const int n_chunks = d / kN;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  const uint4* dr = reinterpret_cast<const uint4*>(delta + base);
  uint4* sr = reinterpret_cast<uint4*>(s_out + base);
  uint4* hr = reinterpret_cast<uint4*>(h_out + base);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float v[kChunks][kN];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int ch = threadIdx.x + c * kNormThreads;
#pragma unroll
    for (int e = 0; e < kN; ++e) v[c][e] = 0.f;
    if (ch >= n_chunks) continue;
    float a[kN], b[kN];
    C::unpack(xr[ch], a);
    C::unpack(dr[ch], b);
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      v[c][e] = round_to<T>(a[e] + b[e]);
      ss += v[c][e] * v[c][e];
    }
    sr[ch] = C::pack(v[c]);  // already in T: packed exactly
  }
  const float scale =
      1.0f / sqrtf(block_sum(ss) / static_cast<float>(d) + eps);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int ch = threadIdx.x + c * kNormThreads;
    if (ch >= n_chunks) continue;
    float h[kN];
#pragma unroll
    for (int e4 = 0; e4 < kN / 4; ++e4) {
      const float4 gg = g4[ch * (kN / 4) + e4];
      h[4 * e4] = v[c][4 * e4] * scale * gg.x;
      h[4 * e4 + 1] = v[c][4 * e4 + 1] * scale * gg.y;
      h[4 * e4 + 2] = v[c][4 * e4 + 2] * scale * gg.z;
      h[4 * e4 + 3] = v[c][4 * e4 + 3] * scale * gg.w;
    }
    hr[ch] = C::pack(h);
  }
}

template <typename T>
int launch_add(const void* x, const void* delta, const float* g, void* s,
               void* h, long long rows, int d, float eps,
               cudaStream_t stream) {
  constexpr int kN = Chunk16<T>::kN;
  if (d % kN != 0) return cudaErrorInvalidValue;
  const int per_thread = (d / kN + kNormThreads - 1) / kNormThreads;
  const dim3 grid(static_cast<unsigned>(rows));
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(delta);
  T* st = static_cast<T*>(s);
  T* ht = static_cast<T*>(h);
  if (per_thread <= 1)
    add_rms_norm_kernel<T, 1><<<grid, kNormThreads, 0, stream>>>(
        xt, dt, g, st, ht, d, eps);
  else if (per_thread <= 2)
    add_rms_norm_kernel<T, 2><<<grid, kNormThreads, 0, stream>>>(
        xt, dt, g, st, ht, d, eps);
  else if (per_thread <= 4)
    add_rms_norm_kernel<T, 4><<<grid, kNormThreads, 0, stream>>>(
        xt, dt, g, st, ht, d, eps);
  else if (per_thread <= 8)
    add_rms_norm_kernel<T, 8><<<grid, kNormThreads, 0, stream>>>(
        xt, dt, g, st, ht, d, eps);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace brpc_tpu_torch

// x, out: [rows, d] contiguous in `dtype`; g: [d] float32.
extern "C" int brpc_rms_norm(int dtype, const void* x, const float* g,
                             void* out, long long rows, int d, float eps,
                             void* stream) {
  using namespace brpc_tpu_torch;
  if (rows <= 0) return 0;
  if (d <= 0 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  if (dtype == kDtypeFloat32) {
    rms_norm_kernel<float><<<grid, kNormThreads, 0, s>>>(
        static_cast<const float*>(x), g, static_cast<float*>(out), d, eps);
  } else if (dtype == kDtypeBFloat16) {
    rms_norm_kernel<__nv_bfloat16><<<grid, kNormThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g,
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// s = T(x + delta) and h = rms_norm(s) in one pass. x, delta, s, h: [rows, d]
// contiguous in `dtype`; g: [d] float32; every pointer 16-byte aligned, d a
// multiple of 16 bytes' worth of elements (8 bf16, 4 f32) and at most
// 8 x 256 such chunks (d <= 16384 in bf16, 8192 in f32).
extern "C" int brpc_add_rms_norm(int dtype, const void* x, const void* delta,
                                 const float* g, void* s, void* h,
                                 long long rows, int d, float eps,
                                 void* stream) {
  using namespace brpc_tpu_torch;
  if (rows <= 0) return 0;
  if (d <= 0 || rows > 0x7fffffffLL || !aligned16(x) || !aligned16(delta) ||
      !aligned16(g) || !aligned16(s) || !aligned16(h))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeFloat32)
    return launch_add<float>(x, delta, g, s, h, rows, d, eps, st);
  if (dtype == kDtypeBFloat16)
    return launch_add<__nv_bfloat16>(x, delta, g, s, h, rows, d, eps, st);
  return cudaErrorInvalidValue;
}

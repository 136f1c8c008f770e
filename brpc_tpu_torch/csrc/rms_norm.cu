// K3: RMSNorm over the last axis, out = T(x32 * rsqrt(mean(x32^2) + eps) * g).
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
#include "common.cuh"

namespace brpc_tpu_torch {
namespace {

constexpr int kNormThreads = 256;

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
  ss = warp_sum(ss);
  __shared__ float warp_part[kNormThreads / 32];
  __shared__ float row_scale;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) warp_part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kNormThreads / 32 ? warp_part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) row_scale = 1.0f / sqrtf(v / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float scale = row_scale;
  for (int i = threadIdx.x; i < d; i += kNormThreads) {
    outr[i] = from_f32<T>(to_f32<T>(xr[i]) * scale * g[i]);
  }
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

// Shared helpers of the hand-written kernels: element conversions for the
// two model dtypes (float and bfloat16) and the dtype codes the ctypes
// wrappers pass (brpc_tpu_torch/ops/_build.py keeps the same numbers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace brpc_tpu_torch {

constexpr int kDtypeFloat32 = 0;
constexpr int kDtypeBFloat16 = 1;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round-to-nearest-even, as jnp's astype does.
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Value as it reads after a round trip through T (the JAX reference casts
// softmax probabilities to the model dtype before the P.V product).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace brpc_tpu_torch

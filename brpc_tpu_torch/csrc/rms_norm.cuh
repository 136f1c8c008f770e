// Pieces shared by K3 (csrc/rms_norm.cu) and its backward K3b
// (csrc/rms_norm_backward.cu): the block size, a block-wide sum, and rows
// moved as 16-byte chunks of f32 values.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace brpc_tpu_torch {
namespace norm {

constexpr int kNormThreads = 256;

// The block's sum of `v` over its threads, in every thread.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[kNormThreads / 32];
  __shared__ float total;
  v = warp_sum(v);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kNormThreads / 32 ? warp_part[lane] : 0.f;
    w = warp_sum(w);
    if (lane == 0) total = w;
  }
  __syncthreads();
  return total;
}

// A 16-byte chunk of a row as f32 values: kN elements of T, converted
// exactly on the way in and rounded to nearest even on the way out.
template <typename T>
struct Chunk16;
template <>
struct Chunk16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(uint4 r, float (&f)[kN]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Chunk16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(uint4 r, float (&f)[kN]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower element in the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bits(f[2 * i]) | bits(f[2 * i + 1]) << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

}  // namespace norm
}  // namespace brpc_tpu_torch

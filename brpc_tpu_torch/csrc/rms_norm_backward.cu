// K3b: the backward of RMSNorm (K3), alone and in its fused form with the
// residual add before it.
//
// Replaces: the autodiff of brpc_tpu/models/transformer.py:102 `_rms_norm`
// under `jax.value_and_grad(loss_fn)`: for y = T(x32 r g) with r =
// rsqrt(mean(x32^2) + eps),
//   dx = r (g dy - xhat mean(g dy xhat)),  xhat = x32 r,
//   dgain = sum over rows of dy xhat, in f32 (the reference's gains are f32).
// The fused form is the backward of `add_rms_norm` (s = T(x + delta), h =
// rms_norm(s)): the residual stream's own incoming gradient ds_out is added
// to the norm's, ds = T(ds_out + T(dx)), which is the gradient of both of the
// add's operands; autograd would make the same two roundings.
// Bound on the card: bytes. Each row of x and dy is read once and dx written
// once (3 x rows x D x sizeof(T), a fourth read of ds_out in the fused form)
// against the H100 SXM's 3.35 TB/s (data sheet, 700 W power limit); the
// partial sums add one f32 row per block, written and read once.
// Design: one pass over the rows, each block taking a run of consecutive rows
// with 256 threads striding each row in 16-byte chunks (the row kept in
// registers between its two block-wide sums, sum(x^2) and sum(g dy xhat));
// each thread also sums dy xhat of its columns over the block's rows and
// writes that partial once. A second, small pass sums the partials of each
// column in block order into dgain. No atomics: the sums' order is fixed.
#include "rms_norm.cuh"

namespace brpc_tpu_torch {
namespace {

using norm::block_sum;
using norm::Chunk16;
using norm::kNormThreads;

// Rows [blockIdx.x * rows_per_block, + rows_per_block) of x and dy; thread t
// holds chunks t, t + 256, ... (kChunks of them) of each row. partial:
// [gridDim.x][d] f32, this block's sums of dy xhat.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kNormThreads)
    rms_norm_backward_kernel(const T* __restrict__ x,
                             const float* __restrict__ g,
                             const T* __restrict__ dy,
                             const T* __restrict__ ds_out,
                             T* __restrict__ dx, float* __restrict__ partial,
                             long long rows, int d, int rows_per_block,
                             float eps) {
  using C = Chunk16<T>;
  constexpr int kN = C::kN;
  const int n_chunks = d / kN;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float pg[kChunks][kN];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < kN; ++e) pg[c][e] = 0.f;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  for (long long row = r0; row < r1; ++row) {
    const long long base = row * d;
    const uint4* xr = reinterpret_cast<const uint4*>(x + base);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + base);
    float xv[kChunks][kN], dv[kChunks][kN];
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int ch = threadIdx.x + c * kNormThreads;
#pragma unroll
      for (int e = 0; e < kN; ++e) xv[c][e] = dv[c][e] = 0.f;
      if (ch >= n_chunks) continue;
      C::unpack(xr[ch], xv[c]);
      C::unpack(dyr[ch], dv[c]);
#pragma unroll
      for (int e = 0; e < kN; ++e) ss += xv[c][e] * xv[c][e];
    }
    const float r =
        1.0f / sqrtf(block_sum(ss) / static_cast<float>(d) + eps);
    float t = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int ch = threadIdx.x + c * kNormThreads;
      if (ch >= n_chunks) continue;
#pragma unroll
      for (int e4 = 0; e4 < kN / 4; ++e4) {
        const float4 gg = g4[ch * (kN / 4) + e4];
        const float gs[4] = {gg.x, gg.y, gg.z, gg.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * e4 + i;
          t += dv[c][e] * gs[i] * (xv[c][e] * r);
        }
      }
    }
    const float mt = block_sum(t) / static_cast<float>(d);
    const uint4* dsr =
        ds_out == nullptr ? nullptr
                          : reinterpret_cast<const uint4*>(ds_out + base);
    uint4* dxr = reinterpret_cast<uint4*>(dx + base);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int ch = threadIdx.x + c * kNormThreads;
      if (ch >= n_chunks) continue;
      float out[kN];
#pragma unroll
      for (int e4 = 0; e4 < kN / 4; ++e4) {
        const float4 gg = g4[ch * (kN / 4) + e4];
        const float gs[4] = {gg.x, gg.y, gg.z, gg.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * e4 + i;
          const float xh = xv[c][e] * r;
          out[e] = r * (dv[c][e] * gs[i] - xh * mt);
          pg[c][e] += dv[c][e] * xh;
        }
      }
      if (dsr != nullptr) {
        float so[kN];
        C::unpack(dsr[ch], so);
#pragma unroll
        for (int e = 0; e < kN; ++e) out[e] = so[e] + round_to<T>(out[e]);
      }
      dxr[ch] = C::pack(out);
    }
  }
  float4* pr = reinterpret_cast<float4*>(
      partial + static_cast<long long>(blockIdx.x) * d);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int ch = threadIdx.x + c * kNormThreads;
    if (ch >= n_chunks) continue;
#pragma unroll
    for (int e4 = 0; e4 < kN / 4; ++e4)
      pr[ch * (kN / 4) + e4] =
          make_float4(pg[c][4 * e4], pg[c][4 * e4 + 1], pg[c][4 * e4 + 2],
                      pg[c][4 * e4 + 3]);
  }
}

// dgain[col] = sum over p of partial[p][col], p in order.
__global__ void __launch_bounds__(kNormThreads)
    rms_norm_dgain_kernel(const float* __restrict__ partial,
                          float* __restrict__ dgain, int n_part, int d) {
  const int col = blockIdx.x * kNormThreads + threadIdx.x;
  if (col >= d) return;
  float s = 0.f;
  for (int p = 0; p < n_part; ++p)
    s += partial[static_cast<long long>(p) * d + col];
  dgain[col] = s;
}

template <typename T>
int launch(const void* x, const float* g, const void* dy, const void* ds_out,
           void* dx, float* partial, float* dgain, long long rows, int d,
           int rows_per_block, float eps, cudaStream_t stream) {
  constexpr int kN = Chunk16<T>::kN;
  if (d % kN != 0) return cudaErrorInvalidValue;
  const int per_thread = (d / kN + kNormThreads - 1) / kNormThreads;
  const long long n_part = (rows + rows_per_block - 1) / rows_per_block;
  if (n_part > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n_part));
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const T* dst = static_cast<const T*>(ds_out);
  T* dxt = static_cast<T*>(dx);
  if (per_thread <= 1)
    rms_norm_backward_kernel<T, 1><<<grid, kNormThreads, 0, stream>>>(
        xt, g, dyt, dst, dxt, partial, rows, d, rows_per_block, eps);
  else if (per_thread <= 2)
    rms_norm_backward_kernel<T, 2><<<grid, kNormThreads, 0, stream>>>(
        xt, g, dyt, dst, dxt, partial, rows, d, rows_per_block, eps);
  else if (per_thread <= 4)
    rms_norm_backward_kernel<T, 4><<<grid, kNormThreads, 0, stream>>>(
        xt, g, dyt, dst, dxt, partial, rows, d, rows_per_block, eps);
  else if (per_thread <= 8)
    rms_norm_backward_kernel<T, 8><<<grid, kNormThreads, 0, stream>>>(
        xt, g, dyt, dst, dxt, partial, rows, d, rows_per_block, eps);
  else
    return cudaErrorInvalidValue;
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  rms_norm_dgain_kernel<<<(d + kNormThreads - 1) / kNormThreads,
                          kNormThreads, 0, stream>>>(
      partial, dgain, static_cast<int>(n_part), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace brpc_tpu_torch

// x, dy, dx: [rows, d] contiguous in `dtype` (x the norm's input: in the
// fused form the residual sum s); ds_out: [rows, d] in `dtype`, or null for
// the norm alone; g, dgain: [d] f32; partial: f32 scratch of
// ceil(rows / rows_per_block) x d. Every pointer 16-byte aligned, d a
// multiple of 16 bytes' worth of elements and at most 8 x 256 such chunks
// (d <= 16384 in bf16, 8192 in f32).
extern "C" int brpc_rms_norm_backward(int dtype, const void* x,
                                      const float* g, const void* dy,
                                      const void* ds_out, void* dx,
                                      float* partial, float* dgain,
                                      long long rows, int d,
                                      int rows_per_block, float eps,
                                      void* stream) {
  using namespace brpc_tpu_torch;
  if (rows <= 0) return 0;
  if (d <= 0 || rows_per_block <= 0 || !aligned16(x) || !aligned16(g) ||
      !aligned16(dy) || (ds_out != nullptr && !aligned16(ds_out)) ||
      !aligned16(dx) || !aligned16(partial))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeFloat32)
    return launch<float>(x, g, dy, ds_out, dx, partial, dgain, rows, d,
                         rows_per_block, eps, st);
  if (dtype == kDtypeBFloat16)
    return launch<__nv_bfloat16>(x, g, dy, ds_out, dx, partial, dgain, rows,
                                 d, rows_per_block, eps, st);
  return cudaErrorInvalidValue;
}

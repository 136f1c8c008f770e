// K3: RMSNorm over the last axis, h = T(x32 * (1 / sqrt(mean(x32^2) + eps)) * g),
// and its fused form with the residual add before it (`add_rms_norm`):
// s = T(x + delta), the new residual stream, and h = RMSNorm(s).
//
// Replaces: brpc_tpu/models/transformer.py:102 `_rms_norm` (XLA-fused in the
// JAX package; run 2L+1 times per decode step and per prefill), and, fused,
// the residual adds before every norm but the first (x + attention out
// before ln_mlp, x + MLP out before the next ln_attn or ln_out), which the
// JAX package leaves to XLA to fuse.
// Bound on the card: bytes. Each row is read once and written once (the
// fused form: two reads and two writes), plus D floats of gain, against
// the H100 SXM's 3.35 TB/s (data sheet, 700 W power limit); the arithmetic
// is a few operations per element.
//
// Design, for the decode shape (8 rows of 4096, one block a row on 8 of the
// 132 SMs, so a launch is as long as its dependent memory round trips):
// - Every load is issued before the reduction. A thread takes its 16-byte
//   chunks of x (and delta) and the gain's matching float4s into registers
//   in one go, so the row is read once and no memory round trip follows the
//   sum. The fused form writes s before the reduction. This form runs where
//   the grid has at most one row an SM. Past that (a prefill's rows) a
//   form held to fewer registers runs (32 at 1-2 chunks a thread): each
//   chunk loaded just before its use and the gain after the sum, which
//   measured faster there.
// - One barrier: warp shuffles, one shared-memory write a warp, one
//   __syncthreads, then every thread adds the warps' partials in warp order.
//   Reruns are bit-identical (no atomics).
// - K3 alone accepts any D: x is read in 16-byte chunks from its row's first
//   16-byte boundary, the elements before it and after the last whole chunk
//   (the scalar tail) one by one. Where a row does not start 16 bytes
//   aligned (D not a multiple of 16 bytes' worth of elements, or an offset
//   x) the gain is read and h written element by element. A row longer than
//   8 chunks a thread is read twice (kChunks = 0).
// Math follows the reference: f32 throughout, mean as sum / D, the correctly
// rounded 1 / sqrtf (no fast-math rsqrt), (x * scale) * g. The fused sum is
// rounded to T as torch's `x + delta` rounds it (f32 add, nearest even).
#include "rms_norm.cuh"

namespace brpc_tpu_torch {
namespace {

using norm::Chunk16;
using norm::kNormThreads;

// Chunks a thread holds at most.
constexpr int kMaxChunks = 8;

template <typename T>
struct NormArgs {
  const T* x;
  const T* delta;  // the fused form only
  const float* g;
  T* s;  // the fused form only
  T* h;
  int d;
  float eps;
  bool vec;  // every row 16-byte aligned: 16-byte stores, float4 gain
};

// The sum of `v` over the block, in every thread: one barrier, and every
// thread adds the warps' partials in the same order.
__device__ __forceinline__ float block_total(float v) {
  __shared__ float warp_part[kNormThreads / 32];
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w)
    t += warp_part[w];
  return t;
}

// One row: its body of n 16-byte chunks, which starts `lead` elements in,
// and the elements outside the body. The fused form's rows are always
// 16-byte aligned.
template <typename T, bool kFused>
struct Row {
  using C = Chunk16<T>;
  static constexpr int kN = C::kN;
  NormArgs<T> a;
  long long base;  // the row's first element
  int lead, body_end, n;

  __device__ Row(const NormArgs<T>& args, long long row)
      : a(args), base(row * args.d) {
    lead = 0;
    if (!vec()) {
      const uintptr_t addr = reinterpret_cast<uintptr_t>(a.x + base);
      lead = min(a.d, static_cast<int>(((16 - (addr & 15)) & 15) / sizeof(T)));
    }
    n = (a.d - lead) / kN;
    body_end = lead + n * kN;
  }
  __device__ bool vec() const { return kFused || a.vec; }
  // Loads go through the read-only path: no kernel writes x, delta or g.
  __device__ uint4 raw(const T* p, int ch) const {
    return __ldg(reinterpret_cast<const uint4*>(p + base + lead) + ch);
  }
  __device__ void gain(int ch, float (&gv)[kN]) const {
    if (vec()) {
      const float4* g4 = reinterpret_cast<const float4*>(a.g) + ch * (kN / 4);
#pragma unroll
      for (int j = 0; j < kN / 4; ++j) {
        const float4 q = __ldg(g4 + j);
        gv[4 * j] = q.x;
        gv[4 * j + 1] = q.y;
        gv[4 * j + 2] = q.z;
        gv[4 * j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) gv[e] = __ldg(a.g + lead + ch * kN + e);
    }
  }
  __device__ void store(T* p, int ch, const float (&v)[kN]) const {
    if (vec()) {
      reinterpret_cast<uint4*>(p + base)[ch] = C::pack(v);
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e)
        p[base + lead + ch * kN + e] = from_f32<T>(v[e]);
    }
  }
  // h's chunk ch from the row's chunk in T and the gain's.
  __device__ void scale_store(uint4 held, const float (&gv)[kN], float scale,
                              int ch) const {
    float v[kN];
    C::unpack(held, v);
#pragma unroll
    for (int e = 0; e < kN; ++e) v[e] = v[e] * scale * gv[e];
    store(a.h, ch, v);
  }
  // The element outside the body that thread t holds, or -1.
  __device__ int outside(int t) const {
    if (t >= lead + a.d - body_end) return -1;
    return t < lead ? t : body_end + (t - lead);
  }
};

// Block r normalises row r. kChunks: the chunks a thread holds in registers
// (blockDim.x * kChunks >= the row's chunks), kept in T between the sum and
// the scaling (the fused sum is exact in T); 0: the row is read twice, a
// chunk at a time. kGainFirst: every load is issued before the sum; else a
// chunk's loads come just before its use and the gain's after the sum, in a
// kernel held to kLateBlocks blocks an SM.
template <int kChunks>
constexpr int kLateBlocks = kChunks <= 2 ? 8 : kChunks == 4 ? 6 : 4;
template <typename T, bool kFused, int kChunks, bool kGainFirst>
__global__ void __launch_bounds__(kNormThreads,
                                  kGainFirst || kChunks == 0 ? 1
                                             : kLateBlocks<kChunks>)
    norm_kernel(const NormArgs<T> a) {
  using C = Chunk16<T>;
  constexpr int kN = C::kN;
  const Row<T, kFused> row(a, blockIdx.x);
  const int nt = blockDim.x;
  // The fused form's rows are whole chunks: nothing lies outside them.
  const int out_i = kFused ? -1 : row.outside(threadIdx.x);
  float ss = 0.f;
  float out_v = 0.f, out_g = 0.f;
  if (out_i >= 0) {
    out_v = to_f32<T>(a.x[row.base + out_i]);
    out_g = a.g[out_i];
    ss = out_v * out_v;
  }
  constexpr int kHeld = kChunks > 0 ? kChunks : 1;
  uint4 held[kHeld];  // the row's chunks: x, or the fused sum s
  float gv[kHeld][kN];
  if constexpr (kChunks > 0) {
    uint4 rd[kChunks];
    if (kGainFirst) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int ch = threadIdx.x + c * nt;
        if (ch >= row.n) continue;
        held[c] = row.raw(a.x, ch);
        if (kFused) rd[c] = row.raw(a.delta, ch);
        row.gain(ch, gv[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int ch = threadIdx.x + c * nt;
      if (ch >= row.n) continue;
      if (!kGainFirst) {
        held[c] = row.raw(a.x, ch);
        if (kFused) rd[c] = row.raw(a.delta, ch);
      }
      float v[kN];
      C::unpack(held[c], v);
      if (kFused) {
        float b[kN];
        C::unpack(rd[c], b);
#pragma unroll
        for (int e = 0; e < kN; ++e) v[e] = round_to<T>(v[e] + b[e]);
        held[c] = C::pack(v);  // already in T: packed exactly
        row.store(a.s, ch, v);
      }
#pragma unroll
      for (int e = 0; e < kN; ++e) ss += v[e] * v[e];
    }
  } else {
    for (int ch = threadIdx.x; ch < row.n; ch += nt) {
      float v[kN];
      C::unpack(row.raw(a.x, ch), v);
#pragma unroll
      for (int e = 0; e < kN; ++e) ss += v[e] * v[e];
    }
  }
  const float scale =
      1.0f / sqrtf(block_total(ss) / static_cast<float>(a.d) + a.eps);
  if (out_i >= 0) a.h[row.base + out_i] = from_f32<T>(out_v * scale * out_g);
  if constexpr (kChunks > 0) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int ch = threadIdx.x + c * nt;
      if (ch >= row.n) continue;
      if (!kGainFirst) row.gain(ch, gv[c]);
      row.scale_store(held[c], gv[c], scale, ch);
    }
  } else {
    for (int ch = threadIdx.x; ch < row.n; ch += nt) {
      row.gain(ch, gv[0]);
      row.scale_store(row.raw(a.x, ch), gv[0], scale, ch);
    }
  }
}

// Rows an SM at most for which the gain is loaded before the sum.
constexpr int kFirstRowsPerSm = 3;

// One block a row. The gain is loaded before the sum where the grid has at
// most kFirstRowsPerSm rows an SM (decode: a launch is as long as its
// dependent round trips); past that the kernel that loads each chunk just
// before its use and the gain after the sum runs, kLateBlocks blocks an SM.
template <typename T, bool kFused, int kChunks>
int launch(const NormArgs<T>& a, long long rows, int threads,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(rows));
  if constexpr (kChunks == 0) {
    norm_kernel<T, kFused, 0, false><<<grid, threads, 0, stream>>>(a);
  } else {
    int dev = 0, sms = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) {
      cudaGetLastError();  // not left behind for a later launch to report
      return static_cast<int>(rc);
    }
    if (rows <= static_cast<long long>(sms) * kFirstRowsPerSm)
      norm_kernel<T, kFused, kChunks, true><<<grid, threads, 0, stream>>>(a);
    else
      norm_kernel<T, kFused, kChunks, false><<<grid, threads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Sizes the launch: the chunks a thread holds (the least of 1, 2, 4, 8 that
// covers the row's chunks with 256 threads, else 0: read twice) and the
// threads (a multiple of 32 that covers them).
template <typename T, bool kFused>
int dispatch(const NormArgs<T>& a, long long rows, cudaStream_t stream) {
  constexpr int kN = Chunk16<T>::kN;
  const int n = a.d / kN;
  int chunks = 1;
  while (chunks < kMaxChunks && chunks * kNormThreads < n) chunks *= 2;
  if (chunks * kNormThreads < n) {
    if constexpr (kFused) return cudaErrorInvalidValue;
    else return launch<T, false, 0>(a, rows, kNormThreads, stream);
  }
  const int threads = max(32, ((n + chunks - 1) / chunks + 31) / 32 * 32);
  switch (chunks) {
    case 1: return launch<T, kFused, 1>(a, rows, threads, stream);
    case 2: return launch<T, kFused, 2>(a, rows, threads, stream);
    case 4: return launch<T, kFused, 4>(a, rows, threads, stream);
    default: return launch<T, kFused, 8>(a, rows, threads, stream);
  }
}

template <bool kFused>
int run(int dtype, const void* x, const void* delta, const float* g, void* s,
        void* h, long long rows, int d, float eps, bool vec,
        cudaStream_t stream) {
  if (dtype == kDtypeFloat32) {
    const NormArgs<float> a{static_cast<const float*>(x),
                            static_cast<const float*>(delta), g,
                            static_cast<float*>(s), static_cast<float*>(h),
                            d, eps, vec};
    return dispatch<float, kFused>(a, rows, stream);
  }
  if (dtype == kDtypeBFloat16) {
    using B = __nv_bfloat16;
    const NormArgs<B> a{static_cast<const B*>(x), static_cast<const B*>(delta),
                        g, static_cast<B*>(s), static_cast<B*>(h), d, eps,
                        vec};
    return dispatch<B, kFused>(a, rows, stream);
  }
  return cudaErrorInvalidValue;
}

int elem_bytes(int dtype) { return dtype == kDtypeFloat32 ? 4 : 2; }

}  // namespace
}  // namespace brpc_tpu_torch

// x, out: [rows, d] contiguous in `dtype`; g: [d] float32; any d.
extern "C" int brpc_rms_norm(int dtype, const void* x, const float* g,
                             void* out, long long rows, int d, float eps,
                             void* stream) {
  using namespace brpc_tpu_torch;
  if (rows <= 0) return 0;
  if (d <= 0 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = (static_cast<long long>(d) * elem_bytes(dtype)) % 16 == 0 &&
                   aligned16(x) && aligned16(g) && aligned16(out);
  return run<false>(dtype, x, nullptr, g, nullptr, out, rows, d, eps, vec,
                    static_cast<cudaStream_t>(stream));
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
  if (d <= 0 || rows > 0x7fffffffLL ||
      (static_cast<long long>(d) * elem_bytes(dtype)) % 16 != 0 ||
      !aligned16(x) || !aligned16(delta) || !aligned16(g) || !aligned16(s) ||
      !aligned16(h))
    return cudaErrorInvalidValue;
  return run<true>(dtype, x, delta, g, s, h, rows, d, eps, true,
                   static_cast<cudaStream_t>(stream));
}

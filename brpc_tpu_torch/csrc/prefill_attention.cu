// K2: prefill attention of one sequence, causal with a pad-key mask
// (key k is visible to query q when k <= q && k < length), grouped-query.
//
// Replaces: the attention of brpc_tpu/models/transformer.py:221 `prefill`
// (:242-258; the same math as `_attention` :123 and `_prefill_block` :275):
// q.K^T in f32 times 1/sqrt(Dh), -1e30 on masked keys, f32 softmax,
// probabilities cast to the model dtype, .V with f32 accumulation. Query
// head h reads KV head h / (H / KV), the reference's jnp.repeat.
// Bound on the card: operations for long prompts (4 x P^2/2 x Dh x H
// flops against the H100 SXM's 989 TFLOP/s in bf16), bytes for short ones
// (q, k, v read once and o written once against its 3.35 TB/s; data sheet,
// 700 W power limit). This first version runs on
// the CUDA cores in f32, far from the tensor-core bound; wgmma and TMA come
// later.
// Design: one block per (tile of 64 queries, head), 8 warps of 8 query rows
// each. The block walks key tiles of 32 up to its causal edge
// min(q_end, length); each tile of K and V is staged once in shared memory
// (f32) for all 64 queries. Lane j of a warp forms the logit of key j for
// the warp's 8 rows at once (K row in float4 loads from a padded, bank-
// conflict-free stride, query rows broadcast), the rows fold the tile into
// an online softmax (running max and sum in f32), and P.V has each lane own
// Dh/32 output columns with the probabilities broadcast by shuffles.
// Probabilities are rounded to T before P.V, as in the reference.
#include "common.cuh"

namespace brpc_tpu_torch {
namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kWarps = 8;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp

template <int DH>
constexpr size_t prefill_smem_bytes() {
  return (static_cast<size_t>(kBlockQ) * DH +
          static_cast<size_t>(kBlockK) * (DH + 4) +
          static_cast<size_t>(kBlockK) * DH) * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
    prefill_attention_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out,
                             int n_tok, int length, int n_heads,
                             int n_kv_heads, float scale) {
  constexpr int kVpt = DH / 32;
  constexpr int kStrideK = DH + 4;  // keeps float4 rows 16-byte aligned
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // [kBlockQ][DH]
  float* ks = qs + kBlockQ * DH;                   // [kBlockK][kStrideK]
  float* vs = ks + kBlockK * kStrideK;             // [kBlockK][DH]

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int kvh = head / (n_heads / n_kv_heads);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nthreads = kWarps * 32;

  for (int i = threadIdx.x; i < kBlockQ * DH; i += nthreads) {
    const int r = i / DH;
    const int d = i - r * DH;
    const int row = q0 + r;
    qs[i] = row < n_tok
                ? to_f32<T>(q[(static_cast<long long>(row) * n_heads + head) *
                                  DH + d])
                : 0.f;
  }

  float acc[kRows][kVpt];
  float m[kRows];
  float l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kVpt; ++j) acc[r][j] = 0.f;
  }
  const int row0 = q0 + warp * kRows;  // first query row of this warp
  const int key_end = min(q0 + kBlockQ, length);

  for (int k0 = 0; k0 < key_end; k0 += kBlockK) {
    __syncthreads();  // previous tile consumed (and qs written, first pass)
    for (int i = threadIdx.x; i < kBlockK * DH; i += nthreads) {
      const int t = i / DH;
      const int d = i - t * DH;
      const int key = k0 + t;
      float kv_k = 0.f, kv_v = 0.f;
      if (key < n_tok) {
        const long long off =
            (static_cast<long long>(key) * n_kv_heads + kvh) * DH + d;
        kv_k = to_f32<T>(k[off]);
        kv_v = to_f32<T>(v[off]);
      }
      ks[t * kStrideK + d] = kv_k;
      vs[t * DH + d] = kv_v;
    }
    __syncthreads();

    // Logits: lane j <-> key k0 + j, for the warp's kRows query rows.
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * kStrideK);
#pragma unroll 4
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(
            qs + (warp * kRows + r) * DH)[d4];
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }
    const int key = k0 + lane;
    float pr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const bool valid = key <= row && key < length;
      const float sv = valid ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
      const float e = valid ? expf(sv - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(e);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kVpt; ++j) acc[r][j] *= alpha;
      pr[r] = round_to<T>(e);
    }
    // P.V: lane owns output columns lane + 32 * j.
    const int n_keys = min(kBlockK, key_end - k0);
    for (int t = 0; t < n_keys; ++t) {
      float vv[kVpt];
#pragma unroll
      for (int j = 0; j < kVpt; ++j) vv[j] = vs[t * DH + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pt = __shfl_sync(0xffffffffu, pr[r], t);
#pragma unroll
        for (int j = 0; j < kVpt; ++j) acc[r][j] += pt * vv[j];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= n_tok) continue;
    const float inv = 1.0f / l[r];
    T* orow = out + (static_cast<long long>(row) * n_heads + head) * DH;
#pragma unroll
    for (int j = 0; j < kVpt; ++j)
      orow[lane + 32 * j] = from_f32<T>(acc[r][j] * inv);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int n_tok,
           int length, int n_heads, int n_kv_heads, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<DH>();
  auto kernel = prefill_attention_kernel<T, DH>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n_tok + kBlockQ - 1) / kBlockQ, n_heads);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n_tok, length, n_heads,
      n_kv_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                void* out, int n_tok, int length, int n_heads,
                int n_kv_heads, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, out, n_tok, length, n_heads, n_kv_heads,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, n_tok, length, n_heads, n_kv_heads,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, n_tok, length, n_heads,
                            n_kv_heads, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace brpc_tpu_torch

// q, out: [n_tok, n_heads, dh]; k, v: [n_tok, n_kv_heads, dh], contiguous.
// 1 <= length <= n_tok.
extern "C" int brpc_prefill_attention(int dtype, const void* q,
                                      const void* k, const void* v,
                                      void* out, int n_tok, int length,
                                      int n_heads, int n_kv_heads, int dh,
                                      float scale, void* stream) {
  using namespace brpc_tpu_torch;
  if (n_tok <= 0) return 0;
  if (length < 1 || length > n_tok || n_kv_heads <= 0 ||
      n_heads % n_kv_heads != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeFloat32)
    return dispatch_dh<float>(dh, q, k, v, out, n_tok, length, n_heads,
                              n_kv_heads, scale, s);
  if (dtype == kDtypeBFloat16)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, out, n_tok, length,
                                      n_heads, n_kv_heads, scale, s);
  return cudaErrorInvalidValue;
}

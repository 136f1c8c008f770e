// K4: suffix-prefill attention over the paged KV pool, the attention of a
// prefix-cache hit. The queries are the suffix rows at positions
// start .. start + n_q - 1; query i attends every key j <= start + i, read
// through the sequence's block table: the cached prefix [0, start) and the
// suffix rows this call already wrote into the pages. No dense view of the
// cache is built.
//
// Replaces: brpc_tpu/kv_cache.py:1151 `paged_resume_fn.run` (the gather of
// the sequence's pages into a dense [L, view, KV, Dh] view and the cut of
// the written pages back out) and the attention of
// brpc_tpu/models/transformer.py:358 `prefill_resume` (:398-411):
// q.K^T in f32 times 1/sqrt(Dh), -1e30 on keys past the query's position,
// f32 softmax, probabilities cast to the model dtype, .V with f32
// accumulation. Query head h reads KV head h / (H / KV).
// Bound on the card: operations for long suffixes (4 x H x Dh x n_q x
// (start + n_q / 2) flops against the H100 SXM's 989 TFLOP/s in bf16),
// bytes for short ones (the (start + n_q) cached K and V rows of every KV
// head read once, q read and o written once, against its 3.35 TB/s; data
// sheet, 700 W power limit). This first version runs on the CUDA cores in
// f32, far from the tensor-core bound; wgmma and TMA come later.
// Design: K2's tiling (csrc/prefill_attention.cu) with K1's table walk
// (csrc/paged_decode_attention.cu). One block per (tile of 64 queries,
// head), 8 warps of 8 query rows each. The block walks key tiles of 32 up
// to its causal edge start + min(q_end, n_q); the loader maps key j to
// block table[j / page], row j % page, through the pool's explicit strides
// (one layer of [block, L, page, KV, Dh] is strided), and stages the tile
// once in shared memory (f32) for all 64 queries. Lane j forms the logit of
// key j for the warp's 8 rows, the rows fold each tile into an online
// softmax (running max and sum in f32), and P.V has each lane own Dh/32
// output columns with the probabilities broadcast by shuffles. Key 0 is
// visible to every query, so no row is fully masked and skipping masked
// keys equals the reference's -1e30. Probabilities are rounded to T before
// P.V, as in the reference; the division by the sum happens once at the end.
#include "common.cuh"

namespace brpc_tpu_torch {
namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kWarps = 8;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp

template <int DH>
constexpr size_t paged_prefill_smem_bytes() {
  return (static_cast<size_t>(kBlockQ) * DH +
          static_cast<size_t>(kBlockK) * (DH + 4) +
          static_cast<size_t>(kBlockK) * DH) * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
    paged_prefill_kernel(const T* __restrict__ q,
                         const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const int* __restrict__ table, T* __restrict__ out,
                         int n_q, int start, int n_heads, int n_kv_heads,
                         int page, long long s_blk, long long s_t,
                         long long s_kvh, float scale) {
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
    qs[i] = row < n_q
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
  // Keys past the last real query's position are never read.
  const int key_end = start + min(q0 + kBlockQ, n_q);

  for (int k0 = 0; k0 < key_end; k0 += kBlockK) {
    __syncthreads();  // previous tile consumed (and qs written, first pass)
    for (int i = threadIdx.x; i < kBlockK * DH; i += nthreads) {
      const int t = i / DH;
      const int d = i - t * DH;
      const int key = k0 + t;
      float kv_k = 0.f, kv_v = 0.f;
      if (key < key_end) {
        const long long blk = table[key / page];
        const long long off =
            blk * s_blk + (key % page) * s_t + kvh * s_kvh + d;
        kv_k = to_f32<T>(k_pool[off]);
        kv_v = to_f32<T>(v_pool[off]);
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
      const bool valid = key <= start + row0 + r && key < key_end;
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
    if (row >= n_q) continue;
    const float inv = 1.0f / l[r];
    T* orow = out + (static_cast<long long>(row) * n_heads + head) * DH;
#pragma unroll
    for (int j = 0; j < kVpt; ++j)
      orow[lane + 32 * j] = from_f32<T>(acc[r][j] * inv);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, void* out, int n_q, int start, int n_heads,
           int n_kv_heads, int page, long long s_blk, long long s_t,
           long long s_kvh, float scale, cudaStream_t stream) {
  constexpr size_t smem = paged_prefill_smem_bytes<DH>();
  auto kernel = paged_prefill_kernel<T, DH>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n_q + kBlockQ - 1) / kBlockQ, n_heads);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, static_cast<T*>(out), n_q, start,
      n_heads, n_kv_heads, page, s_blk, s_t, s_kvh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k_pool,
                const void* v_pool, const int* table, void* out, int n_q,
                int start, int n_heads, int n_kv_heads, int page,
                long long s_blk, long long s_t, long long s_kvh, float scale,
                cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, table, out, n_q, start,
                           n_heads, n_kv_heads, page, s_blk, s_t, s_kvh,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, table, out, n_q, start,
                           n_heads, n_kv_heads, page, s_blk, s_t, s_kvh,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, table, out, n_q, start,
                            n_heads, n_kv_heads, page, s_blk, s_t, s_kvh,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace brpc_tpu_torch

// q, out: [n_q, n_heads, dh], contiguous; k_pool/v_pool point at layer l's
// slice of the [block, L, page, KV, dh] pool (element strides s_blk, s_t,
// s_kvh; dh contiguous); table: int32 block ids covering positions
// [0, start + n_q). start >= 0, n_q >= 1.
extern "C" int brpc_paged_prefill_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* table, void* out, int n_q, int start, int n_heads,
    int n_kv_heads, int dh, int page, long long s_blk, long long s_t,
    long long s_kvh, float scale, void* stream) {
  using namespace brpc_tpu_torch;
  if (n_q <= 0) return 0;
  if (start < 0 || n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      page <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeFloat32)
    return dispatch_dh<float>(dh, q, k_pool, v_pool, table, out, n_q, start,
                              n_heads, n_kv_heads, page, s_blk, s_t, s_kvh,
                              scale, s);
  if (dtype == kDtypeBFloat16)
    return dispatch_dh<__nv_bfloat16>(dh, q, k_pool, v_pool, table, out, n_q,
                                      start, n_heads, n_kv_heads, page, s_blk,
                                      s_t, s_kvh, scale, s);
  return cudaErrorInvalidValue;
}

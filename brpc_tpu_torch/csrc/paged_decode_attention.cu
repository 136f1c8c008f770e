// K1: decode attention of one query token per lane over the paged KV pool,
// read through the lane's block table (no dense copy of the cache).
//
// Replaces: brpc_tpu/kv_cache.py:312 `paged_decode_fn` (the gather of every
// lane's pages into a dense [slots, L, max_seq, KV, Dh] view plus the page
// scatter back) and the attention of brpc_tpu/models/transformer.py:426
// `decode_step` (:450-461): per lane, q.K^T over positions <= pos in f32,
// softmax, probabilities cast to the model dtype, .V with f32 accumulation.
// Bound on the card: bytes. The K and V rows at positions <= pos of the
// lane's KV head are read once: 2 x (pos + 1) x Dh x sizeof(T) per (lane,
// KV head), against the H100 SXM's 3.35 TB/s (data sheet, 700 W
// power limit). The JAX path moved the whole max_seq window
// of every lane twice per step instead.
// Design: one block per (lane, KV head), one warp per query head of the GQA
// group (H / KV warps), so each K/V row is staged once in shared memory and
// read by every head of the group. The block walks the table page by page:
// the page's valid rows are loaded (converted to f32) into shared memory,
// each warp forms its head's logits with lanes splitting Dh and a butterfly
// reduction (every lane ends with the same value), and folds them into an
// online softmax (running max and sum in f32). Keys past pos are never
// loaded, which equals the reference's -1e30 mask since no row is fully
// masked. Probabilities are rounded to T before the product with V, as the
// reference rounds them; the division by the sum happens once at the end.
// Strides are explicit because a layer's page is strided inside the pool's
// [block, L, page, KV, Dh] layout.
#include "common.cuh"

namespace brpc_tpu_torch {
namespace {

template <typename T, int DH>
__global__ void paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ pos, T* __restrict__ out, int n_heads,
    int n_kv_heads, int page, int max_pages, long long s_blk, long long s_t,
    long long s_kvh, float scale) {
  constexpr int kVpt = DH / 32;  // Dh elements per lane, lane + 32 * j
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* kt = smem;                 // [page][DH]
  float* vt = kt + page * DH;       // [page][DH]
  float* logit = vt + page * DH;    // [group][page]

  const int lane_id = blockIdx.x;   // decode lane (slot)
  const int kvh = blockIdx.y;
  const int group = n_heads / n_kv_heads;
  const int warp = threadIdx.x / 32;  // query head within the group
  const int lane = threadIdx.x % 32;
  const int head = kvh * group + warp;
  const int p = pos[lane_id];
  const int last_page = p / page;
  const int* table = tables + static_cast<long long>(lane_id) * max_pages;

  float qv[kVpt];
  float acc[kVpt];
  const T* qh = q + (static_cast<long long>(lane_id) * n_heads + head) * DH;
#pragma unroll
  for (int j = 0; j < kVpt; ++j) {
    qv[j] = to_f32<T>(qh[lane + 32 * j]);
    acc[j] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;
  float* my_logit = logit + warp * page;

  for (int pg = 0; pg <= last_page; ++pg) {
    const int n_valid = pg == last_page ? p - pg * page + 1 : page;
    const long long blk = table[pg];
    const T* kb = k_pool + blk * s_blk + kvh * s_kvh;
    const T* vb = v_pool + blk * s_blk + kvh * s_kvh;
    __syncthreads();  // previous page fully consumed
    for (int i = threadIdx.x; i < n_valid * DH; i += blockDim.x) {
      const int t = i / DH;
      const int d = i - t * DH;
      kt[i] = to_f32<T>(kb[t * s_t + d]);
      vt[i] = to_f32<T>(vb[t * s_t + d]);
    }
    __syncthreads();

    float page_max = -INFINITY;
    for (int t = 0; t < n_valid; ++t) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kVpt; ++j) part += qv[j] * kt[t * DH + lane + 32 * j];
      const float s = warp_sum(part) * scale;
      if (lane == 0) my_logit[t] = s;
      page_max = fmaxf(page_max, s);
    }
    __syncwarp();
    const float m_new = fmaxf(m, page_max);
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < kVpt; ++j) acc[j] *= alpha;
    for (int t = 0; t < n_valid; ++t) {
      const float e = expf(my_logit[t] - m_new);
      l += e;
      const float pr = round_to<T>(e);
#pragma unroll
      for (int j = 0; j < kVpt; ++j) acc[j] += pr * vt[t * DH + lane + 32 * j];
    }
    m = m_new;
    __syncwarp();  // logits of this page read before the next overwrites
  }

  T* oh = out + (static_cast<long long>(lane_id) * n_heads + head) * DH;
  const float inv = 1.0f / l;
#pragma unroll
  for (int j = 0; j < kVpt; ++j) oh[lane + 32 * j] = from_f32<T>(acc[j] * inv);
}

template <typename T, int DH>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* pos, void* out, int n_lanes,
           int n_heads, int n_kv_heads, int page, int max_pages,
           long long s_blk, long long s_t, long long s_kvh, float scale,
           cudaStream_t stream) {
  const int group = n_heads / n_kv_heads;
  const size_t smem = (2 * static_cast<size_t>(page) * DH +
                       static_cast<size_t>(group) * page) * sizeof(float);
  auto kernel = paged_decode_kernel<T, DH>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_lanes, n_kv_heads);
  kernel<<<grid, group * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, pos, static_cast<T*>(out),
      n_heads, n_kv_heads, page, max_pages, s_blk, s_t, s_kvh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k_pool,
                const void* v_pool, const int* tables, const int* pos,
                void* out, int n_lanes, int n_heads, int n_kv_heads,
                int page, int max_pages, long long s_blk, long long s_t,
                long long s_kvh, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, tables, pos, out, n_lanes,
                           n_heads, n_kv_heads, page, max_pages, s_blk, s_t,
                           s_kvh, scale, stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, tables, pos, out, n_lanes,
                           n_heads, n_kv_heads, page, max_pages, s_blk, s_t,
                           s_kvh, scale, stream);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, tables, pos, out, n_lanes,
                            n_heads, n_kv_heads, page, max_pages, s_blk, s_t,
                            s_kvh, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace brpc_tpu_torch

// q, out: [n_lanes, n_heads, dh]; k_pool/v_pool point at layer l's slice of
// the [block, L, page, KV, dh] pool (element strides s_blk, s_t, s_kvh; dh
// contiguous); tables: [n_lanes, max_pages] int32; pos: [n_lanes] int32.
extern "C" int brpc_paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* tables, const int* pos, void* out, int n_lanes, int n_heads,
    int n_kv_heads, int dh, int page, int max_pages, long long s_blk,
    long long s_t, long long s_kvh, float scale, void* stream) {
  using namespace brpc_tpu_torch;
  if (n_lanes <= 0) return 0;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      n_heads / n_kv_heads > 32 || page <= 0 || max_pages <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeFloat32)
    return dispatch_dh<float>(dh, q, k_pool, v_pool, tables, pos, out,
                              n_lanes, n_heads, n_kv_heads, page, max_pages,
                              s_blk, s_t, s_kvh, scale, s);
  if (dtype == kDtypeBFloat16)
    return dispatch_dh<__nv_bfloat16>(dh, q, k_pool, v_pool, tables, pos,
                                      out, n_lanes, n_heads, n_kv_heads,
                                      page, max_pages, s_blk, s_t, s_kvh,
                                      scale, s);
  return cudaErrorInvalidValue;
}

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
// Bound on the card: bytes for short suffixes (the start + n_q cached K and
// V rows of every KV head read once, q read and o written once, against
// the H100 SXM's 3.35 TB/s), operations for long ones (4 x H x Dh flops
// per visible (query, key) pair against its 989 TFLOP/s in bf16; data
// sheet, 700 W power limit).
// Design: the paged loader of two cores. bf16: the tensor-core tile core
// (csrc/attention_tile.cuh, `mma_tile`: mma.sync, 64 rows a block). f32
// exact on the CUDA cores: the register-tiled SIMT forward core of
// csrc/attention_f32.cuh (`attn_f32::fwd`, plain FFMA, no TF32: 128 rows a
// block, 64-key tiles by cp.async), which computes only a block's 16-row
// slices that hold a valid row; it plans its own splits for one block per
// SM (ops/attention.py `plan_splits`).
// - Paged loads: key j is row j % page of block table[j / page] in the
//   strided layer slice (element strides s_blk, s_t, s_kvh), so a start or
//   an end inside a page is no special case.
// - GQA packing: one block serves one KV head, and its rows (64, or 128 in
//   f32) are the (query, head) pairs of the H / KV query heads that share
//   it, query major. Each page is read once per KV head, not H / KV
//   times, and the causal edge is per row: start + the row's query index.
// - Split-K: a short suffix gives few (query tile, KV head) blocks, so the
//   key range [0, start + n_q) is cut at 64-key tile boundaries into
//   n_splits ranges of tiles_per_split tiles (the wrapper derives both from
//   the shape, the dtype's core and the SM count) and the grid is (query
//   tile, KV head, split). Each split writes an unnormalised f32 partial O
//   with its row max and sum; `paged_prefill_merge_kernel`, launched by the
//   same entry point, rescales the partials to the largest max, divides
//   once by the combined sum and rounds to T. A split may hold no key a row
//   can see (m = -inf, l = 0): the merge skips it, and since key 0 is in
//   split 0 and visible to every row, no row is masked in every split. With
//   one split the block writes its rows straight out and there is no
//   merge. The merge rescales P.V sums whose probabilities were rounded to
//   T within their split; the result stays inside the bf16 tolerance (atol
//   2e-2 + rtol 1e-2) that the online softmax already relies on, as each
//   split is itself an online softmax over its tiles.
#include "attention_f32.cuh"

namespace brpc_tpu_torch {
namespace {

using attn::kTileKeys;
using attn::kTileRows;
using attn_f32::kF32FwdRows;
// A split is cut in 64-key tiles of either core.
static_assert(kTileKeys == attn_f32::kF32FwdKeys,
              "a split boundary is a key tile boundary of both cores");

// The packed rows of one (query tile of kRows rows, KV head, split) block:
// kTileRows for the bf16 core, kF32FwdRows for the f32 one.
template <typename T, int kRows>
struct PagedProblem {
  static constexpr bool kFolds = false;
  const T* k;
  const T* v;
  const int* table;
  int n_q, start, n_heads, group, page, kvh, r0;
  long long s_blk, s_t, s_kvh;
  int key_begin, key_end;

  __device__ PagedProblem(const T* k_, const T* v_, const int* table_,
                          int n_q_, int start_, int n_heads_, int n_kv_heads,
                          int page_, long long s_blk_, long long s_t_,
                          long long s_kvh_, int tiles_per_split)
      : k(k_), v(v_), table(table_), n_q(n_q_), start(start_),
        n_heads(n_heads_), group(n_heads_ / n_kv_heads), page(page_),
        s_blk(s_blk_), s_t(s_t_), s_kvh(s_kvh_) {
    r0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
    kvh = blockIdx.y;
    const int last_q = min((r0 + kRows - 1) / group, n_q - 1);
    key_begin = blockIdx.z * tiles_per_split * kTileKeys;
    key_end = min(key_begin + tiles_per_split * kTileKeys,
                  start + last_q + 1);
  }
  // Packed row r0 + r is (query (r0 + r) / group, head kvh * group +
  // (r0 + r) % group).
  __device__ int row_id(int r) const {
    const int pr = r0 + r;
    const int qi = pr / group;
    return qi < n_q ? qi * n_heads + kvh * group + (pr - qi * group) : -1;
  }
  __device__ int edge(int r) const { return start + (r0 + r) / group; }
  __device__ long long kv_offset(int j) const {
    const int blk_row = j / page;
    return static_cast<long long>(table[blk_row]) * s_blk +
           static_cast<long long>(j - blk_row * page) * s_t + kvh * s_kvh;
  }
};

// The bf16 route: the tile core on the tensor cores (T is bf16 only).
template <typename T, int DH>
__global__ void __launch_bounds__(attn::kMmaThreads, attn::kMmaMinBlocks)
    paged_prefill_kernel(const T* __restrict__ q,
                         const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const int* __restrict__ table, T* __restrict__ out,
                         float* __restrict__ o_part,
                         float* __restrict__ ml_part, int n_q, int start,
                         int n_heads, int n_kv_heads, int page,
                         long long s_blk, long long s_t, long long s_kvh,
                         float scale, int tiles_per_split) {
  const PagedProblem<T, kTileRows> p(k_pool, v_pool, table, n_q, start,
                                     n_heads, n_kv_heads, page, s_blk, s_t,
                                     s_kvh, tiles_per_split);
  const attn::Sink<T> sink{out, o_part, ml_part, n_q * n_heads,
                           static_cast<int>(blockIdx.z), gridDim.z > 1};
  attn::mma_tile<DH>(p, q, scale, sink);
}

// The f32 route: the SIMT forward core (T is float only).
template <typename T, int DH>
__global__ void __launch_bounds__(attn_f32::kF32FwdThreads, 1)
    paged_prefill_simt_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const int* __restrict__ table,
                              T* __restrict__ out,
                              float* __restrict__ o_part,
                              float* __restrict__ ml_part, int n_q,
                              int start, int n_heads, int n_kv_heads,
                              int page, long long s_blk, long long s_t,
                              long long s_kvh, float scale,
                              int tiles_per_split) {
  const PagedProblem<T, kF32FwdRows> p(k_pool, v_pool, table, n_q, start,
                                       n_heads, n_kv_heads, page, s_blk,
                                       s_t, s_kvh, tiles_per_split);
  const attn::Sink<T> sink{out, o_part, ml_part, n_q * n_heads,
                           static_cast<int>(blockIdx.z), gridDim.z > 1};
  attn_f32::fwd<DH>(p, q, scale, sink);
}

// The merge pass: one warp per (query, head) row (attn::merge_row).
template <typename T, int DH>
__global__ void __launch_bounds__(attn::kMergeWarps * 32)
    paged_prefill_merge_kernel(const float* __restrict__ o_part,
                               const float* __restrict__ ml_part,
                               T* __restrict__ out, int n_rows,
                               int n_splits) {
  attn::merge_row<T, DH>(o_part, ml_part, out, n_rows, n_splits);
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* table;
  void* out;
  float* o_part;
  float* ml_part;
  int n_q, start, n_heads, n_kv_heads, page;
  long long s_blk, s_t, s_kvh;
  float scale;
  int tiles_per_split, n_splits;
};

template <typename T, int DH>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kRows = kF32 ? kF32FwdRows : kTileRows;
  constexpr int kThreads = kF32 ? attn_f32::kF32FwdThreads
                                : attn::kMmaThreads;
  constexpr size_t smem = kF32 ? attn_f32::FwdSmem<DH>::kBytes
                               : attn::mma_smem_bytes<DH>();
  auto kernel = [] {
    if constexpr (kF32)
      return paged_prefill_simt_kernel<T, DH>;
    else
      return paged_prefill_kernel<T, DH>;
  }();
  static std::atomic<unsigned long long> smem_set{0};
  if (int e = attn::allow_smem(kernel, smem, smem_set)) return e;
  const int rows = a.n_q * (a.n_heads / a.n_kv_heads);
  const dim3 grid((rows + kRows - 1) / kRows, a.n_kv_heads, a.n_splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), a.table, static_cast<T*>(a.out),
      a.o_part, a.ml_part, a.n_q, a.start, a.n_heads, a.n_kv_heads, a.page,
      a.s_blk, a.s_t, a.s_kvh, a.scale, a.tiles_per_split);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (a.n_splits == 1) return 0;
  const int n_rows = a.n_q * a.n_heads;
  paged_prefill_merge_kernel<T, DH>
      <<<attn::merge_blocks(n_rows), attn::kMergeWarps * 32, 0, stream>>>(
          a.o_part, a.ml_part, static_cast<T*>(a.out), n_rows, a.n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const Args& a, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(a, stream);
    case 64:
      return launch<T, 64>(a, stream);
    case 128:
      return launch<T, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace brpc_tpu_torch

// The split pass and, with n_splits > 1, the merge pass; returns the first
// launch error. q, out: [n_q, n_heads, dh], contiguous; k_pool/v_pool
// point at layer l's slice of the [block, L, page, KV, dh] pool (element
// strides s_blk, s_t, s_kvh; dh contiguous); table: int32 block ids
// covering positions [0, start + n_q). With n_splits == 1 the split pass
// writes out; otherwise it writes o_part [n_splits, n_q * n_heads, dh] and
// ml_part [n_splits, n_q * n_heads, 2] (f32 scratch), and the merge
// (out[row] = sum_s w_s o_part[s, row] / sum_s w_s l_s, w_s =
// exp(m_s - max_s m_s), splits with m_s = -inf skipped) writes out. Every
// split of tiles_per_split 64-key tiles must start below start + n_q.
// Pointers 16-byte aligned; start >= 0, n_q >= 1.
extern "C" int brpc_paged_prefill_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* table, void* out, float* o_part, float* ml_part, int n_q,
    int start, int n_heads, int n_kv_heads, int dh, int page,
    long long s_blk, long long s_t, long long s_kvh, float scale,
    int tiles_per_split, int n_splits, void* stream) {
  using namespace brpc_tpu_torch;
  if (n_q <= 0) return 0;
  if (start < 0 || n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      page <= 0 || tiles_per_split <= 0 || n_splits <= 0 ||
      static_cast<long long>(n_splits - 1) * tiles_per_split *
              attn::kTileKeys >=
          start + n_q ||
      (n_splits > 1 && (o_part == nullptr || ml_part == nullptr)) ||
      !aligned16(q) || !aligned16(k_pool) ||
      !aligned16(v_pool) || !aligned16(out))
    return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, table, out, o_part, ml_part, n_q, start,
               n_heads, n_kv_heads, page, s_blk, s_t, s_kvh, scale,
               tiles_per_split, n_splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeFloat32) return dispatch_dh<float>(dh, a, s);
  if (dtype == kDtypeBFloat16) return dispatch_dh<__nv_bfloat16>(dh, a, s);
  return cudaErrorInvalidValue;
}

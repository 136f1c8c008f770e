// K1: decode attention of one query token per lane over the paged KV pool,
// read through the lane's block table (no dense copy of the cache).
//
// Replaces: brpc_tpu/kv_cache.py:312 `paged_decode_fn` (the gather of every
// lane's pages into a dense [slots, L, max_seq, KV, Dh] view plus the page
// scatter back) and the attention of brpc_tpu/models/transformer.py:426
// `decode_step` (:450-461): per lane, q.K^T over positions <= pos in f32
// times 1/sqrt(Dh), softmax, probabilities cast to the model dtype, .V with
// f32 accumulation, one division by the sum. Query head h reads KV head
// h / (H / KV).
// Bound on the card: bytes. The K and V rows at positions <= pos of every
// KV head of the lane are read once: 2 x (pos + 1) x KV x Dh x sizeof(T) per
// lane, against the H100 SXM's 3.35 TB/s (data sheet, 700 W power limit).
// The JAX path moved the whole max_seq window of every lane twice per step.
// Design: the decode loader of the shared tile core (csrc/attention_tile.cuh:
// bf16 on the tensor cores with mma.sync, f32 exact on the CUDA cores). Lane
// s's output is K4's (csrc/paged_prefill_attention.cu) with start = pos[s],
// one query and table tables[s], so the design is K4's:
// - GQA packing: a block serves one (lane, KV head); its rows are the lane's
//   H / KV query heads (4 of the tile's 64 at Llama-3-8B width; the rest
//   have row_id -1, their Q is zero-filled and the warps that hold only
//   such rows do no arithmetic). Each page is read once per KV head.
// - Split-K over the block table: the grid is (lane, KV head, split). The
//   wrapper plans the splits from host integers only, the table's width
//   times the page size as the key bound (ops.attention.plan_decode_splits),
//   never from pos, which stays on the device. Each block reads pos[lane]
//   and clips its split's 64-key tiles at pos[lane] + 1; a split wholly past
//   it writes m = -inf, l = 0 (attn::write_empty), so an idle lane (pos 0
//   through block 0) costs one tile. The merge pass (attn::merge_row),
//   launched by the same entry point, combines a row's splits; with one
//   split the blocks write their rows straight out.
// - Paged loads: key j is row j % page of block table[j / page] in the
//   strided layer slice (element strides s_blk, s_t, s_kvh); a position on
//   the first row of a fresh page is no special case.
#include "attention_tile.cuh"

namespace brpc_tpu_torch {
namespace {

using attn::kTileKeys;

template <typename T>
struct DecodeProblem {
  const T* k;
  const T* v;
  const int* table;  // this lane's row of the block tables
  int group, row0, kvh, page, pos;
  long long s_blk, s_t, s_kvh;
  int key_begin, key_end;

  __device__ DecodeProblem(const T* k_, const T* v_, const int* tables,
                           const int* pos_, int n_heads, int n_kv_heads,
                           int page_, int max_pages, long long s_blk_,
                           long long s_t_, long long s_kvh_,
                           int tiles_per_split)
      : k(k_), v(v_), page(page_), s_blk(s_blk_), s_t(s_t_), s_kvh(s_kvh_) {
    const int lane = blockIdx.x;
    kvh = blockIdx.y;
    group = n_heads / n_kv_heads;
    row0 = lane * n_heads + kvh * group;
    table = tables + static_cast<long long>(lane) * max_pages;
    pos = pos_[lane];
    key_begin = blockIdx.z * tiles_per_split * kTileKeys;
    // Clipped at the table's width too, so a bad pos reads no memory past
    // the lane's row.
    key_end = min(min(key_begin + tiles_per_split * kTileKeys, pos + 1),
                  max_pages * page);
  }
  // Row r is query head kvh * group + r of the lane.
  __device__ int row_id(int r) const { return r < group ? row0 + r : -1; }
  __device__ int edge(int) const { return pos; }
  __device__ long long kv_offset(int j) const {
    const int blk_row = j / page;
    return static_cast<long long>(table[blk_row]) * s_blk +
           static_cast<long long>(j - blk_row * page) * s_t + kvh * s_kvh;
  }
};

template <typename T, int DH>
__global__ void __launch_bounds__(attn::Core<T>::kThreads,
                                  attn::Core<T>::kMinBlocks)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ pos, T* __restrict__ out,
                        float* __restrict__ o_part,
                        float* __restrict__ ml_part, int n_heads,
                        int n_kv_heads, int page, int max_pages,
                        long long s_blk, long long s_t, long long s_kvh,
                        float scale, int tiles_per_split) {
  const DecodeProblem<T> p(k_pool, v_pool, tables, pos, n_heads, n_kv_heads,
                           page, max_pages, s_blk, s_t, s_kvh,
                           tiles_per_split);
  const attn::Sink<T> sink{out, o_part, ml_part,
                           static_cast<int>(gridDim.x) * n_heads,
                           static_cast<int>(blockIdx.z), gridDim.z > 1};
  attn::Core<T>::template run<DH>(p, q, scale, sink);
}

// The merge pass: one warp per (lane, head) row (attn::merge_row).
template <typename T, int DH>
__global__ void __launch_bounds__(attn::kMergeWarps * 32)
    paged_decode_merge_kernel(const float* __restrict__ o_part,
                              const float* __restrict__ ml_part,
                              T* __restrict__ out, int n_rows, int n_splits) {
  attn::merge_row<T, DH>(o_part, ml_part, out, n_rows, n_splits);
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* pos;
  void* out;
  float* o_part;
  float* ml_part;
  int n_lanes, n_heads, n_kv_heads, page, max_pages;
  long long s_blk, s_t, s_kvh;
  float scale;
  int tiles_per_split, n_splits;
};

template <typename T, int DH>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = attn::Core<T>::template smem<DH>();
  auto kernel = paged_decode_kernel<T, DH>;
  static std::atomic<unsigned long long> smem_set{0};
  if (int e = attn::allow_smem(kernel, smem, smem_set)) return e;
  const dim3 grid(a.n_lanes, a.n_kv_heads, a.n_splits);
  kernel<<<grid, attn::Core<T>::kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), a.tables, a.pos,
      static_cast<T*>(a.out), a.o_part, a.ml_part, a.n_heads, a.n_kv_heads,
      a.page, a.max_pages, a.s_blk, a.s_t, a.s_kvh, a.scale,
      a.tiles_per_split);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (a.n_splits == 1) return 0;
  const int n_rows = a.n_lanes * a.n_heads;
  paged_decode_merge_kernel<T, DH>
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
// launch error. q, out: [n_lanes, n_heads, dh], contiguous; k_pool/v_pool
// point at layer l's slice of the [block, L, page, KV, dh] pool (element
// strides s_blk, s_t, s_kvh; dh contiguous); tables: [n_lanes, max_pages]
// int32; pos: [n_lanes] int32 on the device, pos[s] < max_pages * page.
// With n_splits == 1 the split pass writes out; otherwise it writes o_part
// [n_splits, n_lanes * n_heads, dh] and ml_part [n_splits, n_lanes *
// n_heads, 2] (f32 scratch) and the merge writes out. Every split of
// tiles_per_split 64-key tiles must start below max_pages * page; splits
// past a lane's pos are empty for that lane. n_heads / n_kv_heads <= 64.
// Pointers 16-byte aligned.
extern "C" int brpc_paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* tables, const int* pos, void* out, float* o_part,
    float* ml_part, int n_lanes, int n_heads, int n_kv_heads, int dh,
    int page, int max_pages, long long s_blk, long long s_t, long long s_kvh,
    float scale, int tiles_per_split, int n_splits, void* stream) {
  using namespace brpc_tpu_torch;
  if (n_lanes <= 0) return 0;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      n_heads / n_kv_heads > attn::kTileRows || page <= 0 ||
      max_pages <= 0 || tiles_per_split <= 0 || n_splits <= 0 ||
      static_cast<long long>(n_splits - 1) * tiles_per_split *
              attn::kTileKeys >=
          static_cast<long long>(max_pages) * page ||
      (n_splits > 1 && (o_part == nullptr || ml_part == nullptr)) ||
      !aligned16(q) || !aligned16(k_pool) ||
      !aligned16(v_pool) || !aligned16(out))
    return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, tables, pos, out, o_part, ml_part,
               n_lanes, n_heads, n_kv_heads, page, max_pages, s_blk, s_t,
               s_kvh, scale, tiles_per_split, n_splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeFloat32) return dispatch_dh<float>(dh, a, s);
  if (dtype == kDtypeBFloat16) return dispatch_dh<__nv_bfloat16>(dh, a, s);
  return cudaErrorInvalidValue;
}

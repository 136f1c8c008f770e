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
// Design: a decode problem on two cores. Lane s's output is K4's
// (csrc/paged_prefill_attention.cu) with start = pos[s], one query and
// table tables[s]:
// - GQA packing: one (lane, KV head) is one problem; its rows are the
//   lane's H / KV query heads (4 at Llama-3-8B width; the core's other rows
//   have row_id -1 and are never computed). Each page is read once per KV
//   head (in f32, once per chunk of 16 heads: one chunk up to a group of
//   16).
// - Split-K over the block table: a problem's keys are cut at 64-key tile
//   boundaries into splits. The wrapper plans them from host integers only,
//   the table's width times the page size as the key bound
//   (ops.attention.plan_decode_splits), never from pos, which stays on the
//   device. A (lane, KV head, split) item reads pos[lane] and clips its
//   split's tiles at pos[lane] + 1 (and at the table's width). The merge
//   pass (attn::merge_row), launched by the same entry point, combines a
//   row's splits in split order; with one split the items write their rows
//   straight out.
// - bf16: the tile core (csrc/attention_tile.cuh, `mma_tile`, mma.sync, 64
//   rows a block), one block per item, the grid (lane, KV head, split)
//   aimed at 3 blocks per SM; an item wholly past its lane's pos writes
//   m = -inf, l = 0 (attn::write_empty), which the merge weighs 0.
// - f32, exact on the CUDA cores: the register-tiled SIMT forward core of
//   csrc/attention_f32.cuh (`attn_f32::fwd`, plain FFMA, no TF32) in a
//   decode layout of kF32DecodeRows = 16 rows (one slice of the core's
//   thread grid; one V stage), 114 KB at Dh 128, so that an SM holds
//   kF32DecodeBlocks = 2 blocks and one block's loads and barriers overlap
//   the other's products. The grid is persistent, min(items, 2 x SMs)
//   blocks. Each block reads every lane's pos, forms the list of the items
//   that hold a key, lane-major, and runs every grid-th one, so the live
//   items spread evenly, an empty item costs nothing, and the merge reads
//   only a lane's live splits. Splits are short (kF32DecodeSplitTiles = 2
//   tiles) so that a long lane spreads over many SMs; when the lanes' KV
//   heads alone fill the block slots the plan has one split and no merge
//   runs. The sweep (tools/torch_f32_sweep.py --decode) chose the split
//   size and the layout: against the core's 128-row layout (one block an
//   SM), the 16-row one alone changed nothing and two blocks an SM took
//   ~20% off.
// - Paged loads: key j is row j % page of block table[j / page] in the
//   strided layer slice (element strides s_blk, s_t, s_kvh); a position on
//   the first row of a fresh page is no special case.
#include "attention_f32.cuh"

namespace brpc_tpu_torch {
namespace {

using attn::kTileKeys;
using attn_f32::kF32DecodeBlocks;
using attn_f32::kF32DecodeRows;
// A split is cut in 64-key tiles of either core.
static_assert(kTileKeys == attn_f32::kF32FwdKeys,
              "a split boundary is a key tile boundary of both cores");

// One (lane, KV head, split) item, or in f32 one chunk of the lane's H / KV
// query heads of it: heads [head0, head0 + n_rows) of the KV head's group.
template <typename T>
struct DecodeProblem {
  static constexpr bool kFolds = false;
  const T* k;
  const T* v;
  const int* table;  // this lane's row of the block tables
  int n_rows, row0, kvh, page, pos;
  long long s_blk, s_t, s_kvh;
  int key_begin, key_end;

  __device__ DecodeProblem(const T* k_, const T* v_, const int* tables,
                           const int* pos_, int n_heads, int n_kv_heads,
                           int page_, int max_pages, long long s_blk_,
                           long long s_t_, long long s_kvh_,
                           int tiles_per_split, int lane, int kvh_, int split,
                           int head0, int n_rows_)
      : k(k_), v(v_), n_rows(n_rows_), kvh(kvh_), page(page_), s_blk(s_blk_),
        s_t(s_t_), s_kvh(s_kvh_) {
    row0 = lane * n_heads + kvh * (n_heads / n_kv_heads) + head0;
    table = tables + static_cast<long long>(lane) * max_pages;
    pos = pos_[lane];
    key_begin = split * tiles_per_split * kTileKeys;
    // Clipped at the table's width too, so a bad pos reads no memory past
    // the lane's row.
    key_end = min(min(key_begin + tiles_per_split * kTileKeys, pos + 1),
                  max_pages * page);
  }
  // Row r is query head kvh * group + head0 + r of the lane.
  __device__ int row_id(int r) const { return r < n_rows ? row0 + r : -1; }
  __device__ int edge(int) const { return pos; }
  __device__ long long kv_offset(int j) const {
    const int blk_row = j / page;
    return static_cast<long long>(table[blk_row]) * s_blk +
           static_cast<long long>(j - blk_row * page) * s_t + kvh * s_kvh;
  }
};

// The bf16 route: one block per (lane, KV head, split) on the tile core.
template <typename T, int DH>
__global__ void __launch_bounds__(attn::kMmaThreads, attn::kMmaMinBlocks)
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
                           tiles_per_split, blockIdx.x, blockIdx.y,
                           blockIdx.z, 0, n_heads / n_kv_heads);
  const attn::Sink<T> sink{out, o_part, ml_part,
                           static_cast<int>(gridDim.x) * n_heads,
                           static_cast<int>(blockIdx.z), gridDim.z > 1};
  attn::mma_tile<DH>(p, q, scale, sink);
}

// The splits of split_keys keys that hold a key of a lane at `pos`: keys
// [0, pos + 1), clipped at the table's width max_keys as DecodeProblem
// clips them.
__device__ __forceinline__ int live_splits(int pos, int max_keys,
                                           int split_keys) {
  const int keys = min(max(pos + 1, 0), max_keys);
  return (keys + split_keys - 1) / split_keys;
}

// The f32 route (T is float only) on the SIMT forward core in its decode
// layout, kF32DecodeBlocks blocks an SM, as a persistent grid over the
// live items. An item is (lane, split, KV head, chunk): a chunk is up to
// kF32DecodeRows of the KV head's H / KV query heads. Each block first
// reads every lane's pos and forms first[l], the index of lane l's first
// live item in the lane-major sequence of the items that hold a key (first
// is n_lanes + 1 ints past the core's layout); then it walks live items
// blockIdx.x, blockIdx.x + gridDim.x, ... Every block forms the same
// sequence from pos, so the live items spread evenly over the blocks, no
// block spends time on an empty one, and which block runs an item does
// not change what the item computes.
template <typename T, int DH>
__global__ void __launch_bounds__(attn_f32::kF32FwdThreads, kF32DecodeBlocks)
    paged_decode_simt_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const int* __restrict__ tables,
                             const int* __restrict__ pos,
                             T* __restrict__ out,
                             float* __restrict__ o_part,
                             float* __restrict__ ml_part, int n_lanes,
                             int n_heads, int n_kv_heads, int page,
                             int max_pages, long long s_blk, long long s_t,
                             long long s_kvh, float scale,
                             int tiles_per_split, int n_splits) {
  using L = attn_f32::FwdSmem<DH, kF32DecodeRows, kF32DecodeBlocks>;
  constexpr int kWarps = attn_f32::kF32FwdThreads / 32;
  extern __shared__ float4 smem_f4[];
  int* totals = reinterpret_cast<int*>(smem_f4) + L::kEdge;  // per warp
  int* first = reinterpret_cast<int*>(smem_f4) + L::kBytes / sizeof(int);
  const int group = n_heads / n_kv_heads;
  const int chunks = (group + kF32DecodeRows - 1) / kF32DecodeRows;
  const int per_split = n_kv_heads * chunks;  // items of one lane's split
  const int max_keys = max_pages * page;
  const int split_keys = tiles_per_split * kTileKeys;
  const int lane_id = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // first[l + 1] = first[l] + per_split x the live splits of lane l: a
  // block scan in chunks of a block's threads.
  int carry = 0;
  for (int base = 0; base < n_lanes; base += attn_f32::kF32FwdThreads) {
    const int l = base + static_cast<int>(threadIdx.x);
    int v = l < n_lanes
                ? live_splits(pos[l], max_keys, split_keys) * per_split
                : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane_id >= off) v += t;
    }
    if (lane_id == 31) totals[warp] = v;
    __syncthreads();
    int before = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? totals[w] : 0;
      carry += totals[w];
    }
    if (l < n_lanes) first[l + 1] = before + v;
    __syncthreads();  // totals are read before the next chunk writes them
  }
  if (threadIdx.x == 0) first[0] = 0;
  __syncthreads();
  const int live = first[n_lanes];
  bool ran = false;
  for (int item = blockIdx.x; item < live; item += gridDim.x) {
    // The lane: the last l with first[l] <= item (it has a live item).
    int lo = 0, hi = n_lanes;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (first[mid] <= item)
        lo = mid;
      else
        hi = mid;
    }
    const int rest = item - first[lo];
    const int split = rest / per_split;
    const int kvh = (rest - split * per_split) / chunks;
    const int head0 = (rest - split * per_split - kvh * chunks) *
                      kF32DecodeRows;
    const DecodeProblem<T> p(k_pool, v_pool, tables, pos, n_heads,
                             n_kv_heads, page, max_pages, s_blk, s_t, s_kvh,
                             tiles_per_split, lo, kvh, split, head0,
                             min(kF32DecodeRows, group - head0));
    const attn::Sink<T> sink{out, o_part, ml_part, n_lanes * n_heads, split,
                             n_splits > 1};
    if (ran) __syncthreads();  // the last item's tiles and P are consumed
    ran = true;
    attn_f32::fwd<DH, kF32DecodeRows, kF32DecodeBlocks>(p, q, scale, sink);
  }
}

// The merge pass: one warp per (lane, head) row (attn::merge_row). Given
// pos (the f32 route), a row merges only its lane's live splits, the ones
// the split pass wrote; without it (bf16), every split, whose empty ones
// hold m = -inf.
template <typename T, int DH>
__global__ void __launch_bounds__(attn::kMergeWarps * 32)
    paged_decode_merge_kernel(const float* __restrict__ o_part,
                              const float* __restrict__ ml_part,
                              T* __restrict__ out, int n_rows, int n_splits,
                              const int* __restrict__ pos, int n_heads,
                              int max_keys, int split_keys) {
  int splits = n_splits;
  if (pos != nullptr) {
    const int row = blockIdx.x * attn::kMergeWarps + threadIdx.x / 32;
    if (row >= n_rows) return;
    splits = live_splits(pos[row / n_heads], max_keys, split_keys);
  }
  attn::merge_row<T, DH>(o_part, ml_part, out, n_rows, splits);
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

// The current device's SM count, read once per device.
int device_sms(int& sms) {
  static std::atomic<int> known[64];
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  sms = known[dev & 63].load(std::memory_order_relaxed);
  if (sms > 0) return 0;
  if (cudaError_t e = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev))
    return static_cast<int>(e);
  known[dev & 63].store(sms, std::memory_order_relaxed);
  return 0;
}

template <typename T, int DH>
int launch(const Args& a, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  constexpr bool kF32 = std::is_same<T, float>::value;
  if constexpr (kF32) {
    // The core's layout, then first[n_lanes + 1]. Past 375 lanes at Dh
    // 128 that is more than half an SM's shared memory, and an SM holds
    // one block.
    const size_t smem =
        attn_f32::FwdSmem<DH, kF32DecodeRows, kF32DecodeBlocks>::kBytes +
        sizeof(int) * (static_cast<size_t>(a.n_lanes) + 1);
    if (smem > static_cast<size_t>(attn_f32::kSmemPerBlock))
      return cudaErrorInvalidValue;
    auto kernel = paged_decode_simt_kernel<T, DH>;
    if (int e = attn::allow_smem(kernel, attn_f32::kSmemPerBlock, smem_set))
      return e;
    int sms = 0;
    if (int e = device_sms(sms)) return e;
    // ops.attention.decode_grid: one block per item, up to kF32DecodeBlocks
    // per SM.
    const int group = a.n_heads / a.n_kv_heads;
    const long long items =
        static_cast<long long>(a.n_lanes) * a.n_kv_heads * a.n_splits *
        ((group + kF32DecodeRows - 1) / kF32DecodeRows);
    const long long slots = static_cast<long long>(kF32DecodeBlocks) * sms;
    const unsigned grid = static_cast<unsigned>(items < slots ? items : slots);
    kernel<<<grid, attn_f32::kF32FwdThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
        static_cast<const T*>(a.v_pool), a.tables, a.pos,
        static_cast<T*>(a.out), a.o_part, a.ml_part, a.n_lanes,
        a.n_heads, a.n_kv_heads, a.page, a.max_pages, a.s_blk, a.s_t,
        a.s_kvh, a.scale, a.tiles_per_split, a.n_splits);
  } else {
    constexpr size_t smem = attn::mma_smem_bytes<DH>();
    auto kernel = paged_decode_kernel<T, DH>;
    if (int e = attn::allow_smem(kernel, smem, smem_set)) return e;
    const dim3 grid(a.n_lanes, a.n_kv_heads, a.n_splits);
    kernel<<<grid, attn::kMmaThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
        static_cast<const T*>(a.v_pool), a.tables, a.pos,
        static_cast<T*>(a.out), a.o_part, a.ml_part, a.n_heads,
        a.n_kv_heads, a.page, a.max_pages, a.s_blk, a.s_t, a.s_kvh, a.scale,
        a.tiles_per_split);
  }
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (a.n_splits == 1) return 0;
  const int n_rows = a.n_lanes * a.n_heads;
  paged_decode_merge_kernel<T, DH>
      <<<attn::merge_blocks(n_rows), attn::kMergeWarps * 32, 0, stream>>>(
          a.o_part, a.ml_part, static_cast<T*>(a.out), n_rows, a.n_splits,
          kF32 ? a.pos : nullptr, a.n_heads, a.max_pages * a.page,
          a.tiles_per_split * kTileKeys);
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

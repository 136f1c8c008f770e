// K2: prefill attention of one sequence, causal with a pad-key mask
// (key k is visible to query q when k <= q && k < length), grouped-query.
//
// Replaces: the attention of brpc_tpu/models/transformer.py:221 `prefill`
// (:242-258; the same math as `_attention` :123 and `_prefill_block` :275):
// q.K^T in f32 times 1/sqrt(Dh), -1e30 on masked keys, f32 softmax,
// probabilities cast to the model dtype, .V with f32 accumulation. Query
// head h reads KV head h / (H / KV), the reference's jnp.repeat.
// Bound on the card: operations for long prompts (4 x H x Dh flops per
// visible (query, key) pair against the H100 SXM's 989 TFLOP/s in bf16),
// bytes for short ones (q, k, v read once and o written once against its
// 3.35 TB/s; data sheet, 700 W power limit).
// Design: the dense loader of the shared tile core (csrc/attention_tile.cuh:
// bf16 on the tensor cores with mma.sync, f32 exact on the CUDA cores). One
// block per (head, tile of 64 queries); key j of KV head h / (H / KV) is
// row j of k and v. A block walks 64-key tiles up to its causal edge
// min(q_end, n_tok, length): tiles wholly above the diagonal or at or past
// `length` are never read, and the mask runs in registers. The causal
// triangle makes late query tiles the heaviest, so the grid is laid out
// heads fastest and query tiles last-first: the long rows start in the
// first wave and the short ones fill in behind them.
#include "attention_tile.cuh"

namespace brpc_tpu_torch {
namespace {

using attn::kTileRows;

template <typename T>
struct DenseProblem {
  const T* k;
  const T* v;
  int n_tok, n_heads, n_kv_heads, dh, q0, head, kvh;
  int key_begin, key_end;

  __device__ DenseProblem(const T* k_, const T* v_, int n_tok_, int length,
                          int n_heads_, int n_kv_heads_, int dh_)
      : k(k_), v(v_), n_tok(n_tok_), n_heads(n_heads_),
        n_kv_heads(n_kv_heads_), dh(dh_) {
    q0 = (gridDim.y - 1 - blockIdx.y) * kTileRows;  // heaviest first
    head = blockIdx.x;
    kvh = head / (n_heads / n_kv_heads);
    key_begin = 0;
    key_end = min(min(q0 + kTileRows, n_tok), length);
  }
  __device__ int row_id(int r) const {
    const int qi = q0 + r;
    return qi < n_tok ? qi * n_heads + head : -1;
  }
  __device__ int edge(int r) const { return q0 + r; }
  __device__ long long kv_offset(int j) const {
    return (static_cast<long long>(j) * n_kv_heads + kvh) * dh;
  }
};

template <typename T, int DH>
__global__ void __launch_bounds__(attn::Core<T>::kThreads,
                                  attn::Core<T>::kMinBlocks)
    prefill_attention_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out,
                             int n_tok, int length, int n_heads,
                             int n_kv_heads, float scale) {
  const DenseProblem<T> p(k, v, n_tok, length, n_heads, n_kv_heads, DH);
  const attn::Sink<T> sink{out, nullptr, nullptr, n_tok * n_heads, 0, false};
  attn::Core<T>::template run<DH>(p, q, scale, sink);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int n_tok,
           int length, int n_heads, int n_kv_heads, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = attn::Core<T>::template smem<DH>();
  auto kernel = prefill_attention_kernel<T, DH>;
  static std::atomic<unsigned long long> smem_set{0};
  if (int e = attn::allow_smem(kernel, smem, smem_set)) return e;
  const dim3 grid(n_heads, (n_tok + kTileRows - 1) / kTileRows);
  kernel<<<grid, attn::Core<T>::kThreads, smem, stream>>>(
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

// q, out: [n_tok, n_heads, dh]; k, v: [n_tok, n_kv_heads, dh], contiguous
// and 16-byte aligned. 1 <= length <= n_tok.
extern "C" int brpc_prefill_attention(int dtype, const void* q,
                                      const void* k, const void* v,
                                      void* out, int n_tok, int length,
                                      int n_heads, int n_kv_heads, int dh,
                                      float scale, void* stream) {
  using namespace brpc_tpu_torch;
  if (n_tok <= 0) return 0;
  if (length < 1 || length > n_tok || n_kv_heads <= 0 ||
      n_heads % n_kv_heads != 0 || !attn::aligned16(q) ||
      !attn::aligned16(k) || !attn::aligned16(v) || !attn::aligned16(out))
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

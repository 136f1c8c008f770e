// K5: the ring-attention block fold. One rank's queries attend to the K/V
// block resident on it at this step of the ring, and the result is folded
// into the rows' running online-softmax state (o, m, l), in place; on the
// ring's last step the rows' o / l is written out instead.
//
// Replaces: the scan step of brpc_tpu/ops/ring_attention.py:56 `_ring`
// (`step` :65): f32 logits q.K^T times 1/sqrt(D) from the inputs cast to
// f32, the causal mask on global positions (key k_start + j visible to
// query q_start + i when k_start + j <= q_start + i), a running max with
// -inf guards for rows that saw no key yet, the state rescaled by
// exp(m - m_new), and at the end o / l with l = 0 read as 1, in q's dtype.
// q, k, v, out: [B, s, H, D] (K/V have H heads: no grouped-query sharing);
// the state: o [B, s_q, H, D] and (m, l) [B, s_q, H, 2], f32.
// Bound on the card: operations (4 x D flops per visible (query, key, head)
// triple, against the H100 SXM's 989 TFLOP/s in bf16 and 67 in f32); a
// block is read once, and at D 128 its bytes are far below that line.
// Design: the fourth loader of the shared tile core (csrc/attention_tile.cuh:
// bf16 on the tensor cores with mma.sync, exact f32 on the CUDA cores).
// One block per (batch, head, tile of 64 queries) over the resident block's
// keys; the core's fold epilogue merges the tile's (o, m, l) into the state
// by merge_row's rule, so the state stays O(1) in the ring's length and no
// partial goes through device memory. Under the causal mask a key tile
// wholly past a query tile's last row is never read, and tiles run heaviest
// first; a block wholly above the diagonal changes nothing (the reference
// keeps m and its alpha is 1), so the wrapper skips it, and on the last
// step launches with no keys to write the state out. bf16 inputs round the
// probabilities to bf16 before P.V (the tensor cores' operand), where the
// reference folds in f32: the bf16 kernel is held to the row tolerance.
#include "attention_tile.cuh"

namespace brpc_tpu_torch {
namespace {

using attn::kTileRows;

template <typename T>
struct RingProblem {
  static constexpr bool kFolds = true;
  const T* k;
  const T* v;
  int sq, sk, n_heads, dh, b, head, q0, diag;
  bool causal;
  int key_begin, key_end;

  // diag = q_start - k_start: key j is visible to query row i when
  // j <= diag + i (causal). n_keys is sk, or 0 to only write the state out.
  __device__ RingProblem(const T* k_, const T* v_, int sq_, int sk_,
                         int n_keys, int n_heads_, int dh_, int diag_,
                         bool causal_)
      : k(k_), v(v_), sq(sq_), sk(sk_), n_heads(n_heads_), dh(dh_),
        diag(diag_), causal(causal_) {
    b = blockIdx.x / n_heads;
    head = blockIdx.x - b * n_heads;
    q0 = (gridDim.y - 1 - blockIdx.y) * kTileRows;  // heaviest first
    key_begin = 0;
    key_end = causal ? max(0, min(n_keys, diag + q0 + kTileRows)) : n_keys;
  }
  __device__ int row_id(int r) const {
    const int qi = q0 + r;
    return qi < sq ? (b * sq + qi) * n_heads + head : -1;
  }
  __device__ int edge(int r) const {
    return causal ? diag + q0 + r : 0x7fffffff;
  }
  __device__ long long kv_offset(int j) const {
    return (static_cast<long long>(b) * sk + j) * n_heads * dh +
           static_cast<long long>(head) * dh;
  }
};

template <typename T, int DH>
__global__ void __launch_bounds__(attn::Core<T>::kThreads,
                                  attn::Core<T>::kMinBlocks)
    ring_attention_fold_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, float* o, float* ml,
                               T* out, int sq, int sk, int n_keys,
                               int n_heads, int diag, int causal,
                               float scale) {
  const RingProblem<T> p(k, v, sq, sk, n_keys, n_heads, DH, diag,
                         causal != 0);
  const attn::Sink<T> sink{out, o, ml, 0, 0, out == nullptr};
  attn::Core<T>::template run<DH>(p, q, scale, sink);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, void* ml,
           void* out, int batch, int sq, int sk, int n_keys, int n_heads,
           int diag, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = attn::Core<T>::template smem<DH>();
  auto kernel = ring_attention_fold_kernel<T, DH>;
  static std::atomic<unsigned long long> smem_set{0};
  if (int e = attn::allow_smem(kernel, smem, smem_set)) return e;
  const dim3 grid(batch * n_heads, (sq + kTileRows - 1) / kTileRows);
  kernel<<<grid, attn::Core<T>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(o),
      static_cast<float*>(ml), static_cast<T*>(out), sq, sk, n_keys, n_heads,
      diag, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o,
                void* ml, void* out, int batch, int sq, int sk, int n_keys,
                int n_heads, int diag, int causal, float scale,
                cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, ml, out, batch, sq, sk, n_keys,
                           n_heads, diag, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, ml, out, batch, sq, sk, n_keys,
                           n_heads, diag, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, ml, out, batch, sq, sk, n_keys,
                            n_heads, diag, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace brpc_tpu_torch

// q: [batch, sq, n_heads, dh]; k, v: [batch, sk, n_heads, dh]; o: [batch,
// sq, n_heads, dh] f32 and ml: [batch, sq, n_heads, 2] f32, the running
// state, updated in place when out is null; out: [batch, sq, n_heads, dh]
// in q's dtype, or null. All contiguous and 16-byte aligned. diag =
// q_start - k_start; n_keys is sk or 0.
extern "C" int brpc_ring_attention_fold(int dtype, const void* q,
                                        const void* k, const void* v,
                                        void* o, void* ml, void* out,
                                        int batch, int sq, int sk,
                                        int n_keys, int n_heads, int dh,
                                        int diag, int causal, float scale,
                                        void* stream) {
  using namespace brpc_tpu_torch;
  if (batch <= 0 || sq <= 0 || n_heads <= 0) return 0;
  if (sk <= 0 || n_keys < 0 || n_keys > sk || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o) || !aligned16(ml) ||
      (out != nullptr && !aligned16(out)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeFloat32)
    return dispatch_dh<float>(dh, q, k, v, o, ml, out, batch, sq, sk, n_keys,
                              n_heads, diag, causal, scale, s);
  if (dtype == kDtypeBFloat16)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, ml, out, batch, sq, sk,
                                      n_keys, n_heads, diag, causal, scale,
                                      s);
  return cudaErrorInvalidValue;
}

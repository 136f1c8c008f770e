// K2b: the backward of causal grouped-query attention over a batch, the
// gradient of K2's training forward.
//
// Replaces: the autodiff of brpc_tpu/models/transformer.py:123 `_attention`
// under `jax.value_and_grad(loss_fn)` (__graft_entry__.py:126): from dO it
// gives dq [B, S, H, Dh] and dk, dv [B, S, KV, Dh] (each KV head's sum over
// its H / KV query heads), in the model dtype. The reference's softmax is
// f32 and its probabilities are cast to the model dtype before P.V, so in
// bf16 dv is P rounded to bf16 times dO, as here.
// Bound on the card: operations. Five products of 2 x Dh flops per visible
// (query, key, head) pair each (S and dP recomputed, then dv, dk and dq),
// 2.5x the forward's, against the H100 SXM's 989 TFLOP/s in bf16 and 67 in
// f32 (data sheet, 700 W power limit); q, k, v, o, dO read once and dq, dk,
// dv written once are far below that line at a few thousand tokens.
// Design: the two-pass backward core of csrc/attention_backward.cuh (bf16
// on Hopper's wgmma, fed by TMA through a ring of column tiles with a
// producer warp and two consumer warpgroups; f32 on the CUDA cores'
// register-tiled FFMA, csrc/attention_f32.cuh, no TF32):
// a delta pre-pass, the dK/dV pass (one block per (batch, KV head, 128
// keys), over the query tiles of the KV head's query heads at or below the
// diagonal) and the dQ pass (one block per (batch, head, 128 queries),
// over the key tiles up to its diagonal; 32-row column tiles in f32), each
// block writing its own rows once, so no atomics and the same sums on
// every run. The probabilities come back from the LSE that K2
// (csrc/prefill_attention.cu) writes in its training form.
#include "attention_f32.cuh"

namespace brpc_tpu_torch {
namespace {

using attn_bwd::Args;
using attn_bwd::Core;

template <typename T, int DH>
__global__ void __launch_bounds__(Core<T>::kThreads, 1)
    attention_backward_kv_kernel(const Args<T> a,
                                 const __grid_constant__ attn_bwd::Maps maps) {
  Core<T>::template run<DH, true, false>(a, maps);
}

template <typename T, int DH>
__global__ void __launch_bounds__(Core<T>::kThreads, 1)
    attention_backward_q_kernel(const Args<T> a,
                                const __grid_constant__ attn_bwd::Maps maps) {
  Core<T>::template run<DH, false, false>(a, maps);
}

template <typename T>
__global__ void __launch_bounds__(attn_bwd::kDeltaWarps * 32)
    attention_backward_delta_kernel(const T* __restrict__ o,
                                    const T* __restrict__ dout,
                                    float* __restrict__ delta,
                                    long long rows, int dh) {
  attn_bwd::delta_row<T>(o, dout, delta, rows, dh);
}

template <typename T, int DH>
int launch(const Args<T>& a, const void* o, float* delta, int batch,
           cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set[2] = {{0}, {0}};
  return attn_bwd::launch_passes<T, DH>(
      attention_backward_delta_kernel<T>, attention_backward_kv_kernel<T, DH>,
      attention_backward_q_kernel<T, DH>, a, static_cast<const T*>(o), delta,
      true, batch, smem_set, stream);
}

template <typename T>
int dispatch(int dh, const Args<T>& a, const void* o, float* delta,
             int batch, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(a, o, delta, batch, stream);
    case 64:
      return launch<T, 64>(a, o, delta, batch, stream);
    case 128:
      return launch<T, 128>(a, o, delta, batch, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int run(int dh, const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* delta, void* dq, void* dk,
        void* dv, int batch, int n_tok, int n_heads, int n_kv_heads,
        float scale, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(q),    static_cast<const T*>(k),
                  static_cast<const T*>(v),    static_cast<const T*>(dout),
                  lse,                         delta,
                  dq,                          dk,
                  dv,                          n_tok,
                  n_tok,                       n_heads,
                  n_kv_heads,                  0,
                  1,                           scale};
  return dispatch<T>(dh, a, o, delta, batch, stream);
}

}  // namespace
}  // namespace brpc_tpu_torch

// q, o, dout, dq: [batch, n_tok, n_heads, dh]; k, v, dk, dv: [batch, n_tok,
// n_kv_heads, dh], all in `dtype`, contiguous and 16-byte aligned; lse: the
// forward's [batch, n_tok, n_heads] f32; delta: scratch of the same shape.
// Causal over all n_tok keys (the training forward has no pad mask).
extern "C" int brpc_attention_backward(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* o, const void* dout,
                                       const float* lse, float* delta,
                                       void* dq, void* dk, void* dv,
                                       int batch, int n_tok, int n_heads,
                                       int n_kv_heads, int dh, float scale,
                                       void* stream) {
  using namespace brpc_tpu_torch;
  if (batch <= 0 || n_tok <= 0) return 0;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o) || !aligned16(dout) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeFloat32)
    return run<float>(dh, q, k, v, o, dout, lse, delta, dq, dk, dv, batch,
                      n_tok, n_heads, n_kv_heads, scale, s);
  if (dtype == kDtypeBFloat16)
    return run<__nv_bfloat16>(dh, q, k, v, o, dout, lse, delta, dq, dk, dv,
                              batch, n_tok, n_heads, n_kv_heads, scale, s);
  return cudaErrorInvalidValue;
}

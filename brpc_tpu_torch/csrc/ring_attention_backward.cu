// K5b: the backward of one ring-attention block, the gradient of K5's fold.
// One rank's queries against the K/V block resident on it at this step of
// the ring's backward pass: the block's contributions to the rank's dq and
// to the block's travelling dk and dv, added to f32 accumulators in place.
//
// Replaces: the autodiff through brpc_tpu/ops/ring_attention.py:56 `_ring`
// (the scan of `step` :65 and its ppermutes) under `jax.grad`
// (tests/test_ring_attention.py:59): per block, dq_i += scale sum_j dS_ij
// k_j, dk_j += scale sum_i dS_ij q_i, dv_j += sum_i P_ij dO_i in f32, with
// P_ij = exp(s_ij - lse_i) recomputed from the ring's final log-sum-exp
// (which K5's last step writes) and the global causal test k_start + j <=
// q_start + i (:71-74). A row the ring left fully masked (l = 0, output 0,
// :109) has lse +inf, so P and every gradient of it are 0.
// q, k, v, o, dO: [B, s, H, D] (K/V have H heads: no grouped-query sum).
// Bound on the card: operations (five products of 2 x D flops per visible
// (query, key, head) triple, against the H100 SXM's 989 TFLOP/s in bf16 and
// 67 in f32); a block is read once and the accumulators read and written
// once, far below that line at D 128.
// Design: K2b's two-pass core (csrc/attention_backward.cuh; bf16 on
// wgmma fed by TMA; f32 on the CUDA cores' FFMA, csrc/attention_f32.cuh)
// with the ring's geometry: global key offsets (diag =
// q_start - k_start) and the f32 accumulating epilogue (a tile of the
// block wholly above the diagonal is neither fetched nor computed); the
// dK/dV pass owns the block's keys and the dQ
// pass the rank's queries, so each accumulator row has one writer per
// launch and needs no atomics. bf16 inputs round P and dS to bf16 as the
// tensor cores' operands, where the reference differentiates in f32: the
// bf16 kernel is held to the row tolerance. delta = rowsum(dO o) depends
// only on the rank's rows: the first block of a rank's backward computes
// it (`fill_delta`) and the others reuse it. A causal block wholly above
// the diagonal contributes nothing and the wrapper launches nothing for it.
#include "attention_f32.cuh"

namespace brpc_tpu_torch {
namespace {

using attn_bwd::Args;
using attn_bwd::Core;

template <typename T, int DH>
__global__ void __launch_bounds__(Core<T>::kThreads, 1)
    ring_fold_backward_kv_kernel(const Args<T> a,
                                 const __grid_constant__ attn_bwd::Maps maps) {
  Core<T>::template run<DH, true, true>(a, maps);
}

template <typename T, int DH>
__global__ void __launch_bounds__(Core<T>::kThreads, 1)
    ring_fold_backward_q_kernel(const Args<T> a,
                                const __grid_constant__ attn_bwd::Maps maps) {
  Core<T>::template run<DH, false, true>(a, maps);
}

template <typename T>
__global__ void __launch_bounds__(attn_bwd::kDeltaWarps * 32)
    ring_fold_backward_delta_kernel(const T* __restrict__ o,
                                    const T* __restrict__ dout,
                                    float* __restrict__ delta,
                                    long long rows, int dh) {
  attn_bwd::delta_row<T>(o, dout, delta, rows, dh);
}

template <typename T, int DH>
int launch(const Args<T>& a, const void* o, float* delta, bool fill_delta,
           int batch, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set[2] = {{0}, {0}};
  return attn_bwd::launch_passes<T, DH>(
      ring_fold_backward_delta_kernel<T>, ring_fold_backward_kv_kernel<T, DH>,
      ring_fold_backward_q_kernel<T, DH>, a, static_cast<const T*>(o), delta,
      fill_delta, batch, smem_set, stream);
}

template <typename T>
int run(int dh, const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* delta, int fill_delta,
        float* dq, float* dk, float* dv, int batch, int sq, int sk,
        int n_heads, int diag, int causal, float scale,
        cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(q),    static_cast<const T*>(k),
                  static_cast<const T*>(v),    static_cast<const T*>(dout),
                  lse,                         delta,
                  dq,                          dk,
                  dv,                          sq,
                  sk,                          n_heads,
                  n_heads,                     diag,
                  causal,                      scale};
  const bool fill = fill_delta != 0;
  switch (dh) {
    case 32:
      return launch<T, 32>(a, o, delta, fill, batch, stream);
    case 64:
      return launch<T, 64>(a, o, delta, fill, batch, stream);
    case 128:
      return launch<T, 128>(a, o, delta, fill, batch, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace brpc_tpu_torch

// q, o, dout: [batch, sq, n_heads, dh] and k, v: [batch, sk, n_heads, dh]
// in `dtype`; lse, delta: [batch, sq, n_heads] f32 (delta written first when
// fill_delta); dq: [batch, sq, n_heads, dh], dk, dv: [batch, sk, n_heads,
// dh] f32 accumulators, added to in place. All contiguous and 16-byte
// aligned. diag = q_start - k_start.
extern "C" int brpc_ring_attention_fold_backward(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, int fill_delta,
    float* dq, float* dk, float* dv, int batch, int sq, int sk, int n_heads,
    int dh, int diag, int causal, float scale, void* stream) {
  using namespace brpc_tpu_torch;
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_heads <= 0) return 0;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      !aligned16(dout) || !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeFloat32)
    return run<float>(dh, q, k, v, o, dout, lse, delta, fill_delta, dq, dk,
                      dv, batch, sq, sk, n_heads, diag, causal, scale, s);
  if (dtype == kDtypeBFloat16)
    return run<__nv_bfloat16>(dh, q, k, v, o, dout, lse, delta, fill_delta,
                              dq, dk, dv, batch, sq, sk, n_heads, diag,
                              causal, scale, s);
  return cudaErrorInvalidValue;
}

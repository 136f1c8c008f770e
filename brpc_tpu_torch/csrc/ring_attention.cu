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
// Design, bf16: the Hopper forward core (csrc/attention_forward.cuh): a TMA
// producer thread and two consumer warpgroups on wgmma, 128 query rows of
// one (batch, head) a block, K/V tiles of 128 keys through a 3-stage
// mbarrier ring; each consumer issues a tile's S with the previous tile's
// P.V, and the two take turns. The consumers seed their registers with the
// rows' state, fold every tile into it, and write it back (or, on the last
// step, o / l and the LSE), so the state stays O(1) in the ring's length and
// no partial goes through device memory. f32: the SIMT core of
// csrc/attention_f32.cuh (`attn_f32::fwd`, plain FFMA on the CUDA cores, no
// TF32): one block of 256 threads per (batch, head, 128 queries), K/V
// tiles of 64 keys through cp.async stages, 8 x 4 micro-tiles of S and 8
// rows x D / 16 columns of o a thread, seeded from the state and written
// back.
// Under the causal mask a key tile wholly past a block's last row is never
// read, and blocks run heaviest first; a block wholly above the diagonal
// changes nothing (the reference keeps m and its alpha is 1), so the wrapper
// skips it, and on the last step launches with no keys to write the state
// out. bf16 inputs round the probabilities to bf16 before P.V (the tensor
// cores' operand), where the reference folds in f32: the bf16 kernel is
// held to the row tolerance.
// With `lse` the last step also writes each row's log-sum-exp over the whole
// ring (f32, natural units, +inf for a row that saw no key), from which K5b
// (csrc/ring_attention_backward.cu) recomputes the probabilities.
#include "attention_f32.cuh"
#include "attention_forward.cuh"

namespace brpc_tpu_torch {
namespace {

using attn_f32::kF32FwdRows;

// The f32 route's problem (csrc/attention_f32.cuh): the rows of one (batch,
// head, kF32FwdRows queries) against the block's keys.
struct RingProblem {
  static constexpr bool kFolds = true;
  const float* k;
  const float* v;
  int sq, sk, n_heads, dh, b, head, q0, diag;
  bool causal;
  int key_begin, key_end;

  // diag = q_start - k_start: key j is visible to query row i when
  // j <= diag + i (causal). n_keys is sk, or 0 to only write the state out.
  // The keys end at the block's last valid row's edge.
  __device__ RingProblem(const float* k_, const float* v_, int sq_, int sk_,
                         int n_keys, int n_heads_, int dh_, int diag_,
                         bool causal_)
      : k(k_), v(v_), sq(sq_), sk(sk_), n_heads(n_heads_), dh(dh_),
        diag(diag_), causal(causal_) {
    b = blockIdx.x / n_heads;
    head = blockIdx.x - b * n_heads;
    q0 = (gridDim.y - 1 - blockIdx.y) * kF32FwdRows;  // heaviest first
    key_begin = 0;
    key_end = causal ? max(0, min(n_keys, diag + min(q0 + kF32FwdRows, sq)))
                     : n_keys;
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

// The f32 route: the SIMT core (T is float only).
template <typename T, int DH>
__global__ void __launch_bounds__(attn_f32::kF32FwdThreads, 1)
    ring_attention_fold_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, float* o, float* ml,
                               T* out, float* lse, int sq, int sk,
                               int n_keys, int n_heads, int diag, int causal,
                               float scale) {
  const RingProblem p(k, v, sq, sk, n_keys, n_heads, DH, diag, causal != 0);
  const attn::Sink<T> sink{out, o, ml, 0, 0, out == nullptr, lse};
  attn_f32::fwd<DH>(p, q, scale, sink);
}

// The bf16 route: the Hopper forward core (T is bf16 only).
template <typename T, int DH>
__global__ void __launch_bounds__(attn_fwd::kFwdThreads, 1)
    ring_attention_fold_wgmma_kernel(
        const attn_fwd::Args a, const __grid_constant__ attn_fwd::Maps maps) {
  attn_fwd::wgmma_fwd<DH>(a, maps);
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* ml, void* out, float* lse, int batch, int sq, int sk,
               int n_keys, int n_heads, int diag, int causal, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = attn_f32::FwdSmem<DH>::kBytes;
  auto kernel = ring_attention_fold_kernel<float, DH>;
  static std::atomic<unsigned long long> smem_set{0};
  if (int e = attn::allow_smem(kernel, smem, smem_set)) return e;
  const dim3 grid(batch * n_heads, (sq + kF32FwdRows - 1) / kF32FwdRows);
  kernel<<<grid, attn_f32::kF32FwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(ml), static_cast<float*>(out), lse, sq, sk, n_keys,
      n_heads, diag, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* ml, void* out, float* lse, int batch, int sq, int sk,
                int n_keys, int n_heads, int diag, int causal, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = attn_fwd::Smem<DH>::kAlloc;
  auto kernel = ring_attention_fold_wgmma_kernel<__nv_bfloat16, DH>;
  static std::atomic<unsigned long long> smem_set{0};
  if (int e = attn::allow_smem(kernel, smem, smem_set)) return e;
  attn_fwd::Maps maps{};
  if (int e = attn_fwd::encode_maps<DH>(maps, q, k, v, batch, sq, sk,
                                        n_heads))
    return e;
  const attn_fwd::Args a{static_cast<float*>(o),
                         static_cast<float*>(ml),
                         static_cast<__nv_bfloat16*>(out),
                         lse,
                         batch,
                         sq,
                         sk,
                         n_keys,
                         n_heads,
                         diag,
                         causal,
                         scale};
  const unsigned grid = static_cast<unsigned>(batch) * n_heads *
                        ((sq + attn_fwd::kFwdRows - 1) / attn_fwd::kFwdRows);
  kernel<<<grid, attn_fwd::kFwdThreads, smem, stream>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           void* ml, void* out, float* lse, int batch, int sq, int sk,
           int n_keys, int n_heads, int diag, int causal, float scale,
           cudaStream_t stream) {
  if (dtype == kDtypeFloat32)
    return launch_f32<DH>(q, k, v, o, ml, out, lse, batch, sq, sk, n_keys,
                          n_heads, diag, causal, scale, stream);
  if (dtype == kDtypeBFloat16)
    return launch_bf16<DH>(q, k, v, o, ml, out, lse, batch, sq, sk, n_keys,
                           n_heads, diag, causal, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace brpc_tpu_torch

// q: [batch, sq, n_heads, dh]; k, v: [batch, sk, n_heads, dh]; o: [batch,
// sq, n_heads, dh] f32 and ml: [batch, sq, n_heads, 2] f32, the running
// state, updated in place when out is null; out: [batch, sq, n_heads, dh]
// in q's dtype, or null; lse: [batch, sq, n_heads] f32, written with out,
// or null. All contiguous and 16-byte aligned. diag = q_start - k_start;
// n_keys is sk or 0.
extern "C" int brpc_ring_attention_fold(int dtype, const void* q,
                                        const void* k, const void* v,
                                        void* o, void* ml, void* out,
                                        float* lse, int batch, int sq, int sk,
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
  switch (dh) {
    case 32:
      return launch<32>(dtype, q, k, v, o, ml, out, lse, batch, sq, sk,
                        n_keys, n_heads, diag, causal, scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, ml, out, lse, batch, sq, sk,
                        n_keys, n_heads, diag, causal, scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, ml, out, lse, batch, sq, sk,
                         n_keys, n_heads, diag, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

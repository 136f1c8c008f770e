// The attention core shared by K1 (csrc/paged_decode_attention.cu), K2
// (csrc/prefill_attention.cu) and K4 (csrc/paged_prefill_attention.cu): one
// block folds a tile of 64 query rows over a range of keys with an online
// softmax. The kernels differ only in their "problem", a small struct that
// says which global row each of the 64 rows is, the last key each row may
// see, where key j lives, and which key range the block covers. Rows are
// numbered valid first (row_id -1 past the end), so a warp whose first row
// is invalid skips the arithmetic. Two cores, chosen by dtype:
//
// bf16 (`mma_tile`): tensor cores. 4 warps of 16 rows each. The Q tile is
// copied into shared memory and held in registers as the A operand of
// mma.sync.m16n8k16 (bf16 in, f32 accumulate). K and V tiles of 64 keys
// stream in through 16-byte cp.async copies into a double-buffered ring in
// shared memory; rows are padded by 16 bytes so that ldmatrix reads of 8
// rows hit 8 different bank groups. S = Q.K^T comes out of the tensor
// cores in f32, is scaled by the f32-rounded 1/sqrt(Dh) and masked in
// registers, and folds into a running row max and sum (f32; a row's four
// lanes combine with two shuffles). The probabilities, rounded to bf16,
// are the A operand of P.V straight from the S accumulator fragment (the
// m16n8k16 C layout of two 8-key tiles is the A layout of one 16-key
// step), so P never goes through shared memory; V's B operand comes from
// ldmatrix.trans. O accumulates in f32 registers; the division by the sum
// happens once, at the end.
//
// f32 (`f32_tile`): exact f32 math on the CUDA cores, for the f32 model
// (the serving path's stream-exactness check runs f32 with TF32 off, so
// tensor cores cannot serve it). 8 warps of 8 rows; K/V tiles of 32 keys
// staged once in shared memory as f32; lane j forms key j's logit for the
// warp's rows, and P.V gives each lane Dh/32 output columns.
//
// Both cores take the same problems and the same key ranges (a split is
// cut in 64-key tiles, a multiple of the f32 core's 32), and both follow
// the reference's rounding: f32 logits from model-dtype operands times
// softmax_scale, masked keys skipped, probabilities rounded to the model
// dtype before P.V, P.V accumulated in f32, one division by the sum.
//
// A block writes either its final rows (one split: O / l rounded to T) or,
// when the key range is cut into splits, an unnormalised f32 partial O with
// its row max m and sum l, which a merge pass (`merge_row`, below) combines.
// A row that sees no key of its split keeps m = -inf and l = 0, and the
// merge gives it weight 0.
//
// A problem that declares `static constexpr bool kFolds = true` (K5, the
// ring's block fold, csrc/ring_attention.cu) does neither: the block's
// (O, m, l) is folded into a running f32 state of its rows by merge_row's
// rule (`fold_row`), which then stays in place or, on the ring's last step,
// is written out as O / l rounded to T. Its key range may be empty: the
// block then only writes the state out.
#pragma once

#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace brpc_tpu_torch {
namespace attn {

constexpr int kTileRows = 64;  // query rows of one block, both cores
constexpr int kTileKeys = 64;  // keys of one bf16 tile; a split's unit
// Blocks of the bf16 core an SM holds at once: 68 KB of shared memory and
// at most 168 registers a thread. K4's split planner aims its grid at this
// many blocks per SM (ops/attention.py reads these three constants from
// this file).
constexpr int kMmaMinBlocks = 3;
constexpr int kMmaThreads = 128;
constexpr int kF32Threads = 256;
constexpr int kF32Keys = 32;
constexpr float kLog2e = 1.4426950408889634f;

// Where a block's rows go. Rows are numbered as in q and out, [n, H]
// flattened; partials are [split][row][Dh] f32 and [split][row][2] (m, l).
// For a folding problem o_part and ml_part are the running state, [row][Dh]
// and [row][2], and `partial` keeps it there (false: write out O / l).
template <typename T>
struct Sink {
  T* out;
  float* o_part;
  float* ml_part;
  int n_rows;  // n * H
  int split;
  bool partial;
};

template <typename P, typename = void>
struct Folds : std::false_type {};
template <typename P>
struct Folds<P, std::void_t<decltype(P::kFolds)>>
    : std::bool_constant<P::kFolds> {};

// Folds a block's row (its unnormalised o over `n` columns `cols(j)`, max
// m and sum l) into the running state (ms, ls, read by the caller before a
// __syncwarp, and the state's O row) by merge_row's rule; `writer` is the
// one lane that stores m and l. With sink.partial the state is updated in
// place, else the row O / l (l = 0 read as 1) is written to out.
template <typename T, int N, typename Cols>
__device__ __forceinline__ void fold_row(const Sink<T>& sink, int rid,
                                         int dh, const float* o, float m,
                                         float l, float ms, float ls,
                                         bool writer, Cols cols) {
  const float mx = fmaxf(ms, m);
  const float ws = ms == -INFINITY ? 0.f : expf(ms - mx);
  const float wb = m == -INFINITY ? 0.f : expf(m - mx);
  const float lsum = ws * ls + wb * l;
  float* srow = sink.o_part + static_cast<long long>(rid) * dh;
  if (sink.partial) {
#pragma unroll
    for (int j = 0; j < N; ++j) srow[cols(j)] = ws * srow[cols(j)] + wb * o[j];
    if (writer) {
      sink.ml_part[static_cast<long long>(rid) * 2] = mx;
      sink.ml_part[static_cast<long long>(rid) * 2 + 1] = lsum;
    }
  } else {
    const float inv = 1.0f / (lsum == 0.f ? 1.f : lsum);
    T* orow = sink.out + static_cast<long long>(rid) * dh;
#pragma unroll
    for (int j = 0; j < N; ++j)
      orow[cols(j)] = from_f32<T>((ws * srow[cols(j)] + wb * o[j]) * inv);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with pred false the destination is zero-filled and
// nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (nearest even), the lower column in the
// low half, as an mma operand register holds them.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A block whose key range is empty (a split wholly past its tile's causal
// edge) contributes nothing: m = -inf, l = 0 for its rows.
template <typename T, typename Problem>
__device__ void write_empty(const Problem& p, const Sink<T>& sink) {
  if (!sink.partial) return;  // one split always holds key 0
  for (int r = threadIdx.x; r < kTileRows; r += blockDim.x) {
    const int rid = p.row_id(r);
    if (rid < 0) continue;
    float* ml = sink.ml_part +
                (static_cast<long long>(sink.split) * sink.n_rows + rid) * 2;
    ml[0] = -INFINITY;
    ml[1] = 0.f;
  }
}

// ---- bf16 on the tensor cores ----------------------------------------------

template <int DH>
constexpr size_t mma_smem_bytes() {
  // Two K and two V tiles, each row padded by 8 elements; Q passes through
  // the second K tile before the first load into it.
  static_assert(kTileRows == kTileKeys, "Q borrows a K tile");
  return static_cast<size_t>(4 * kTileKeys) * (DH + 8) *
         sizeof(__nv_bfloat16);
}

template <int DH, typename Problem>
__device__ __forceinline__ void mma_load_kv(const Problem& p,
                                            __nv_bfloat16* ks,
                                            __nv_bfloat16* vs, int k0,
                                            int key_end) {
  constexpr int kStride = DH + 8;
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTileKeys * kChunks; c += kMmaThreads) {
    const int t = c / kChunks;
    const int ch = (c - t * kChunks) * 8;
    const int key = k0 + t;
    const bool ok = key < key_end;
    const long long off = ok ? p.kv_offset(key) : 0;
    cp_async16(ks + t * kStride + ch, p.k + off + ch, ok);
    cp_async16(vs + t * kStride + ch, p.v + off + ch, ok);
  }
}

template <int DH, typename Problem>
__device__ void mma_tile(const Problem& p, const __nv_bfloat16* __restrict__ q,
                         float scale, const Sink<__nv_bfloat16>& sink) {
  using bf16 = __nv_bfloat16;
  constexpr int kStride = DH + 8;
  constexpr int kChunks = DH / 8;
  constexpr int kDSteps = DH / 16;  // k-steps of Q.K^T, n-tile pairs of P.V
  if (!Folds<Problem>::value && p.key_begin >= p.key_end) {
    write_empty(p, sink);
    return;
  }
  extern __shared__ float4 smem_f4[];
  bf16* ks = reinterpret_cast<bf16*>(smem_f4);  // [2][kTileKeys][kStride]
  bf16* vs = ks + 2 * kTileKeys * kStride;
  bf16* qs = ks + kTileKeys * kStride;  // K buffer 1 until tile 1 loads

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int c = threadIdx.x; c < kTileRows * kChunks; c += kMmaThreads) {
    const int r = c / kChunks;
    const int ch = (c - r * kChunks) * 8;
    const int rid = p.row_id(r);
    cp_async16(qs + r * kStride + ch,
               q + static_cast<long long>(rid < 0 ? 0 : rid) * DH + ch,
               rid >= 0);
  }
  cp_async_commit();
  const int n_tiles =
      max(0, (p.key_end - p.key_begin + kTileKeys - 1) / kTileKeys);
  if (n_tiles > 0) mma_load_kv<DH>(p, ks, vs, p.key_begin, p.key_end);
  cp_async_commit();

  // Rows are numbered valid first, so a warp whose first row is past the
  // end has nothing to compute; it still loads and meets every barrier.
  const bool active = p.row_id(warp * 16) >= 0;
  const int row_a = warp * 16 + lane / 4;  // this lane's two rows
  const int edge_a = p.edge(row_a);
  const int edge_b = p.edge(row_a + 8);

  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kDSteps][4];
  {
    const int r = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk)
      ldmatrix_x4(qf[kk],
                  smem_addr(qs + r * kStride + kk * 16 + (lane / 16) * 8));
  }
  __syncthreads();  // Q is in registers: its buffer takes tile 1

  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = p.key_begin + it * kTileKeys;
    if (it + 1 < n_tiles)
      mma_load_kv<DH>(p, ks + ((it + 1) & 1) * kTileKeys * kStride,
                      vs + ((it + 1) & 1) * kTileKeys * kStride,
                      k0 + kTileKeys, p.key_end);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + (it & 1) * kTileKeys * kStride;
    const bf16* vt = vs + (it & 1) * kTileKeys * kStride;
    if (active) {
      // S = Q.K^T: 8 n-tiles of 8 keys; ldmatrix.x4 brings two n-tiles'
      // B fragments (keys rows, Dh columns) per k-step.
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const int kr = (lane % 8) + (lane / 16) * 8;
      const int kc = ((lane / 8) % 2) * 8;
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(kt + (np * 16 + kr) * kStride + kk * 16 +
                                   kc));
          mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
        }
      }
      // Scale, mask, and fold into the running max and sum. Lane holds
      // rows row_a (s[.][0..1]) and row_a + 8 (s[.][2..3]), keys
      // k0 + 8 nt + 2 (lane % 4) + {0, 1}.
      const int kb = k0 + 2 * (lane % 4);
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kb + nt * 8 + e;
          const bool in = key < p.key_end;
          const float va =
              in && key <= edge_a ? s[nt][e] * scale : -INFINITY;
          const float vb =
              in && key <= edge_b ? s[nt][2 + e] * scale : -INFINITY;
          s[nt][e] = va;
          s[nt][2 + e] = vb;
          mx_a = fmaxf(mx_a, va);
          mx_b = fmaxf(mx_b, vb);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a);
      const float mn_b = fmaxf(m_b, mx_b);
      // A row with no visible key yet keeps max -inf; subtracting 0 then
      // keeps exp(-inf) = 0 and never forms -inf - -inf.
      const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = exp2f((m_a - mu_a) * kLog2e);
      const float al_b = exp2f((m_b - mu_b) * kLog2e);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = exp2f((s[nt][e] - mu_a) * kLog2e);
          s[nt][2 + e] = exp2f((s[nt][2 + e] - mu_b) * kLog2e);
          sum_a += s[nt][e];
          sum_b += s[nt][2 + e];
        }
      }
      l_a = l_a * al_a + sum_a;  // this lane's share; lanes combine at the end
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[j][0] *= al_a;
        o[j][1] *= al_a;
        o[j][2] *= al_b;
        o[j][3] *= al_b;
      }
      // O += P.V, 16 keys per step: the C fragments of n-tiles 2ks and
      // 2ks + 1, rounded to bf16, are the A fragment of the step.
      const int vr = (lane % 8) + ((lane / 8) % 2) * 8;
      const int vc = (lane / 16) * 8;
#pragma unroll
      for (int kstep = 0; kstep < 4; ++kstep) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kstep][0], s[2 * kstep][1]);
        a[1] = pack_bf16(s[2 * kstep][2], s[2 * kstep][3]);
        a[2] = pack_bf16(s[2 * kstep + 1][0], s[2 * kstep + 1][1]);
        a[3] = pack_bf16(s[2 * kstep + 1][2], s[2 * kstep + 1][3]);
#pragma unroll
        for (int dp = 0; dp < kDSteps; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(vt + (kstep * 16 + vr) * kStride +
                                         dp * 16 + vc));
          mma_bf16(o[2 * dp], a, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is free for the load two tiles on
  }

  if (!active) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const int col = 2 * (lane % 4);
  if constexpr (Folds<Problem>::value) {
    // This lane's columns of its two rows, then the fold of each row.
    const int rid[2] = {p.row_id(row_a), p.row_id(row_a + 8)};
    const float mb[2] = {m_a, m_b}, lb[2] = {l_a, l_b};
    float ms[2], ls[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ms[h] = rid[h] < 0 ? -INFINITY
                         : sink.ml_part[static_cast<long long>(rid[h]) * 2];
      ls[h] = rid[h] < 0 ? 0.f
                         : sink.ml_part[static_cast<long long>(rid[h]) * 2 + 1];
    }
    __syncwarp();  // every lane has read m and l before one writes them
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rid[h] < 0) continue;
      float ov[DH / 4];
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        ov[2 * j] = o[j][2 * h];
        ov[2 * j + 1] = o[j][2 * h + 1];
      }
      fold_row<bf16, DH / 4>(sink, rid[h], DH, ov, mb[h], lb[h], ms[h], ls[h],
                             lane % 4 == 0, [&](int j) {
                               return (j / 2) * 8 + col + (j % 2);
                             });
    }
  } else {
    // Row row_a + 8 h of this lane: o[.][2 h], o[.][2 h + 1].
    auto store = [&](int rid, float m, float l, int h) {
      if (rid < 0) return;
      if (!sink.partial) {
        const float inv = 1.0f / l;
        bf16* orow = sink.out + static_cast<long long>(rid) * DH;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + col) =
              __floats2bfloat162_rn(o[j][2 * h] * inv,
                                    o[j][2 * h + 1] * inv);
      } else {
        const long long prow =
            static_cast<long long>(sink.split) * sink.n_rows + rid;
        float* orow = sink.o_part + prow * DH;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<float2*>(orow + j * 8 + col) =
              make_float2(o[j][2 * h], o[j][2 * h + 1]);
        if (lane % 4 == 0) {
          sink.ml_part[prow * 2] = m;
          sink.ml_part[prow * 2 + 1] = l;
        }
      }
    };
    store(p.row_id(row_a), m_a, l_a, 0);
    store(p.row_id(row_a + 8), m_b, l_b, 1);
  }
}

// ---- f32 on the CUDA cores ------------------------------------------------

template <int DH>
constexpr size_t f32_smem_bytes() {
  return (static_cast<size_t>(kTileRows) * DH +
          static_cast<size_t>(kF32Keys) * (DH + 4) +
          static_cast<size_t>(kF32Keys) * DH) *
         sizeof(float);
}

template <int DH, typename Problem>
__device__ void f32_tile(const Problem& p, const float* __restrict__ q,
                         float scale, const Sink<float>& sink) {
  constexpr int kWarps = kF32Threads / 32;
  constexpr int kRows = kTileRows / kWarps;  // query rows per warp
  constexpr int kVpt = DH / 32;
  constexpr int kStrideK = DH + 4;  // keeps float4 rows 16-byte aligned
  if (!Folds<Problem>::value && p.key_begin >= p.key_end) {
    write_empty(p, sink);
    return;
  }
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // [kTileRows][DH]
  float* ks = qs + kTileRows * DH;                 // [kF32Keys][kStrideK]
  float* vs = ks + kF32Keys * kStrideK;            // [kF32Keys][DH]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // As in mma_tile: a warp whose first row is past the end only loads.
  const bool active = p.row_id(warp * kRows) >= 0;

  for (int i = threadIdx.x; i < kTileRows * DH; i += kF32Threads) {
    const int r = i / DH;
    const int rid = p.row_id(r);
    qs[i] = rid >= 0 ? q[static_cast<long long>(rid) * DH + (i - r * DH)]
                     : 0.f;
  }
  int edge[kRows];
  float acc[kRows][kVpt];
  float m[kRows];
  float l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    edge[r] = p.edge(warp * kRows + r);
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kVpt; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = p.key_begin; k0 < p.key_end; k0 += kF32Keys) {
    __syncthreads();  // previous tile consumed (and qs written, first pass)
    for (int i = threadIdx.x; i < kF32Keys * DH; i += kF32Threads) {
      const int t = i / DH;
      const int d = i - t * DH;
      const int key = k0 + t;
      float kv_k = 0.f, kv_v = 0.f;
      if (key < p.key_end) {
        const long long off = p.kv_offset(key) + d;
        kv_k = p.k[off];
        kv_v = p.v[off];
      }
      ks[t * kStrideK + d] = kv_k;
      vs[t * DH + d] = kv_v;
    }
    __syncthreads();
    if (!active) continue;

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
      const bool valid = key < p.key_end && key <= edge[r];
      const float sv = valid ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
      const float e = valid ? expf(sv - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(e);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kVpt; ++j) acc[r][j] *= alpha;
      pr[r] = e;
    }
    // P.V: lane owns output columns lane + 32 * j.
    const int n_keys = min(kF32Keys, p.key_end - k0);
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

  if (!active) return;
  if constexpr (Folds<Problem>::value) {
    // A row's id is the same on every lane of its warp.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rid = p.row_id(warp * kRows + r);
      if (rid < 0) continue;
      const float ms = sink.ml_part[static_cast<long long>(rid) * 2];
      const float ls = sink.ml_part[static_cast<long long>(rid) * 2 + 1];
      __syncwarp();  // every lane has read m and l before lane 0 writes them
      fold_row<float, kVpt>(sink, rid, DH, acc[r], m[r], l[r], ms, ls,
                            lane == 0, [&](int j) { return lane + 32 * j; });
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rid = p.row_id(warp * kRows + r);
      if (rid < 0) continue;
      if (!sink.partial) {
        const float inv = 1.0f / l[r];
        float* orow = sink.out + static_cast<long long>(rid) * DH;
#pragma unroll
        for (int j = 0; j < kVpt; ++j) orow[lane + 32 * j] = acc[r][j] * inv;
      } else {
        const long long prow =
            static_cast<long long>(sink.split) * sink.n_rows + rid;
        float* orow = sink.o_part + prow * DH;
#pragma unroll
        for (int j = 0; j < kVpt; ++j) orow[lane + 32 * j] = acc[r][j];
        if (lane == 0) {
          sink.ml_part[prow * 2] = m[r];
          sink.ml_part[prow * 2 + 1] = l[r];
        }
      }
    }
  }
}

// ---- merge of the split partials --------------------------------------------

constexpr int kMergeWarps = 4;  // rows (warps) of one merge block

// Row `row` of the merge: out[row] = sum_s w_s o_part[s, row] /
// sum_s w_s l_s with w_s = exp(m_s - max_s m_s), skipping splits the row
// saw no key of (m_s = -inf: weight 0, O never written), rounded to T once.
// One warp per row, lane + 32 j owns column j. Each kernel that splits
// wraps this in a __global__ of its own name (kMergeWarps warps a block).
template <typename T, int DH>
__device__ __forceinline__ void merge_row(const float* __restrict__ o_part,
                                          const float* __restrict__ ml_part,
                                          T* __restrict__ out, int n_rows,
                                          int n_splits) {
  constexpr int kVpt = DH / 32;
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  float mx = -INFINITY;
  for (int s = 0; s < n_splits; ++s)
    mx = fmaxf(mx, ml_part[(static_cast<long long>(s) * n_rows + row) * 2]);
  float acc[kVpt];
#pragma unroll
  for (int j = 0; j < kVpt; ++j) acc[j] = 0.f;
  float sum = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const long long prow = static_cast<long long>(s) * n_rows + row;
    const float m = ml_part[prow * 2];
    if (m == -INFINITY) continue;  // no visible key: weight 0, O unwritten
    const float w = expf(m - mx);
    sum += w * ml_part[prow * 2 + 1];
    const float* orow = o_part + prow * DH;
#pragma unroll
    for (int j = 0; j < kVpt; ++j) acc[j] += w * orow[lane + 32 * j];
  }
  const float inv = 1.0f / sum;
  T* orow = out + static_cast<long long>(row) * DH;
#pragma unroll
  for (int j = 0; j < kVpt; ++j)
    orow[lane + 32 * j] = from_f32<T>(acc[j] * inv);
}

__host__ __forceinline__ unsigned merge_blocks(int n_rows) {
  return static_cast<unsigned>((n_rows + kMergeWarps - 1) / kMergeWarps);
}

// ---- dispatch ----------------------------------------------------------------

template <typename T>
struct Core;
template <>
struct Core<__nv_bfloat16> {
  static constexpr int kThreads = kMmaThreads;
  static constexpr int kMinBlocks = kMmaMinBlocks;
  template <int DH>
  static constexpr size_t smem() { return mma_smem_bytes<DH>(); }
  template <int DH, typename Problem>
  static __device__ void run(const Problem& p, const __nv_bfloat16* q,
                             float scale, const Sink<__nv_bfloat16>& sink) {
    mma_tile<DH>(p, q, scale, sink);
  }
};
template <>
struct Core<float> {
  static constexpr int kThreads = kF32Threads;
  static constexpr int kMinBlocks = 1;
  template <int DH>
  static constexpr size_t smem() { return f32_smem_bytes<DH>(); }
  template <int DH, typename Problem>
  static __device__ void run(const Problem& p, const float* q, float scale,
                             const Sink<float>& sink) {
    f32_tile<DH>(p, q, scale, sink);
  }
};

// Allows the kernel its dynamic shared memory (above 48 KB needs the
// attribute), once per device: `done` is the caller's per-kernel bit set of
// devices already set up. Returns the first error.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem,
               std::atomic<unsigned long long>& done) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return 0;
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)))
    return static_cast<int>(e);
  done.fetch_or(bit, std::memory_order_relaxed);
  return 0;
}

}  // namespace attn
}  // namespace brpc_tpu_torch

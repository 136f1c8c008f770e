// The attention backward core shared by K2b (csrc/attention_backward.cu)
// and K5b (csrc/ring_attention_backward.cu): FlashAttention-2's backward,
// which recomputes the probabilities from the forward's saved row
// log-sum-exp instead of keeping them.
//
// For a row (query i, head h) with logits s_ij = scale q_i.k_j, the saved
// lse_i = log sum_j exp(s_ij) (natural units, as the forward core's m and
// l are; +inf for a row that saw no key) and delta_i = sum_d dO_id O_id:
//   P_ij = exp(s_ij - lse_i) on visible keys, 0 elsewhere,
//   dS_ij = P_ij (dO_i.v_j - delta_i),
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,
//   dv_j = sum_i P_ij dO_i,
// with dk and dv of a KV head summed over its H / KV query heads.
// delta comes from a pre-pass (`delta_row`, one warp per row) of the
// kernel's own source.
//
// Two passes, neither with atomics, so every run sums in the same order:
// - the dK/dV pass: one block per (batch, KV head, 64 keys) owns the
//   keys' dk and dv and walks the query tiles that can see them (causal:
//   from the first query at or past the block's first key), for each of
//   the KV head's query heads;
// - the dQ pass: one block per (batch, head, 64 queries) owns their dq and
//   walks the key tiles up to its causal edge, heaviest tiles first.
// The same body serves both: a block's "own" rows (keys, or queries) stay
// in shared memory while "column" tiles of the other side stream past.
//
// bf16 (`mma_bwd`): tensor cores, mma.sync.m16n8k16 with f32 accumulation,
// 4 warps of 16 own rows; operands come from shared memory through
// ldmatrix (non-transposed for the two logit-like products, S = X_own .
// X_col^T and dP = Y_own . Y_col^T, transposed for the two accumulations),
// 16 columns at a time, so the S and dP fragments stay 8 registers each and
// the accumulators (dk and dv: 2 x Dh/2 f32 a thread) fit at Dh 128 without
// spilling. P (as the forward rounds it before P.V) and dS are rounded to
// bf16 as the A operands of the accumulations straight from the S and dP
// fragments (the C layout of two 8-column tiles is the A layout of one
// 16-column step, as in the forward core).
// f32 (`f32_bwd`): exact f32 on the CUDA cores, 8 warps of 8 own rows;
// lane j takes column j of a 32-column tile for the logit-like products,
// then every lane owns Dh / 32 output columns for the accumulations,
// with P and dS broadcast by shuffles.
//
// Outputs: a kernel writes its rows either rounded to T (K2b: dq, dk, dv in
// the model dtype) or added to f32 accumulators (K5b: a ring block's
// contributions, `kAcc`).
#pragma once

#include "attention_tile.cuh"

namespace brpc_tpu_torch {
namespace attn_bwd {

using attn::kTileRows;             // own rows of a block, both cores
constexpr int kMmaCols = 64;       // columns of a staged tile, bf16 core
constexpr int kF32Cols = 32;       // columns of a staged tile, f32 core

// q, dout: [B, sq, H, Dh]; k, v: [B, sk, KV, Dh]; lse, delta: [B, sq, H]
// f32. dq is laid out as q, dk and dv as k. Key j is visible to query i
// when !causal or j <= diag + i (K2b: diag 0; K5b: q_start - k_start).
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int sq, sk, n_heads, n_kv_heads, diag, causal;
  float scale;
};

// Which rows a block owns and which column tiles it walks. kKv: own rows
// are keys j of KV head `own_head`, columns the queries of its `rep` query
// heads; else own rows are queries of head `own_head`, columns the keys of
// its KV head.
template <bool kKv>
struct Geom {
  int b, own_head, col_head0, n_col_heads, own0, col_begin, col_end;

  template <typename T>
  __device__ explicit Geom(const Args<T>& a) {
    const int rep = a.n_heads / a.n_kv_heads;
    if (kKv) {
      b = blockIdx.x / a.n_kv_heads;
      own_head = blockIdx.x - b * a.n_kv_heads;
      own0 = blockIdx.y * kTileRows;  // early keys see the most queries
      col_head0 = own_head * rep;
      n_col_heads = rep;
      col_begin = a.causal ? max(0, own0 - a.diag) : 0;
      col_end = a.sq;
    } else {
      b = blockIdx.x / a.n_heads;
      own_head = blockIdx.x - b * a.n_heads;
      own0 = (gridDim.y - 1 - blockIdx.y) * kTileRows;  // heaviest first
      col_head0 = own_head / rep;
      n_col_heads = 1;
      col_begin = 0;
      col_end = a.causal ? max(0, min(a.sk, a.diag + own0 + kTileRows))
                         : a.sk;
    }
    if (col_begin > col_end) col_begin = col_end;
  }
  __device__ int per_head(int cols) const {
    return (col_end - col_begin + cols - 1) / cols;
  }
  __device__ int n_tiles(int cols) const {
    return per_head(cols) * n_col_heads;
  }
  // Tile t: its head and first column.
  __device__ void tile(int t, int cols, int& head, int& c0) const {
    const int ph = per_head(cols);
    head = col_head0 + t / ph;
    c0 = col_begin + (t - (t / ph) * ph) * cols;
  }
  template <typename T>
  __device__ bool own_valid(const Args<T>& a, int i) const {
    return i < (kKv ? a.sk : a.sq);
  }
  // Element offset of own row i (k/v/dk/dv rows, or q/dout/dq rows).
  template <typename T>
  __device__ long long own_off(const Args<T>& a, int i, int dh) const {
    return kKv ? (static_cast<long long>(b * a.sk + i) * a.n_kv_heads +
                  own_head) * dh
               : (static_cast<long long>(b * a.sq + i) * a.n_heads +
                  own_head) * dh;
  }
  template <typename T>
  __device__ long long col_off(const Args<T>& a, int i, int head,
                               int dh) const {
    return kKv ? (static_cast<long long>(b * a.sq + i) * a.n_heads + head) *
                     dh
               : (static_cast<long long>(b * a.sk + i) * a.n_kv_heads +
                  head) * dh;
  }
  // Index of query row i of head `head` in lse and delta.
  template <typename T>
  __device__ long long stat_idx(const Args<T>& a, int i, int head) const {
    return static_cast<long long>(b * a.sq + i) * a.n_heads + head;
  }
  // Own row i against column c (both valid): visible?
  template <typename T>
  __device__ bool visible(const Args<T>& a, int i, int c) const {
    const int key = kKv ? i : c;
    const int query = kKv ? c : i;
    return !a.causal || key <= a.diag + query;
  }
};

// One output row segment: rounded to T and stored, or added to f32.
template <typename T, bool kAcc>
__device__ __forceinline__ void put2(void* out, long long off, float v0,
                                     float v1) {
  if (kAcc) {
    float2* p = reinterpret_cast<float2*>(static_cast<float*>(out) + off);
    float2 cur = *p;
    cur.x += v0;
    cur.y += v1;
    *p = cur;
  } else {
    T* p = static_cast<T*>(out) + off;
    p[0] = from_f32<T>(v0);
    p[1] = from_f32<T>(v1);
  }
}

template <typename T, bool kAcc>
__device__ __forceinline__ void put1(void* out, long long off, float v) {
  if (kAcc)
    static_cast<float*>(out)[off] += v;
  else
    static_cast<T*>(out)[off] = from_f32<T>(v);
}

// ---- bf16 on the tensor cores ----------------------------------------------

template <int DH>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(2 * kTileRows + 2 * kMmaCols) * (DH + 8) *
             sizeof(__nv_bfloat16) +
         2 * kMmaCols * sizeof(float);
}

// c = A . B^T for the warp's 16 own rows of `own` and the 16 rows c16.. of
// `col` (both [rows][DH + 8] bf16 in shared memory): c[nt][e] is own row
// lane / 4 + 8 (e / 2), column nt * 8 + 2 (lane % 4) + e % 2.
template <int DH>
__device__ __forceinline__ void mma_abt(float (&c)[2][4],
                                        const __nv_bfloat16* own,
                                        const __nv_bfloat16* col, int warp,
                                        int lane, int c16) {
  constexpr int kStride = DH + 8;
  const int ar = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
  const int ac = (lane / 16) * 8;
  const int br = c16 + (lane % 8) + (lane / 16) * 8;
  const int bc = ((lane / 8) % 2) * 8;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4], b[4];
    attn::ldmatrix_x4(a, attn::smem_addr(own + ar * kStride + kk * 16 + ac));
    attn::ldmatrix_x4(b, attn::smem_addr(col + br * kStride + kk * 16 + bc));
    attn::mma_bf16(c[0], a, b[0], b[1]);
    attn::mma_bf16(c[1], a, b[2], b[3]);
  }
}

// acc (16 own rows x DH) += w (16 x 16, a C fragment pair from mma_abt,
// rounded to bf16) . rows c16..c16+15 of `col` ([rows][DH + 8] bf16).
template <int DH>
__device__ __forceinline__ void mma_acc(float (&acc)[DH / 8][4],
                                        const float (&w)[2][4],
                                        const __nv_bfloat16* col, int lane,
                                        int c16) {
  constexpr int kStride = DH + 8;
  uint32_t a[4];
  a[0] = attn::pack_bf16(w[0][0], w[0][1]);
  a[1] = attn::pack_bf16(w[0][2], w[0][3]);
  a[2] = attn::pack_bf16(w[1][0], w[1][1]);
  a[3] = attn::pack_bf16(w[1][2], w[1][3]);
  const int vr = (lane % 8) + ((lane / 8) % 2) * 8;
  const int vc = (lane / 16) * 8;
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    uint32_t b[4];
    attn::ldmatrix_x4_trans(
        b, attn::smem_addr(col + (c16 + vr) * kStride + dp * 16 + vc));
    attn::mma_bf16(acc[2 * dp], a, b[0], b[1]);
    attn::mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

template <typename T, int DH, bool kAcc>
__device__ __forceinline__ void mma_store(void* out, long long off,
                                          const float (&acc)[DH / 8][4],
                                          int h, int lane, float mul) {
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
    put2<T, kAcc>(out, off + j * 8 + col, acc[j][2 * h] * mul,
                  acc[j][2 * h + 1] * mul);
}

template <int DH, bool kKv, bool kAcc>
__device__ void mma_bwd(const Args<__nv_bfloat16>& a) {
  using bf16 = __nv_bfloat16;
  constexpr int kStride = DH + 8;
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  constexpr int kThreads = attn::kMmaThreads;
  const Geom<kKv> g(a);
  extern __shared__ float4 smem_f4[];
  bf16* xo = reinterpret_cast<bf16*>(smem_f4);  // own K (kv) or Q
  bf16* yo = xo + kTileRows * kStride;          // own V or dO
  bf16* xc = yo + kTileRows * kStride;          // column Q (kv) or K
  bf16* yc = xc + kMmaCols * kStride;           // column dO or V
  float* lse_s = reinterpret_cast<float*>(yc + kMmaCols * kStride);
  float* del_s = lse_s + kMmaCols;
  const bf16* own_x = kKv ? a.k : a.q;
  const bf16* own_y = kKv ? a.v : a.dout;
  const bf16* col_x = kKv ? a.q : a.k;
  const bf16* col_y = kKv ? a.dout : a.v;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int c = threadIdx.x; c < kTileRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int ch = (c - r * kChunks) * 8;
    const bool ok = g.own_valid(a, g.own0 + r);
    const long long off = ok ? g.own_off(a, g.own0 + r, DH) : 0;
    attn::cp_async16(xo + r * kStride + ch, own_x + off + ch, ok);
    attn::cp_async16(yo + r * kStride + ch, own_y + off + ch, ok);
  }
  attn::cp_async_commit();

  // Own rows are numbered from the tile's start, so a warp whose first row
  // is past the end has nothing to compute; it still loads and meets every
  // barrier.
  const bool active = g.own_valid(a, g.own0 + warp * 16);
  int own_i[2];
  float lse_r[2], del_r[2];  // the dQ pass: this lane's two query rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    own_i[h] = g.own0 + warp * 16 + lane / 4 + 8 * h;
    const bool ok = !kKv && g.own_valid(a, own_i[h]);
    lse_r[h] = ok ? a.lse[g.stat_idx(a, own_i[h], g.own_head)] : INFINITY;
    del_r[h] = ok ? a.delta[g.stat_idx(a, own_i[h], g.own_head)] : 0.f;
  }
  float acc1[DH / 8][4];  // dk (kv) or dq
  float acc2[DH / 8][4];  // dv (kv only)
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[j][e] = acc2[j][e] = 0.f;

  const int n_tiles = g.n_tiles(kMmaCols);
  for (int t = 0; t < n_tiles; ++t) {
    int hh, c0;
    g.tile(t, kMmaCols, hh, c0);
    __syncthreads();  // the previous tile is consumed
    for (int c = threadIdx.x; c < kMmaCols * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int ch = (c - r * kChunks) * 8;
      const bool ok = c0 + r < g.col_end;
      const long long off = ok ? g.col_off(a, c0 + r, hh, DH) : 0;
      attn::cp_async16(xc + r * kStride + ch, col_x + off + ch, ok);
      attn::cp_async16(yc + r * kStride + ch, col_y + off + ch, ok);
    }
    if (kKv) {
      for (int r = threadIdx.x; r < kMmaCols; r += kThreads) {
        const bool ok = c0 + r < g.col_end;
        const long long idx = ok ? g.stat_idx(a, c0 + r, hh) : 0;
        lse_s[r] = ok ? a.lse[idx] : INFINITY;
        del_s[r] = ok ? a.delta[idx] : 0.f;
      }
    }
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    for (int c16 = 0; c16 < kMmaCols; c16 += 16) {
      if (c0 + c16 >= g.col_end) break;  // the same for the whole block
      float s[2][4], dp[2][4];
      mma_abt<DH>(s, xo, xc, warp, lane, c16);
      mma_abt<DH>(dp, yo, yc, warp, lane, c16);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const int cc = c16 + nt * 8 + 2 * (lane % 4) + (e % 2);
          const int ci = c0 + cc;
          const float l = kKv ? lse_s[cc] : lse_r[h];
          const float dl = kKv ? del_s[cc] : del_r[h];
          const bool vis = ci < g.col_end && g.own_valid(a, own_i[h]) &&
                           g.visible(a, own_i[h], ci);
          const float pr = vis ? expf(s[nt][e] * a.scale - l) : 0.f;
          s[nt][e] = pr;
          dp[nt][e] = pr * (dp[nt][e] - dl);
        }
      }
      if (kKv) {
        mma_acc<DH>(acc2, s, yc, lane, c16);   // dv += P^T . dO
        mma_acc<DH>(acc1, dp, xc, lane, c16);  // dk += dS^T . Q
      } else {
        mma_acc<DH>(acc1, dp, xc, lane, c16);  // dq += dS . K
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!g.own_valid(a, own_i[h])) continue;
    const long long off = g.own_off(a, own_i[h], DH);
    if (kKv) {
      mma_store<bf16, DH, kAcc>(a.dk, off, acc1, h, lane, a.scale);
      mma_store<bf16, DH, kAcc>(a.dv, off, acc2, h, lane, 1.f);
    } else {
      mma_store<bf16, DH, kAcc>(a.dq, off, acc1, h, lane, a.scale);
    }
  }
}

// ---- f32 on the CUDA cores ------------------------------------------------

template <int DH>
constexpr size_t f32_smem_bytes() {
  return (static_cast<size_t>(2 * kTileRows) * DH +
          static_cast<size_t>(2 * kF32Cols) * (DH + 4) + 2 * kF32Cols) *
         sizeof(float);
}

template <int DH, bool kKv, bool kAcc>
__device__ void f32_bwd(const Args<float>& a) {
  constexpr int kThreads = attn::kF32Threads;
  constexpr int kRows = kTileRows / (kThreads / 32);  // own rows per warp
  constexpr int kVpt = DH / 32;
  constexpr int kStrideC = DH + 4;  // keeps float4 rows 16-byte aligned
  const Geom<kKv> g(a);
  extern __shared__ float4 smem_f4[];
  float* xo = reinterpret_cast<float*>(smem_f4);  // [kTileRows][DH]
  float* yo = xo + kTileRows * DH;
  float* xc = yo + kTileRows * DH;  // [kF32Cols][kStrideC]
  float* yc = xc + kF32Cols * kStrideC;
  float* lse_s = yc + kF32Cols * kStrideC;
  float* del_s = lse_s + kF32Cols;
  const float* own_x = kKv ? a.k : a.q;
  const float* own_y = kKv ? a.v : a.dout;
  const float* col_x = kKv ? a.q : a.k;
  const float* col_y = kKv ? a.dout : a.v;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kTileRows * DH; i += kThreads) {
    const int r = i / DH;
    const int d = i - r * DH;
    const bool ok = g.own_valid(a, g.own0 + r);
    const long long off = ok ? g.own_off(a, g.own0 + r, DH) + d : 0;
    xo[i] = ok ? own_x[off] : 0.f;
    yo[i] = ok ? own_y[off] : 0.f;
  }
  const bool active = g.own_valid(a, g.own0 + warp * kRows);
  int own_i[kRows];
  float lse_r[kRows], del_r[kRows];
  float acc1[kRows][kVpt], acc2[kRows][kVpt];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    own_i[r] = g.own0 + warp * kRows + r;
    const bool ok = !kKv && g.own_valid(a, own_i[r]);
    lse_r[r] = ok ? a.lse[g.stat_idx(a, own_i[r], g.own_head)] : INFINITY;
    del_r[r] = ok ? a.delta[g.stat_idx(a, own_i[r], g.own_head)] : 0.f;
#pragma unroll
    for (int j = 0; j < kVpt; ++j) acc1[r][j] = acc2[r][j] = 0.f;
  }

  const int n_tiles = g.n_tiles(kF32Cols);
  for (int t = 0; t < n_tiles; ++t) {
    int hh, c0;
    g.tile(t, kF32Cols, hh, c0);
    __syncthreads();  // the previous tile is consumed (own rows written)
    for (int i = threadIdx.x; i < kF32Cols * DH; i += kThreads) {
      const int c = i / DH;
      const int d = i - c * DH;
      const bool ok = c0 + c < g.col_end;
      const long long off = ok ? g.col_off(a, c0 + c, hh, DH) + d : 0;
      xc[c * kStrideC + d] = ok ? col_x[off] : 0.f;
      yc[c * kStrideC + d] = ok ? col_y[off] : 0.f;
    }
    if (kKv) {
      for (int c = threadIdx.x; c < kF32Cols; c += kThreads) {
        const bool ok = c0 + c < g.col_end;
        const long long idx = ok ? g.stat_idx(a, c0 + c, hh) : 0;
        lse_s[c] = ok ? a.lse[idx] : INFINITY;
        del_s[c] = ok ? a.delta[idx] : 0.f;
      }
    }
    __syncthreads();
    if (!active) continue;

    // Lane j <-> column c0 + j: its logit and dP for the warp's rows.
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float4* xrow = reinterpret_cast<const float4*>(xc + lane * kStrideC);
    const float4* yrow = reinterpret_cast<const float4*>(yc + lane * kStrideC);
#pragma unroll 4
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 xx = xrow[d4];
      const float4 yy = yrow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 ox = reinterpret_cast<const float4*>(
            xo + (warp * kRows + r) * DH)[d4];
        const float4 oy = reinterpret_cast<const float4*>(
            yo + (warp * kRows + r) * DH)[d4];
        s[r] += ox.x * xx.x + ox.y * xx.y + ox.z * xx.z + ox.w * xx.w;
        dp[r] += oy.x * yy.x + oy.y * yy.y + oy.z * yy.z + oy.w * yy.w;
      }
    }
    const int ci = c0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float l = kKv ? lse_s[lane] : lse_r[r];
      const float dl = kKv ? del_s[lane] : del_r[r];
      const bool vis = ci < g.col_end && g.own_valid(a, own_i[r]) &&
                       g.visible(a, own_i[r], ci);
      const float pr = vis ? expf(s[r] * a.scale - l) : 0.f;
      s[r] = pr;
      dp[r] = pr * (dp[r] - dl);
    }
    // Accumulations: lane owns output columns lane + 32 j.
    const int n_cols = min(kF32Cols, g.col_end - c0);
    for (int tt = 0; tt < n_cols; ++tt) {
      float xv[kVpt], yv[kVpt];
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        xv[j] = xc[tt * kStrideC + lane + 32 * j];
        yv[j] = yc[tt * kStrideC + lane + 32 * j];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dst = __shfl_sync(0xffffffffu, dp[r], tt);
#pragma unroll
        for (int j = 0; j < kVpt; ++j) acc1[r][j] += dst * xv[j];
        if (kKv) {
          const float pt = __shfl_sync(0xffffffffu, s[r], tt);
#pragma unroll
          for (int j = 0; j < kVpt; ++j) acc2[r][j] += pt * yv[j];
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!g.own_valid(a, own_i[r])) continue;
    const long long off = g.own_off(a, own_i[r], DH);
#pragma unroll
    for (int j = 0; j < kVpt; ++j) {
      const int col = lane + 32 * j;
      if (kKv) {
        put1<float, kAcc>(a.dk, off + col, acc1[r][j] * a.scale);
        put1<float, kAcc>(a.dv, off + col, acc2[r][j]);
      } else {
        put1<float, kAcc>(a.dq, off + col, acc1[r][j] * a.scale);
      }
    }
  }
}

// ---- delta pre-pass and dispatch --------------------------------------------

constexpr int kDeltaWarps = 8;  // rows (warps) of one delta block

// delta[row] = sum_d dout[row, d] o[row, d] in f32; one warp per row.
template <typename T>
__device__ __forceinline__ void delta_row(const T* __restrict__ o,
                                          const T* __restrict__ dout,
                                          float* __restrict__ delta,
                                          long long rows, int dh) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kDeltaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < dh; d += 32)
    s += to_f32<T>(o[row * dh + d]) * to_f32<T>(dout[row * dh + d]);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

template <typename T>
struct Core;
template <>
struct Core<__nv_bfloat16> {
  static constexpr int kThreads = attn::kMmaThreads;
  template <int DH>
  static constexpr size_t smem() { return mma_smem_bytes<DH>(); }
  template <int DH, bool kKv, bool kAcc>
  static __device__ void run(const Args<__nv_bfloat16>& a) {
    mma_bwd<DH, kKv, kAcc>(a);
  }
};
template <>
struct Core<float> {
  static constexpr int kThreads = attn::kF32Threads;
  template <int DH>
  static constexpr size_t smem() { return f32_smem_bytes<DH>(); }
  template <int DH, bool kKv, bool kAcc>
  static __device__ void run(const Args<float>& a) {
    f32_bwd<DH, kKv, kAcc>(a);
  }
};

// Launches the delta pre-pass (with `fill_delta`; else `delta` already
// holds it) and the two passes on `stream`: kv_kernel over (B x KV, key
// tiles), q_kernel over (B x H, query tiles). `smem_set` holds each pass's
// per-device bits for attn::allow_smem. Returns the first launch error.
template <typename T, int DH, typename DeltaKernel, typename KvKernel,
          typename QKernel>
int launch_passes(DeltaKernel delta_kernel, KvKernel kv_kernel,
                  QKernel q_kernel, const Args<T>& a, const T* o,
                  float* delta, bool fill_delta, int batch,
                  std::atomic<unsigned long long> (&smem_set)[2],
                  cudaStream_t stream) {
  constexpr size_t smem = Core<T>::template smem<DH>();
  if (int e = attn::allow_smem(kv_kernel, smem, smem_set[0])) return e;
  if (int e = attn::allow_smem(q_kernel, smem, smem_set[1])) return e;
  if (fill_delta) {
    const long long rows = static_cast<long long>(batch) * a.sq * a.n_heads;
    const unsigned blocks =
        static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps);
    delta_kernel<<<blocks, kDeltaWarps * 32, 0, stream>>>(o, a.dout, delta,
                                                          rows, DH);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  const dim3 kv_grid(batch * a.n_kv_heads,
                     (a.sk + kTileRows - 1) / kTileRows);
  kv_kernel<<<kv_grid, Core<T>::kThreads, smem, stream>>>(a);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const dim3 q_grid(batch * a.n_heads, (a.sq + kTileRows - 1) / kTileRows);
  q_kernel<<<q_grid, Core<T>::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_bwd
}  // namespace brpc_tpu_torch

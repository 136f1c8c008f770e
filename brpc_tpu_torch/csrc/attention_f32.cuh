// The f32 attention cores on the H100's CUDA cores: the forward (`fwd`)
// that K5's f32 block fold (csrc/ring_attention.cu), K2's f32 prefill
// (csrc/prefill_attention.cu), K4's f32 suffix prefill
// (csrc/paged_prefill_attention.cu) and K1's f32 decode
// (csrc/paged_decode_attention.cu, in a layout of 16 rows) share, and the
// f32 passes of the attention backward that K2b
// (csrc/attention_backward.cu) and K5b (csrc/ring_attention_backward.cu)
// share (`bwd`). The f32 routes exist to hold the port to the reference in
// f32, so every product is a plain f32 FFMA: no tensor cores and no TF32.
//
// Bound on the card: operations, against the H100 SXM's 67 TFLOP/s of f32
// FFMA (data sheet, 700 W). What keeps a SIMT kernel from it is the shared
// memory traffic and the load instructions that feed each FFMA, so both
// cores are register-tiled, and the larger a thread's micro-tile the
// better (tools/torch_f32_sweep.py compares block shapes):
// - Natural layouts: every tile sits in shared memory as [row][Dh + 4] f32
//   (rows stay 16-byte aligned, and each row starts 4 banks on). Both
//   kinds of product contract along a contiguous axis: a logit-like
//   product (S = X.Y^T) takes float4s along Dh from its rows of X and of Y;
//   an accumulation (O += P.V) takes float4s of P along the keys and rows
//   of V along Dh. P (and dS) go through shared memory as [row][keys + 4].
// - Micro-tiles: 256 threads a block. The forward's block of 128 query
//   rows takes 64-key tiles: a thread computes 8 rows x 4 keys of S and
//   owns 8 rows x Dh / 16 columns of O. The backward's block owns 128 rows
//   and takes 32-row column tiles: a thread computes 4 x 4 of S and of dP
//   and owns 8 rows x Dh / 16 columns of each output. A thread's rows and
//   columns are spread by the thread grid (rows ty + 16 i, keys tx + 16 j,
//   output columns kVec tx + 16 kVec h + e), so the lanes of one load read
//   consecutive rows, which the padding puts in distinct banks.
// - Copies in flight: K/V (or column X/Y) tiles arrive with 16-byte
//   cp.async into two stages, tile t + 1 issued right after the barrier
//   that opens tile t. Where two stages do not fit in 227 KB (the forward
//   at Dh 128) V has one: V(t + 1) loads from the end of P.V(t) while
//   S(t + 1) and P(t + 1) are formed.
//
// Both follow the reference's rounding points: logits are the f32 dot
// times the scale, and probabilities expf of a natural-unit difference
// (logit - m, or logit - lse).
//
// The forward's threads of one row are the 16 lanes of one half-warp, so a
// row max takes 4 shuffles; each lane keeps its share of the row sum and
// the shares are added once, at the end. Its rows are numbered valid
// first, and a block computes only its slices of 16 rows that hold a valid
// row (`fwd_tiles`), so the padding of a short grid (K4 with one query,
// K2's last block) costs no FFMA. The backward needs no row reduction, so
// its warps take 4 rows x 8 columns of its grids, which halves the
// distinct rows each load touches.
#pragma once

#include <limits.h>

#include "attention_backward.cuh"

namespace brpc_tpu_torch {
namespace attn_f32 {

// The forward core: query rows of a block, keys of a tile, threads. The
// Python plans (ops/ring_attention.py's tile plan, ops/attention.py's f32
// split plan of K4) read these from this file.
constexpr int kF32FwdRows = 128;
constexpr int kF32FwdKeys = 64;
constexpr int kF32FwdThreads = 256;
// K1's f32 decode (csrc/paged_decode_attention.cu) runs the forward in a
// layout of kF32DecodeRows rows (up to that many of a lane's H / KV query
// heads), small enough that an SM holds kF32DecodeBlocks blocks; its
// splits are kF32DecodeSplitTiles key tiles. ops/attention.py's f32 decode
// plan reads all three; tools/torch_f32_sweep.py chose them.
constexpr int kF32DecodeRows = 16;
constexpr int kF32DecodeBlocks = 2;
constexpr int kF32DecodeSplitTiles = 2;
// The backward core: own rows of a block, rows of a column tile, threads
// (ops/attention.py reads these).
constexpr int kF32BwdOwnRows = 128;
constexpr int kF32BwdCols = 32;
constexpr int kF32BwdThreads = 256;
// A block's threads form a grid of (threads / kGrid) rows x kGrid columns:
// a thread's rows are ty + (threads / kGrid) i, its columns of S tx + kGrid
// j, its output columns kVec tx + kGrid kVec h + e.
constexpr int kGrid = 16;
static_assert(kF32FwdThreads % (2 * kGrid) == 0 &&
                  kF32FwdRows % (kF32FwdThreads / kGrid) == 0 &&
                  kF32FwdKeys % kGrid == 0,
              "forward thread grid");
// The backward's S and dP take another grid, (threads / 8) x 8.
static_assert(kF32BwdThreads % (4 * kGrid) == 0 &&
                  kF32BwdOwnRows % (kF32BwdThreads / kGrid) == 0 &&
                  kF32BwdOwnRows % (kF32BwdThreads / 8) == 0 &&
                  kF32BwdCols % 8 == 0 && kF32BwdCols % 4 == 0,
              "backward thread grids");
constexpr int kSmemPerBlock = 232448;  // what one block may use
constexpr int kSmemPerSm = 233472;     // what the blocks of an SM share
constexpr int kSmemReserved = 1024;    // the system's share of each block
// Unroll depths of the two inner loops: 4-column steps of a logit-like
// product, 4-key steps of an accumulation.
constexpr int kF32DotUnroll = 8;
constexpr int kF32AccUnroll = 4;

// 4-byte async copy (the LSE and delta of a column, strided by the heads);
// with pred false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   attn::smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// N (2 or 4) consecutive floats, 8- or 16-byte aligned.
template <int N>
__device__ __forceinline__ void ldv(float* r, const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else {
    static_assert(N == 2, "2 or 4 floats");
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x;
    r[1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void stv(float* p, const float* r) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
}

// A thread's share of an output row: Dh / 16 columns in vectors of kVec.
template <int DH>
struct Cols {
  static constexpr int kOc = DH / kGrid;
  static constexpr int kVec = kOc < 4 ? kOc : 4;
  static constexpr int kNv = kOc / kVec;
  static constexpr int kStride = DH + 4;  // floats per staged row
  // Column of vector h of thread column tx.
  static __device__ __forceinline__ int col(int tx, int h) {
    return kVec * tx + kGrid * kVec * h;
  }
};

// acc[i][.] += a[i] * b[.] for the thread's first kLive rows i, one key's
// row b of V (or of a column tile) in shared memory.
template <int DH, int kRm, int kLive = kRm>
__device__ __forceinline__ void accumulate_row(float (&acc)[kRm][DH / kGrid],
                                               const float (&a)[kRm],
                                               const float* brow, int tx) {
  using C = Cols<DH>;
  float b[C::kOc];
#pragma unroll
  for (int h = 0; h < C::kNv; ++h)
    ldv<C::kVec>(b + h * C::kVec, brow + C::col(tx, h));
#pragma unroll
  for (int i = 0; i < kLive; ++i)
#pragma unroll
    for (int c = 0; c < C::kOc; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
}

// acc += P.B over a tile of n (a multiple of 4) keys: P [rows][n] at
// `ps` (row stride ps_stride; the thread's rows ty + kStep i, the first
// kLive of them), B [n][Dh] at `bs`.
template <int DH, int kRm, int kStep, int kLive = kRm>
__device__ __forceinline__ void accumulate(float (&acc)[kRm][DH / kGrid],
                                           const float* ps, int ps_stride,
                                           const float* bs, int n, int ty,
                                           int tx) {
#pragma unroll kF32AccUnroll
  for (int t = 0; t < n; t += 4) {
    float4 p4[kRm];
#pragma unroll
    for (int i = 0; i < kLive; ++i)
      p4[i] = *reinterpret_cast<const float4*>(ps + (ty + kStep * i) *
                                                        ps_stride + t);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float a[kRm];
#pragma unroll
      for (int i = 0; i < kLive; ++i)
        a[i] = reinterpret_cast<const float*>(&p4[i])[u];
      accumulate_row<DH, kRm, kLive>(acc, a,
                                     bs + (t + u) * Cols<DH>::kStride, tx);
    }
  }
}

// s[i][j] += X[rows i] . Y[rows j] along Dh: rows ty + kStep i of `xs`
// (the first kLive of them) and tx + kColStep j of `ys` (both [.][Dh + 4]).
template <int DH, int kRm, int kCn, int kStep, int kColStep = kGrid,
          int kLive = kRm>
__device__ __forceinline__ void dots(float (&s)[kRm][kCn], const float* xs,
                                     const float* ys, int ty, int tx) {
  constexpr int kStride = Cols<DH>::kStride;
  // At most a quarter of the loop: fully unrolled at Dh 32, it hoisted
  // every load and spilled.
  constexpr int kUnroll = kF32DotUnroll < DH / 16 ? kF32DotUnroll : DH / 16;
#pragma unroll kUnroll
  for (int d = 0; d < DH; d += 4) {
    float4 x[kRm], y[kCn];
#pragma unroll
    for (int i = 0; i < kLive; ++i)
      x[i] = *reinterpret_cast<const float4*>(xs + (ty + kStep * i) *
                                                       kStride + d);
#pragma unroll
    for (int j = 0; j < kCn; ++j)
      y[j] = *reinterpret_cast<const float4*>(ys + (tx + kColStep * j) *
                                                       kStride + d);
#pragma unroll
    for (int i = 0; i < kLive; ++i)
#pragma unroll
      for (int j = 0; j < kCn; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
  }
}

// ---- the forward: a block of query rows over a range of keys ------------

// Shared memory of a block of kRows query rows, of which an SM holds
// kBlocks, in floats: Q, two K stages, two V stages (one where two do not
// fit: the next V tile then loads while S and P are formed), P, and the
// warps' causal edges.
template <int DH, int kRows_ = kF32FwdRows, int kBlocks = 1>
struct FwdSmem {
  static constexpr int kRows = kRows_;
  static constexpr int kBudget =
      kBlocks == 1 ? kSmemPerBlock : kSmemPerSm / kBlocks - kSmemReserved;
  static constexpr int kStride = Cols<DH>::kStride;
  static constexpr int kPStride = kF32FwdKeys + 4;
  static constexpr int kTile = kF32FwdKeys * kStride;
  static constexpr int kFixed = kRows * kStride + 2 * kTile +
                                kRows * kPStride + kF32FwdThreads / 32;
  static constexpr int kVStages =
      (kFixed + 2 * kTile) * 4 <= kBudget ? 2 : 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRows * kStride;
  static constexpr int kV = kK + 2 * kTile;
  static constexpr int kP = kV + kVStages * kTile;
  static constexpr int kEdge = kP + kRows * kPStride;
  static constexpr size_t kBytes =
      static_cast<size_t>(kEdge + kF32FwdThreads / 32) * sizeof(float);
  static_assert(kBytes <= static_cast<size_t>(kBudget),
                "the layout fits its share of an SM");
};

// Keys [k0, k0 + kF32FwdKeys) of `src` (p.k or p.v) into a staged tile,
// zeros past p.key_end.
template <int DH, typename Problem>
__device__ __forceinline__ void fwd_load(const Problem& p, float* dst,
                                         const float* src, int k0) {
  constexpr int kStride = Cols<DH>::kStride;
  constexpr int kChunks = DH / 4;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kF32FwdKeys * kChunks;
       c += kF32FwdThreads) {
    const int t = c / kChunks;
    const int ch = (c - t * kChunks) * 4;
    const int key = k0 + t;
    const bool ok = key < p.key_end;
    const long long off = ok ? p.kv_offset(key) : 0;
    attn::cp_async16(dst + t * kStride + ch, src + off + ch, ok);
  }
}

// The rows of a block in a thread's registers: for each of its rows
// ty + kGy i, the causal edge, the running max m, its share of the sum l
// (the whole of it once the 16 shares are added) and its columns of o.
// Slice i is row ty + kGy i of every thread, the block's rows kGy i ..
// kGy i + kGy - 1; rows are numbered valid first, so a slice is live or
// dead as a whole.
template <int DH, int kRows = kF32FwdRows>
struct FwdRows {
  static constexpr int kGy = kF32FwdThreads / kGrid;  // rows of the grid
  static constexpr int kRm = kRows / kGy;              // slices: rows a thread
  static_assert(kRows % kGy == 0 && (kRm & (kRm - 1)) == 0,
                "a power of two of slices");
  int edge[kRm];
  float m[kRm], l[kRm], o[kRm][Cols<DH>::kOc];
};

// Folds the key tiles [p.key_begin, p.key_end) into the first kLive slices
// of `r` with the reference's rule. A block takes the variant of the least
// power of two kLive at or above its `live` slices, so the products skip
// dead slices with no branch in their loops and every register index stays
// static; with every slice live it is the one full variant. Before the
// call the copy groups K(0), V(0) (and Q) are in flight.
template <int DH, typename L, int kLive, typename Problem>
__device__ __forceinline__ void fwd_tiles(const Problem& p,
                                          FwdRows<DH, L::kRows>& r,
                                          float* sm, float scale,
                                          int n_tiles, int emin, int live,
                                          int ty, int tx) {
  if constexpr (kLive > 1) {
    if (live <= kLive / 2) {
      fwd_tiles<DH, L, kLive / 2>(p, r, sm, scale, n_tiles, emin, live, ty,
                                  tx);
      return;
    }
  }
  constexpr int kGy = FwdRows<DH, L::kRows>::kGy;
  constexpr int kRm = FwdRows<DH, L::kRows>::kRm;
  constexpr int kKn = kF32FwdKeys / kGrid;  // keys of S a thread
  constexpr int kOc = Cols<DH>::kOc;
  const float* qs = sm + L::kQ;
  float* ks = sm + L::kK;
  float* vs = sm + L::kV;
  float* ps = sm + L::kP;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = p.key_begin + it * kF32FwdKeys;
    const bool more = it + 1 < n_tiles;
    // With two V stages tile it + 1 (K and V) loads while tile it
    // computes; with one, V(it + 1) loads from the end of P.V(it) until
    // P(it + 1) is formed.
    if (L::kVStages == 2)
      attn::cp_async_wait<0>();
    else
      attn::cp_async_wait<1>();  // K(it); V(it) may still be in flight
    __syncthreads();  // K(it) is in; tile it - 1 and P are consumed
    if (more) {
      const int nx = (it + 1) & 1;
      fwd_load<DH>(p, ks + nx * L::kTile, p.k, k0 + kF32FwdKeys);
      if (L::kVStages == 2)
        fwd_load<DH>(p, vs + nx * L::kTile, p.v, k0 + kF32FwdKeys);
      attn::cp_async_commit();
    }
    const float* kt = ks + (it & 1) * L::kTile;
    const float* vt = vs + (L::kVStages == 2 ? (it & 1) * L::kTile : 0);

    float s[kRm][kKn];
#pragma unroll
    for (int i = 0; i < kLive; ++i)
#pragma unroll
      for (int j = 0; j < kKn; ++j) s[i][j] = 0.f;
    dots<DH, kRm, kKn, kGy, kGrid, kLive>(s, qs, kt, ty, tx);

    // Scale, mask, and fold into the running max; p = exp(s - m_new).
    const bool masked = k0 + kF32FwdKeys > p.key_end ||
                        k0 + kF32FwdKeys - 1 > emin;
#pragma unroll
    for (int i = 0; i < kLive; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKn; ++j) {
        const int key = k0 + tx + kGrid * j;
        float v = s[i][j] * scale;
        if (masked && !(key < p.key_end && key <= r.edge[i])) v = -INFINITY;
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int off = kGrid / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(r.m[i], mx);
      // A row with no visible key yet keeps max -inf; subtracting 0 then
      // keeps exp(-inf) = 0 and never forms -inf - -inf.
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float alpha = expf(r.m[i] - mu);
      r.m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKn; ++j) {
        s[i][j] = expf(s[i][j] - mu);
        sum += s[i][j];
      }
      r.l[i] = r.l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kOc; ++c) r.o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < kKn; ++j)
        ps[(ty + kGy * i) * L::kPStride + tx + kGrid * j] = s[i][j];
    }
    if (L::kVStages == 1) {
      if (more)
        attn::cp_async_wait<1>();  // V(it); K(it + 1) may be in flight
      else
        attn::cp_async_wait<0>();
    }
    __syncthreads();  // P (and, with one V stage, V(it)) is in
    // Keys past p.key_end have p = 0 and zero rows of V, so P.V of a
    // partial last tile stops at the first multiple of 4 past its keys.
    const int n_keys = p.key_end - k0;
    if (n_keys >= kF32FwdKeys)
      accumulate<DH, kRm, kGy, kLive>(r.o, ps, L::kPStride, vt, kF32FwdKeys,
                                      ty, tx);
    else
      accumulate<DH, kRm, kGy, kLive>(r.o, ps, L::kPStride, vt,
                                      (n_keys + 3) & ~3, ty, tx);
    if (L::kVStages == 1 && more) {
      __syncthreads();  // V(it) is consumed
      fwd_load<DH>(p, vs, p.v, k0 + kF32FwdKeys);
      attn::cp_async_commit();
    }
  }
}

// One block of the layout FwdSmem<DH, kRows, kBlocks> computes its kRows
// query rows (row r is global row
// p.row_id(r), -1 past the end, valid rows first) over the keys
// [p.key_begin, p.key_end) with an online softmax in f32. Key j is visible
// to row r when j < p.key_end and j <= p.edge(r); only tiles that cross the
// block's lowest edge or the keys' end run the test.
// - Start: a folding problem (Problem::kFolds, K5) seeds each row from its
//   running state (o, m, l; natural units) in sink.o_part and
//   sink.ml_part, [row][Dh] and [row][2]; any other starts at m = -inf,
//   l = 0, o = 0 and reads no state.
// - End: with sink.partial the rows' unnormalised o and (m, l) go to row
//   sink.split * sink.n_rows + row of sink.o_part and sink.ml_part (a
//   folding problem's state: split 0; K4's split partials, which
//   attn::merge_row reads); otherwise the rows' o / l (l = 0 read as 1) go
//   to sink.out and, where sink.lse is set, their LSE to sink.lse.
// An empty key range writes its rows as they started (m = -inf, l = 0 for
// a problem that does not fold). Every copy group is drained on return;
// a caller that runs fwd again in the same block passes a __syncthreads
// first, since threads may still read the last tile.
template <int DH, int kRows = kF32FwdRows, int kBlocks = 1,
          typename Problem>
__device__ void fwd(const Problem& p, const float* __restrict__ q,
                    float scale, const attn::Sink<float>& sink) {
  using C = Cols<DH>;
  using L = FwdSmem<DH, kRows, kBlocks>;
  using R = FwdRows<DH, kRows>;
  constexpr int kStride = L::kStride;
  constexpr int kGy = R::kGy;
  constexpr int kRm = R::kRm;
  constexpr int kOc = C::kOc;
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  float* qs = sm + L::kQ;
  int* edge_s = reinterpret_cast<int*>(sm + L::kEdge);
  const int tx = threadIdx.x % kGrid;
  const int ty = threadIdx.x / kGrid;  // a row's 16 threads: one half-warp

  const int n_tiles =
      max(0, (p.key_end - p.key_begin + kF32FwdKeys - 1) / kF32FwdKeys);
  // The live slices, and the Q rows of the slices that fwd_tiles computes
  // (the least power of two of slices at or above `live`).
  int live = 0;
#pragma unroll
  for (int i = 0; i < kRm; ++i) live += p.row_id(kGy * i) >= 0;
  int q_rows = kGy;
  while (q_rows < live * kGy) q_rows *= 2;
  // Q and the first K tile, then the first V tile: two copy groups (none
  // without keys). Before tile it the groups in flight are K(it), V(it).
  if (n_tiles > 0) {
    constexpr int kChunks = DH / 4;
    for (int c = threadIdx.x; c < q_rows * kChunks; c += kF32FwdThreads) {
      const int row = c / kChunks;
      const int ch = (c - row * kChunks) * 4;
      const int rid = p.row_id(row);
      attn::cp_async16(qs + row * kStride + ch,
                       q + static_cast<long long>(rid < 0 ? 0 : rid) * DH +
                           ch,
                       rid >= 0);
    }
    fwd_load<DH>(p, sm + L::kK, p.k, p.key_begin);
    attn::cp_async_commit();
    fwd_load<DH>(p, sm + L::kV, p.v, p.key_begin);
    attn::cp_async_commit();
  }

  R r;
  int rid[kRm];
  int emin = INT_MAX;
#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int row = ty + kGy * i;
    rid[i] = p.row_id(row);
    r.edge[i] = p.edge(row);
    r.m[i] = -INFINITY;
    r.l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOc; ++c) r.o[i][c] = 0.f;
    if (rid[i] < 0) continue;
    emin = min(emin, r.edge[i]);
    if constexpr (Problem::kFolds) {
      const long long g = rid[i];
      r.m[i] = sink.ml_part[g * 2];
      if (tx == 0) r.l[i] = sink.ml_part[g * 2 + 1];
      const float* srow = sink.o_part + g * DH;
#pragma unroll
      for (int h = 0; h < C::kNv; ++h)
        ldv<C::kVec>(&r.o[i][h * C::kVec], srow + C::col(tx, h));
    }
  }
  // The block's lowest edge: a tile at or below it needs no causal test.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    emin = min(emin, __shfl_xor_sync(0xffffffffu, emin, off));
  if (threadIdx.x % 32 == 0) edge_s[threadIdx.x / 32] = emin;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kF32FwdThreads / 32; ++w) emin = min(emin, edge_s[w]);

  fwd_tiles<DH, L, kRm>(p, r, sm, scale, n_tiles, emin, live, ty, tx);

  // Each row's l from its 16 threads' shares, then the state or the rows.
#pragma unroll
  for (int i = 0; i < kRm; ++i)
#pragma unroll
    for (int off = kGrid / 2; off > 0; off >>= 1)
      r.l[i] += __shfl_xor_sync(0xffffffffu, r.l[i], off);
#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    if (rid[i] < 0) continue;
    const long long row = rid[i];
    if (sink.partial) {
      const long long prow =
          static_cast<long long>(sink.split) * sink.n_rows + row;
      float* srow = sink.o_part + prow * DH;
#pragma unroll
      for (int h = 0; h < C::kNv; ++h)
        stv<C::kVec>(srow + C::col(tx, h), &r.o[i][h * C::kVec]);
      if (tx == 0) {
        sink.ml_part[prow * 2] = r.m[i];
        sink.ml_part[prow * 2 + 1] = r.l[i];
      }
    } else {
      const float inv = 1.0f / (r.l[i] == 0.f ? 1.f : r.l[i]);
      if (tx == 0 && sink.lse != nullptr)
        sink.lse[row] = attn::row_lse(r.m[i], r.l[i]);
      float* orow = sink.out + row * DH;
#pragma unroll
      for (int h = 0; h < C::kNv; ++h) {
        float v[C::kVec];
#pragma unroll
        for (int e = 0; e < C::kVec; ++e)
          v[e] = r.o[i][h * C::kVec + e] * inv;
        stv<C::kVec>(orow + C::col(tx, h), v);
      }
    }
  }
}

// ---- the backward: one pass of csrc/attention_backward.cuh's two ----------

// Shared memory, in floats: the own X and Y tiles, two stages of column X
// and Y tiles with their LSE and delta rows, P and dS (one buffer for both
// where two do not fit: the dK/dV pass then takes dv += P.Y_col before it
// writes dS).
template <int DH>
struct BwdSmem {
  static constexpr int kStride = Cols<DH>::kStride;
  static constexpr int kPStride = kF32BwdCols + 4;
  static constexpr int kTileCols = kF32BwdCols * kStride;
  static constexpr int kPTile = kF32BwdOwnRows * kPStride;
  static constexpr int kXo = 0;
  static constexpr int kYo = kXo + kF32BwdOwnRows * kStride;
  static constexpr int kXc = kYo + kF32BwdOwnRows * kStride;
  static constexpr int kYc = kXc + 2 * kTileCols;
  static constexpr int kLse = kYc + 2 * kTileCols;
  static constexpr int kDelta = kLse + 2 * kF32BwdCols;
  static constexpr int kP = kDelta + 2 * kF32BwdCols;
  static constexpr bool kShared = (kP + 2 * kPTile) * 4 > kSmemPerBlock;
  static constexpr int kDs = kShared ? kP : kP + kPTile;
  static constexpr size_t kBytes =
      static_cast<size_t>(kDs + kPTile) * sizeof(float);
};

using attn_bwd::Args;
using attn_bwd::Geom;

// One block of a pass over the block's own rows (keys of one KV head in the
// dK/dV pass, queries of one head in the dQ pass) and the column tiles of
// its list (attn_bwd::Geom): S and dP as two 4 x 2 micro-tile products
// along Dh, P = exp(s scale - lse) (0 off the causal edge, tested only on
// tiles that cross it or the columns' end), dS = P (dP - delta) through
// shared memory, then acc1 += dS.X_col and, in the dK/dV pass, acc2 +=
// P.Y_col. The dQ pass walks key tiles only up to its last valid row's
// causal edge, so no tile of either pass is invisible to all its rows.
template <int DH, bool kKv, bool kAcc>
__device__ void bwd(const Args<float>& a) {
  using C = Cols<DH>;
  using L = BwdSmem<DH>;
  constexpr int kStride = L::kStride;
  constexpr int kOwn = kF32BwdOwnRows;
  // The accumulations' grid: kGy x kGrid, kRm own rows a thread; S and
  // dP's: kSy x 8, kSm own rows x kSn columns a thread.
  constexpr int kGy = kF32BwdThreads / kGrid;
  constexpr int kRm = kOwn / kGy;
  constexpr int kSy = kF32BwdThreads / 8;
  constexpr int kSm = kOwn / kSy;
  constexpr int kSn = kF32BwdCols / 8;
  constexpr int kOc = C::kOc;
  Geom<kKv, kOwn> g(a);
  const int own_n = kKv ? a.sk : a.sq;
  if (!kKv && a.causal)
    g.col_end = max(0, min(a.sk, a.diag + min(g.own0 + kOwn, a.sq)));
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  float* xo = sm + L::kXo;
  float* yo = sm + L::kYo;
  float* xc = sm + L::kXc;
  float* yc = sm + L::kYc;
  float* lse_s = sm + L::kLse;
  float* del_s = sm + L::kDelta;
  float* p_s = sm + L::kP;
  float* ds_s = sm + L::kDs;
  const float* own_x = kKv ? a.k : a.q;
  const float* own_y = kKv ? a.v : a.dout;
  const float* col_x = kKv ? a.q : a.k;
  const float* col_y = kKv ? a.dout : a.v;
  // A warp takes 4 rows x 8 columns of either grid.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ty = 4 * (warp % (kGy / 4)) + lane / 8;
  const int tx = 8 * (warp / (kGy / 4)) + lane % 8;
  const int sy = 4 * warp + lane / 8;
  const int sx = lane % 8;
  constexpr int kChunks = DH / 4;

  const int n_tiles = g.n_tiles(kF32BwdCols);
  for (int c = threadIdx.x; n_tiles > 0 && c < kOwn * kChunks;
       c += kF32BwdThreads) {
    const int r = c / kChunks;
    const int ch = (c - r * kChunks) * 4;
    const bool ok = g.own0 + r < own_n;
    const long long off = ok ? g.own_off(a, g.own0 + r, DH) : 0;
    attn::cp_async16(xo + r * kStride + ch, own_x + off + ch, ok);
    attn::cp_async16(yo + r * kStride + ch, own_y + off + ch, ok);
  }
  auto load_cols = [&](int t, int stage) {
    int hh, c0;
    g.tile(t, kF32BwdCols, hh, c0);
    float* xs = xc + stage * L::kTileCols;
    float* ys = yc + stage * L::kTileCols;
    for (int c = threadIdx.x; c < kF32BwdCols * kChunks;
         c += kF32BwdThreads) {
      const int r = c / kChunks;
      const int ch = (c - r * kChunks) * 4;
      const bool ok = c0 + r < g.col_end;
      const long long off = ok ? g.col_off(a, c0 + r, hh, DH) : 0;
      attn::cp_async16(xs + r * kStride + ch, col_x + off + ch, ok);
      attn::cp_async16(ys + r * kStride + ch, col_y + off + ch, ok);
    }
    if (kKv && threadIdx.x < kF32BwdCols) {
      const int r = threadIdx.x;
      const bool ok = c0 + r < g.col_end;
      const long long idx = ok ? g.stat_idx(a, c0 + r, hh) : 0;
      cp_async4(lse_s + stage * kF32BwdCols + r, a.lse + idx, ok);
      cp_async4(del_s + stage * kF32BwdCols + r, a.delta + idx, ok);
    }
  };
  // The own tiles and the first column tile: one copy group (none without
  // a column tile).
  if (n_tiles > 0) {
    load_cols(0, 0);
    attn::cp_async_commit();
  }

  // The dQ pass: the LSE and delta of this thread's own rows of S.
  float lse_r[kSm], del_r[kSm];
  float acc1[kRm][kOc];  // dk (dK/dV pass) or dq
  float acc2[kKv ? kRm : 1][kKv ? kOc : 1];  // dv
#pragma unroll
  for (int i = 0; i < kSm; ++i) {
    const int r = g.own0 + sy + kSy * i;
    const bool ok = !kKv && r < own_n;
    const long long idx = ok ? g.stat_idx(a, r, g.own_head) : 0;
    lse_r[i] = ok ? a.lse[idx] : INFINITY;
    del_r[i] = ok ? a.delta[idx] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRm; ++i)
#pragma unroll
    for (int c = 0; c < kOc; ++c) acc1[i][c] = 0.f;
#pragma unroll
  for (int i = 0; i < (kKv ? kRm : 1); ++i)
#pragma unroll
    for (int c = 0; c < (kKv ? kOc : 1); ++c) acc2[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    attn::cp_async_wait<0>();
    __syncthreads();  // tile t is in; tile t - 1, P and dS are consumed
    if (t + 1 < n_tiles) {
      load_cols(t + 1, stage ^ 1);
      attn::cp_async_commit();
    }
    int hh, c0;
    g.tile(t, kF32BwdCols, hh, c0);
    const float* xs = xc + stage * L::kTileCols;
    const float* ys = yc + stage * L::kTileCols;
    float s[kSm][kSn], dp[kSm][kSn];
#pragma unroll
    for (int i = 0; i < kSm; ++i)
#pragma unroll
      for (int j = 0; j < kSn; ++j) s[i][j] = dp[i][j] = 0.f;
    dots<DH, kSm, kSn, kSy, 8>(s, xo, xs, sy, sx);
    dots<DH, kSm, kSn, kSy, 8>(dp, yo, ys, sy, sx);

    // Does the tile cross the diagonal (for some own row of the block) or
    // the columns' end?
    const bool cross = a.causal && (kKv ? g.own0 + kOwn - 1 > a.diag + c0
                                        : c0 + kF32BwdCols - 1 >
                                              a.diag + g.own0);
    const bool masked = cross || c0 + kF32BwdCols > g.col_end;
#pragma unroll
    for (int i = 0; i < kSm; ++i) {
      const int r = g.own0 + sy + kSy * i;
#pragma unroll
      for (int j = 0; j < kSn; ++j) {
        const int cc = sx + 8 * j;
        const float lse =
            kKv ? lse_s[stage * kF32BwdCols + cc] : lse_r[i];
        const float dl = kKv ? del_s[stage * kF32BwdCols + cc] : del_r[i];
        float pr = expf(s[i][j] * a.scale - lse);
        if (masked && !(c0 + cc < g.col_end && g.visible(a, r, c0 + cc)))
          pr = 0.f;
        dp[i][j] = pr * (dp[i][j] - dl);  // dS
        if (kKv) p_s[(sy + kSy * i) * L::kPStride + cc] = pr;
        if (!(kKv && L::kShared))
          ds_s[(sy + kSy * i) * L::kPStride + cc] = dp[i][j];
      }
    }
    if constexpr (kKv && L::kShared) {
      __syncthreads();  // P is in
      accumulate<DH, kRm, kGy>(acc2, p_s, L::kPStride, ys, kF32BwdCols, ty,
                               tx);
      __syncthreads();  // P is consumed: dS takes its place
#pragma unroll
      for (int i = 0; i < kSm; ++i)
#pragma unroll
        for (int j = 0; j < kSn; ++j)
          ds_s[(sy + kSy * i) * L::kPStride + sx + 8 * j] = dp[i][j];
    }
    __syncthreads();  // dS (and P) are in
    accumulate<DH, kRm, kGy>(acc1, ds_s, L::kPStride, xs, kF32BwdCols, ty,
                             tx);
    if constexpr (kKv && !L::kShared)
      accumulate<DH, kRm, kGy>(acc2, p_s, L::kPStride, ys, kF32BwdCols, ty,
                               tx);
  }

#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int r = g.own0 + ty + kGy * i;
    if (r >= own_n) continue;
    const long long off = g.own_off(a, r, DH);
    float* out1 = static_cast<float*>(kKv ? a.dk : a.dq) + off;
#pragma unroll
    for (int h = 0; h < C::kNv; ++h) {
      const int col = C::col(tx, h);
      float v[C::kVec];
      if (kAcc) ldv<C::kVec>(v, out1 + col);
#pragma unroll
      for (int e = 0; e < C::kVec; ++e)
        v[e] = (kAcc ? v[e] : 0.f) + acc1[i][h * C::kVec + e] * a.scale;
      stv<C::kVec>(out1 + col, v);
      if constexpr (kKv) {
        float* out2 = static_cast<float*>(a.dv) + off;
        if (kAcc) ldv<C::kVec>(v, out2 + col);
#pragma unroll
        for (int e = 0; e < C::kVec; ++e)
          v[e] = (kAcc ? v[e] : 0.f) + acc2[i][h * C::kVec + e];
        stv<C::kVec>(out2 + col, v);
      }
    }
  }
}

}  // namespace attn_f32

namespace attn_bwd {

template <>
struct Core<float> {
  static constexpr int kThreads = attn_f32::kF32BwdThreads;
  static constexpr int kOwnRows = attn_f32::kF32BwdOwnRows;
  template <int DH>
  static constexpr size_t smem() { return attn_f32::BwdSmem<DH>::kBytes; }

  template <int DH, bool kKv, bool kAcc>
  static __device__ void run(const Args<float>& a, const Maps&) {
    attn_f32::bwd<DH, kKv, kAcc>(a);
  }
};

}  // namespace attn_bwd
}  // namespace brpc_tpu_torch

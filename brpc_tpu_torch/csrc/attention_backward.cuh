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
// - the dK/dV pass: one block per (batch, KV head, own keys) owns the
//   keys' dk and dv and walks the query tiles that can see them (causal:
//   from the first query at or past the block's first key), for each of
//   the KV head's query heads, early keys (the most queries) first;
// - the dQ pass: one block per (batch, head, own queries) owns their dq
//   and walks the key tiles up to its causal edge, heaviest blocks first.
// The same body serves both: a block's "own" rows (keys, or queries) stay
// in shared memory while "column" tiles of the other side stream past.
// Own X and Y are K and V (dK/dV pass) or Q and dO (dQ pass), column X and
// Y the other two: S = X_own . X_col^T, dP = Y_own . Y_col^T, then
// acc1 += dS . X_col (dk or dq) and acc2 += P . Y_col (dv).
//
// bf16 (`wgmma_bwd`, Hopper only; building blocks from csrc/hopper.cuh,
// which the forward core csrc/attention_forward.cuh shares): a block of 3
// warpgroups owns 128 rows. Warpgroup 0 is the producer (24 registers a
// thread, setmaxnreg): one warp loads the two own tiles once and then every
// column tile (X and Y, 64 rows each) with TMA into a ring of kBwdStages
// stages in shared memory, 128-byte swizzled (64-byte at Dh 32). A stage's
// "full" mbarrier counts the TMA bytes and the warp's 32 arrivals (in the
// dK/dV pass the warp also writes the tile's LSE, pre-scaled by log2 e, and
// delta rows); its "empty" one an arrival from each consumer warp.
// Warpgroups 1 and 2 are the consumers (240 registers: dk and dv are 2 x Dh
// / 2 f32 a thread at Dh 128, S and dP 32 each), 64 own rows each. Per
// column tile, four wgmma groups run in turn: S and dP (m64n64k16, both
// operands K-major in shared memory), then P = exp2(S scale log2e - lse
// log2e) is formed while dP runs, dv += P . Y_col runs while dS = P (dP -
// delta) is formed, and dk (or dq) += dS . X_col ends the tile. P (as the
// forward rounds it before P.V) and dS are rounded to bf16 straight into the
// A fragments of those register-sourced products (a 16-bit accumulator
// fragment repacks into the A layout without a shuffle); their B is the same
// stage read as an MN-major tile. Once the last group retires the warp
// releases the stage, so the producer's next copies overlap the products.
// The causal test runs only on tiles that cross the diagonal; a warpgroup
// skips a tile its rows see nothing of, and the block's tile list holds none
// that both skip.
// f32: the SIMT core of csrc/attention_f32.cuh (`attn_f32::bwd`, plain FFMA
// on the CUDA cores), 128 own rows a block and 32-row column tiles through
// two cp.async stages, on the same geometry.
//
// Outputs: a kernel writes its rows either rounded to T (K2b: dq, dk, dv in
// the model dtype) or added to f32 accumulators (K5b: a ring block's
// contributions, `kAcc`).
#pragma once

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace brpc_tpu_torch {
namespace attn_bwd {

// The bf16 core (ops/attention.py reads these from this file).
constexpr int kBwdWgRows = 64;     // own rows of one consumer warpgroup
constexpr int kBwdConsumers = 2;   // consumer warpgroups of a block
constexpr int kBwdOwnRows = 128;   // own rows of a block
constexpr int kBwdCols = 64;       // rows of a column tile
constexpr int kBwdStages = 3;      // column tiles in flight
constexpr int kBwdThreads = 384;   // the producer warpgroup and consumers
constexpr int kBwdProducerRegs = 24;
constexpr int kBwdConsumerRegs = 240;
static_assert(kBwdOwnRows == kBwdConsumers * kBwdWgRows, "own rows");
static_assert(kBwdThreads == 128 * (kBwdConsumers + 1), "warpgroups");
static_assert(kBwdProducerRegs + kBwdConsumers * kBwdConsumerRegs <=
                  65536 / 128,
              "setmaxnreg budget");
static_assert(kBwdWgRows == hopper::kBoxRows && kBwdCols == hopper::kBoxRows,
              "own and column tiles are TMA boxes");

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

// The bf16 core's TMA maps of q, k, v and dout (unused by the f32 core).
struct Maps {
  CUtensorMap q, k, v, dout;
};

// Which rows a block of kOwn own rows owns and which column tiles it walks.
// kKv: own rows are keys j of KV head `own_head`, columns the queries of
// its `rep` query heads; else own rows are queries of head `own_head`,
// columns the keys of its KV head.
template <bool kKv, int kOwn>
struct Geom {
  int b, own_head, col_head0, n_col_heads, own0, col_begin, col_end;

  template <typename T>
  __device__ explicit Geom(const Args<T>& a) {
    const int rep = a.n_heads / a.n_kv_heads;
    if (kKv) {
      b = blockIdx.x / a.n_kv_heads;
      own_head = blockIdx.x - b * a.n_kv_heads;
      own0 = blockIdx.y * kOwn;  // early keys see the most queries
      col_head0 = own_head * rep;
      n_col_heads = rep;
      col_begin = a.causal ? max(0, own0 - a.diag) : 0;
      col_end = a.sq;
    } else {
      b = blockIdx.x / a.n_heads;
      own_head = blockIdx.x - b * a.n_heads;
      own0 = (gridDim.y - 1 - blockIdx.y) * kOwn;  // heaviest first
      col_head0 = own_head / rep;
      n_col_heads = 1;
      col_begin = 0;
      col_end = a.causal ? max(0, min(a.sk, a.diag + own0 + kOwn)) : a.sk;
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

// ---- bf16 on Hopper: wgmma fed by TMA ---------------------------------------

using namespace hopper;

// Byte offsets in a block's shared memory (aligned to 1024, the swizzle's
// period): the consumers' own X and Y tiles, each stage's column X and Y
// tiles, each stage's LSE (times log2 e) and delta rows, the barriers.
template <int DH>
struct Smem {
  static constexpr int kTile = Tile<DH>::kBytes;
  static constexpr int kOwnX = 0;
  static constexpr int kOwnY = kOwnX + kBwdConsumers * kTile;
  static constexpr int kColX = kOwnY + kBwdConsumers * kTile;
  static constexpr int kColY = kColX + kBwdStages * kTile;
  static constexpr int kLse = kColY + kBwdStages * kTile;
  static constexpr int kDelta = kLse + kBwdStages * kBwdCols * 4;
  static constexpr int kFull = kDelta + kBwdStages * kBwdCols * 4;
  static constexpr int kEmpty = kFull + kBwdStages * 8;
  static constexpr int kOwnBar = kEmpty + kBwdStages * 8;
  static constexpr size_t kAlloc = kOwnBar + 8 + 1024;  // + base alignment
};

// The producer warp: the own tiles once, then every column tile of the
// block's list into the stage ring, with its LSE and delta rows in the
// dK/dV pass (+inf and 0 past the last query, so those columns get P = 0).
template <int DH, bool kKv>
__device__ __forceinline__ void bwd_produce(
    const Args<__nv_bfloat16>& a, const Maps& maps,
    const Geom<kKv, kBwdOwnRows>& g, uint32_t base, float* lse_s,
    float* del_s) {
  using L = Tile<DH>;
  using S = Smem<DH>;
  const int lane = threadIdx.x;
  const CUtensorMap* own_x = kKv ? &maps.k : &maps.q;
  const CUtensorMap* own_y = kKv ? &maps.v : &maps.dout;
  const CUtensorMap* col_x = kKv ? &maps.q : &maps.k;
  const CUtensorMap* col_y = kKv ? &maps.dout : &maps.v;
  if (lane == 0) {
    mbar_expect_tx(base + S::kOwnBar, 2 * kBwdConsumers * L::kBytes);
    mbar_arrive(base + S::kOwnBar);
    for (int w = 0; w < kBwdConsumers; ++w)
      for (int r = 0; r < L::kRegions; ++r) {
        const uint32_t off = w * L::kBytes + r * L::kRegionBytes;
        const int row = g.own0 + w * kBwdWgRows;
        tma_load(base + S::kOwnX + off, own_x, base + S::kOwnBar,
                 r * L::kSw, g.own_head, row, g.b);
        tma_load(base + S::kOwnY + off, own_y, base + S::kOwnBar,
                 r * L::kSw, g.own_head, row, g.b);
      }
  }
  const int n_tiles = g.n_tiles(kBwdCols);
  int stage = 0, phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    int hh, c0;
    g.tile(t, kBwdCols, hh, c0);
    const uint32_t full = base + S::kFull + 8 * stage;
    mbar_wait(base + S::kEmpty + 8 * stage, phase ^ 1);
    if (lane == 0) {
      mbar_expect_tx(full, 2 * L::kBytes);
      for (int r = 0; r < L::kRegions; ++r) {
        const uint32_t off = stage * L::kBytes + r * L::kRegionBytes;
        tma_load(base + S::kColX + off, col_x, full, r * L::kSw, hh, c0,
                 g.b);
        tma_load(base + S::kColY + off, col_y, full, r * L::kSw, hh, c0,
                 g.b);
      }
    }
    if (kKv) {
      // Every load in flight at once, while the copies run.
      float l[kBwdCols / 32], d[kBwdCols / 32];
#pragma unroll
      for (int k = 0; k < kBwdCols / 32; ++k) {
        const int c = c0 + lane + 32 * k;
        const bool ok = c < g.col_end;
        const long long idx = ok ? g.stat_idx(a, c, hh) : 0;
        l[k] = ok ? __ldg(a.lse + idx) * attn::kLog2e : INFINITY;
        d[k] = ok ? __ldg(a.delta + idx) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBwdCols / 32; ++k) {
        lse_s[stage * kBwdCols + lane + 32 * k] = l[k];
        del_s[stage * kBwdCols + lane + 32 * k] = d[k];
      }
    }
    mbar_arrive(full);
    if (++stage == kBwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// A consumer warpgroup: 64 own rows against every column tile of the
// block's list (waiting and releasing each stage even where it skips the
// tile), then its rows of the outputs.
template <int DH, bool kKv, bool kAcc>
__device__ __forceinline__ void bwd_consume(const Args<__nv_bfloat16>& a,
                                            const Geom<kKv, kBwdOwnRows>& g,
                                            uint32_t base,
                                            const float* lse_s,
                                            const float* del_s) {
  using L = Tile<DH>;
  using S = Smem<DH>;
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int own_n = kKv ? a.sk : a.sq;
  const int own_lo = g.own0 + wg * kBwdWgRows;
  const bool live = own_lo < own_n;
  // This thread's accumulator rows: row0 and row0 + 8 (the wgmma layout).
  const int row0 = own_lo + warp * 16 + lane / 4;
  const float scale2 = a.scale * attn::kLog2e;
  float lse_r[2], del_r[2];  // the dQ pass: the rows' LSE x log2 e, delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = !kKv && row0 + 8 * h < own_n;
    const long long idx = ok ? g.stat_idx(a, row0 + 8 * h, g.own_head) : 0;
    lse_r[h] = ok ? a.lse[idx] * attn::kLog2e : INFINITY;
    del_r[h] = ok ? a.delta[idx] : 0.f;
  }
  float acc1[DH / 2];  // dk (kv) or dq
  float acc2[DH / 2];  // dv (kv only)
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc1[i] = acc2[i] = 0.f;
  const uint32_t own_x = base + S::kOwnX + wg * L::kBytes;
  const uint32_t own_y = base + S::kOwnY + wg * L::kBytes;
  mbar_wait(base + S::kOwnBar, 0);

  const int n_tiles = g.n_tiles(kBwdCols);
  int stage = 0, phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    int hh, c0;
    g.tile(t, kBwdCols, hh, c0);
    mbar_wait(base + S::kFull + 8 * stage, phase);
    // Any visible element in this warpgroup's rows x the tile, and does
    // the tile cross the diagonal (the causal test needed at all)?
    const int c_last = min(c0 + kBwdCols, g.col_end) - 1;
    bool any, cross;
    if (kKv) {
      any = !a.causal || own_lo <= a.diag + c_last;
      cross = a.causal && own_lo + kBwdWgRows - 1 > a.diag + c0;
    } else {
      any = !a.causal ||
            c0 <= a.diag + min(own_lo + kBwdWgRows, own_n) - 1;
      cross = a.causal && c0 + kBwdCols - 1 > a.diag + own_lo;
    }
    if (live && any) {
      const uint32_t col_x = base + S::kColX + stage * L::kBytes;
      const uint32_t col_y = base + S::kColY + stage * L::kBytes;
      // Four groups in flight in turn: S, then dP while P is formed, then
      // dv += P . Y_col while dS is formed, then dk (or dq) += dS . X_col.
      float s[kBwdCols / 2], dp[kBwdCols / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_n64(s, L::kmajor(own_x, kk), L::kmajor(col_x, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_n64(dp, L::kmajor(own_y, kk), L::kmajor(col_y, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      // s[4j + e]: row row0 + 8 (e / 2), column 8j + 2 (lane % 4) + e % 2;
      // P overwrites S in f32 (dS needs it) and, rounded, fills pa.
      const float* ls = lse_s + stage * kBwdCols;
      const float* ds = del_s + stage * kBwdCols;
#pragma unroll
      for (int j = 0; j < kBwdCols / 8; ++j) {
        const int cc = 8 * j + 2 * (lane % 4);
        const float2 l2 = kKv ? *reinterpret_cast<const float2*>(ls + cc)
                              : make_float2(lse_r[0], lse_r[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // The LSE of the element's column (dK/dV) or row (dQ).
          const float l = kKv ? (e % 2 ? l2.y : l2.x) : (e / 2 ? l2.y : l2.x);
          float p = exp2f(fmaf(s[4 * j + e], scale2, -l));
          if (cross) {
            const int i = row0 + 8 * (e / 2);
            const int c = c0 + cc + e % 2;
            if (kKv ? i > a.diag + c : c > a.diag + i) p = 0.f;
          }
          s[4 * j + e] = p;
        }
      }
      // Columns 16 kk .. 16 kk + 15 of P and dS as wgmma A fragments.
      uint32_t pa[kBwdCols / 16][4], da[kBwdCols / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBwdCols / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = attn::pack_bf16(s[8 * kk + 2 * r],
                                      s[8 * kk + 2 * r + 1]);
      if constexpr (kKv) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwdCols / 16; ++kk)
          wgmma_rs<DH>(acc2, pa[kk], L::mnmajor(col_y, kk));
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < kBwdCols / 8; ++j) {
        const int cc = 8 * j + 2 * (lane % 4);
        const float2 d2 = kKv ? *reinterpret_cast<const float2*>(ds + cc)
                              : make_float2(del_r[0], del_r[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dl = kKv ? (e % 2 ? d2.y : d2.x) : (e / 2 ? d2.y : d2.x);
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBwdCols / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = attn::pack_bf16(dp[8 * kk + 2 * r],
                                      dp[8 * kk + 2 * r + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdCols / 16; ++kk)
        wgmma_rs<DH>(acc1, da[kk], L::mnmajor(col_x, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc1);
      if constexpr (kKv) fence_regs(acc2);
      fence_regs(pa);
      fence_regs(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(base + S::kEmpty + 8 * stage);
    if (++stage == kBwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (!live) return;
  using bf16 = __nv_bfloat16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + 8 * h;
    if (i >= own_n) continue;
    const long long off = g.own_off(a, i, DH) + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      put2<bf16, kAcc>(kKv ? a.dk : a.dq, off + 8 * j,
                       acc1[4 * j + 2 * h] * a.scale,
                       acc1[4 * j + 2 * h + 1] * a.scale);
      if constexpr (kKv)
        put2<bf16, kAcc>(a.dv, off + 8 * j, acc2[4 * j + 2 * h],
                         acc2[4 * j + 2 * h + 1]);
    }
  }
}

template <int DH, bool kKv, bool kAcc>
__device__ void wgmma_bwd(const Args<__nv_bfloat16>& a, const Maps& maps) {
  using S = Smem<DH>;
  const Geom<kKv, kBwdOwnRows> g(a);
  extern __shared__ float4 smem_f4[];
  const uint32_t raw = attn::smem_addr(smem_f4);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_f4) + pad;
  const uint32_t base = raw + pad;
  float* lse_s = reinterpret_cast<float*>(sm + S::kLse);
  float* del_s = reinterpret_cast<float*>(sm + S::kDelta);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(base + S::kFull + 8 * s, 32);
      mbar_init(base + S::kEmpty + 8 * s, 4 * kBwdConsumers);
    }
    mbar_init(base + S::kOwnBar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kBwdProducerRegs>();
    if (threadIdx.x < 32) bwd_produce<DH, kKv>(a, maps, g, base, lse_s, del_s);
  } else {
    setmaxnreg_inc<kBwdConsumerRegs>();
    bwd_consume<DH, kKv, kAcc>(a, g, base, lse_s, del_s);
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

// The core of a dtype: bf16 here, f32 in csrc/attention_f32.cuh (which the
// kernels' sources include).
template <typename T>
struct Core;
template <>
struct Core<__nv_bfloat16> {
  static constexpr int kThreads = kBwdThreads;
  static constexpr int kOwnRows = kBwdOwnRows;
  template <int DH>
  static constexpr size_t smem() { return Smem<DH>::kAlloc; }
  template <int DH, bool kKv, bool kAcc>
  static __device__ void run(const Args<__nv_bfloat16>& a, const Maps& m) {
    wgmma_bwd<DH, kKv, kAcc>(a, m);
  }
};
template <int DH>
int encode_maps(Maps& m, const Args<__nv_bfloat16>& a, int batch) {
  if (int e = encode_rows<DH>(&m.q, a.q, batch, a.sq, a.n_heads)) return e;
  if (int e = encode_rows<DH>(&m.k, a.k, batch, a.sk, a.n_kv_heads))
    return e;
  if (int e = encode_rows<DH>(&m.v, a.v, batch, a.sk, a.n_kv_heads))
    return e;
  return encode_rows<DH>(&m.dout, a.dout, batch, a.sq, a.n_heads);
}

// Launches the delta pre-pass (with `fill_delta`; else `delta` already
// holds it) and the two passes on `stream`: kv_kernel over (B x KV, key
// tiles), q_kernel over (B x H, query tiles), both given the TMA maps in
// bf16. `smem_set` holds each pass's per-device bits for attn::allow_smem.
// Returns the first launch error.
template <typename T, int DH, typename DeltaKernel, typename KvKernel,
          typename QKernel>
int launch_passes(DeltaKernel delta_kernel, KvKernel kv_kernel,
                  QKernel q_kernel, const Args<T>& a, const T* o,
                  float* delta, bool fill_delta, int batch,
                  std::atomic<unsigned long long> (&smem_set)[2],
                  cudaStream_t stream) {
  constexpr size_t smem = Core<T>::template smem<DH>();
  constexpr int kOwn = Core<T>::kOwnRows;
  if (int e = attn::allow_smem(kv_kernel, smem, smem_set[0])) return e;
  if (int e = attn::allow_smem(q_kernel, smem, smem_set[1])) return e;
  Maps maps{};
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (int e = encode_maps<DH>(maps, a, batch)) return e;
  }
  if (fill_delta) {
    const long long rows = static_cast<long long>(batch) * a.sq * a.n_heads;
    const unsigned blocks =
        static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps);
    delta_kernel<<<blocks, kDeltaWarps * 32, 0, stream>>>(o, a.dout, delta,
                                                          rows, DH);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  const dim3 kv_grid(batch * a.n_kv_heads, (a.sk + kOwn - 1) / kOwn);
  kv_kernel<<<kv_grid, Core<T>::kThreads, smem, stream>>>(a, maps);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const dim3 q_grid(batch * a.n_heads, (a.sq + kOwn - 1) / kOwn);
  q_kernel<<<q_grid, Core<T>::kThreads, smem, stream>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_bwd
}  // namespace brpc_tpu_torch

// The bf16 attention forward core on Hopper (`wgmma` fed by TMA), K5's
// (csrc/ring_attention.cu): one block folds the keys of one K/V block into
// the running online-softmax state (o, m, l) of 128 query rows of one
// (batch, head), in place, or on the ring's last step writes the rows'
// o / l and their log-sum-exp.
//
// Key j is visible to query row i when j < n_keys and, causal, j <= diag +
// i (diag = q_start - k_start). Logits are scale q.k in f32 from the bf16
// operands; a row's state is folded by the reference's rule: the running
// max m, the rescale exp(m - m_new) of o and l, p = exp(logit - m_new) with
// m = -inf guarded (a row that saw no key keeps m = -inf, l = 0, o = 0),
// and p rounded to bf16 as the A operand of P.V (l sums it unrounded).
// Inside, the max runs in base 2 (logit log2 e, so one FFMA and one EX2 a
// probability); the state in device memory and the LSE are in natural
// units, as K5's f32 route, the plain fold and K5b (which recomputes P as
// exp(logit - lse)) read them.
//
// Block: kFwdThreads = 3 warpgroups. Warpgroup 0 is the producer
// (setmaxnreg down to kFwdProducerRegs): one thread loads the block's two
// Q tiles once, then every K and V tile of kFwdKeys keys with TMA into a
// ring of kFwdStages stages in shared memory (128-byte swizzled, 64-byte at
// Dh 32; csrc/hopper.cuh), each stage under a "full" mbarrier (the TMA
// bytes) and an "empty" one (an arrival from each consumer warp).
// Warpgroups 1 and 2 are the consumers (kFwdConsumerRegs), kFwdWgRows rows
// each. A consumer first seeds its registers with the rows' state (o, and
// m in base 2). Per K/V tile t it then
//   1. issues S = Q.K^T, wgmma m64nKk16 with both operands K-major in shared
//      memory (a thread holds rows r and r + 8, the quad's K / 4 columns),
//      together with O += P.V of tile t - 1 (wgmma m64nDHk16, P from
//      registers, V read MN-major from that tile's stage);
//   2. once S retires, while P.V runs: the mask, only on a tile that
//      crosses the diagonal or the keys' end; the row max over the quad
//      (two shuffles), the new max, and P = exp2(S scale log2e - m) summed
//      into the thread's share of l;
//   3. once P.V retires: releases tile t - 1's stage, rescales O's
//      registers, and rounds P to bf16 straight into the A fragments of the
//      next P.V (an accumulator fragment is the A layout).
// The two consumers take turns issuing their products (named barriers 1
// and 2), so one's softmax runs under the other's products, whenever they
// walk the same tiles. Under the mask a consumer skips the tiles its rows
// see nothing of (a suffix of the block's), and the block reads no tile
// past its last row's causal edge. Blocks run a few heads at a time (their
// K/V stay in L2), heaviest first. Rows past sq
// arrive as TMA zeros and are never written; keys past n_keys arrive as
// zeros and are masked. One writer per row and no atomics, so reruns are
// bit-identical.
#pragma once

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace brpc_tpu_torch {
namespace attn_fwd {

using namespace hopper;

// ops/ring_attention.py reads these from this file (the CPU model's tiles).
constexpr int kFwdWgRows = 64;     // query rows of one consumer warpgroup
constexpr int kFwdConsumers = 2;   // consumer warpgroups of a block
constexpr int kFwdRows = 128;      // query rows of a block
constexpr int kFwdKeys = 128;      // keys of a K/V tile
constexpr int kFwdStages = 3;      // K/V tiles in flight
constexpr int kFwdThreads = 384;   // the producer warpgroup and consumers
constexpr int kFwdProducerRegs = 24;
constexpr int kFwdConsumerRegs = 240;
static_assert(kFwdRows == kFwdConsumers * kFwdWgRows, "block rows");
static_assert(kFwdThreads == 128 * (kFwdConsumers + 1), "warpgroups");
static_assert(kFwdProducerRegs + kFwdConsumers * kFwdConsumerRegs <=
                  65536 / 128,
              "setmaxnreg budget");
static_assert(kFwdWgRows == kBoxRows && kFwdKeys % kBoxRows == 0 &&
                  (kFwdKeys == 64 || kFwdKeys == 128),
              "Q tiles are TMA boxes; S is m64n64 or m64n128");

// q: [B, sq, H, Dh]; k, v: [B, sk, H, Dh] bf16 (through the maps). The
// state: o [B, sq, H, Dh] and ml [B, sq, H, 2] (m, l) f32, natural units;
// out [B, sq, H, Dh] bf16 or null (keep the state); lse [B, sq, H] f32 or
// null, written with out.
struct Args {
  float* o;
  float* ml;
  __nv_bfloat16* out;
  float* lse;
  int batch, sq, sk, n_keys, n_heads, diag, causal;
  float scale;
};

struct Maps {
  CUtensorMap q, k, v;
};

// Byte offsets in a block's shared memory (aligned to 1024, the swizzle's
// period): the consumers' Q tiles, each stage's K and V tiles, barriers.
template <int DH>
struct Smem {
  static constexpr int kQTile = Tile<DH>::kBytes;
  static constexpr int kKvTile = Tile<DH, kFwdKeys>::kBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kFwdConsumers * kQTile;
  static constexpr int kV = kK + kFwdStages * kKvTile;
  static constexpr int kFull = kV + kFwdStages * kKvTile;
  static constexpr int kEmpty = kFull + kFwdStages * 8;
  static constexpr int kQBar = kEmpty + kFwdStages * 8;
  static constexpr size_t kAlloc = kQBar + 8 + 1024;  // + base alignment
};

// Heads whose blocks run side by side: the blocks in flight share a few
// heads' K/V in L2, and their state rows lie kFwdHeadGroup heads wide in
// memory ([B, s, H, D]: a row's heads are contiguous).
constexpr int kFwdHeadGroup = 4;

// A block's rows and key range. Blocks are numbered group by group of up to
// kFwdHeadGroup (batch, head)s, within a group by 128-row block, heaviest
// first (under the mask the last rows see the most keys), then by head;
// keys [0, key_end): n_keys, or up to the causal edge of its last valid
// row.
struct Geom {
  int b, head, q0, key_end;

  __device__ explicit Geom(const Args& a) {
    const int bh = a.batch * a.n_heads;
    const int n_qb = (a.sq + kFwdRows - 1) / kFwdRows;
    const int per_group = kFwdHeadGroup * n_qb;
    const int grp = blockIdx.x / per_group;
    const int rest = blockIdx.x - grp * per_group;
    const int width = min(kFwdHeadGroup, bh - grp * kFwdHeadGroup);
    const int qb = rest / width;
    const int x = grp * kFwdHeadGroup + (rest - qb * width);
    b = x / a.n_heads;
    head = x - b * a.n_heads;
    q0 = (n_qb - 1 - qb) * kFwdRows;
    key_end = a.causal ? max(0, min(a.n_keys,
                                    a.diag + min(q0 + kFwdRows, a.sq)))
                       : a.n_keys;
  }
  __device__ int n_tiles() const {
    return (key_end + kFwdKeys - 1) / kFwdKeys;
  }
};

// The producer thread: the Q tiles once, then each K/V tile of the block's
// range into the stage ring.
template <int DH>
__device__ __forceinline__ void fwd_produce(const Maps& maps, const Geom& g,
                                            uint32_t base) {
  using L = Tile<DH>;
  using KV = Tile<DH, kFwdKeys>;
  using S = Smem<DH>;
  mbar_expect_tx(base + S::kQBar, kFwdConsumers * L::kBytes);
  mbar_arrive(base + S::kQBar);
  for (int w = 0; w < kFwdConsumers; ++w)
    for (int r = 0; r < L::kRegions; ++r)
      tma_load(base + S::kQ + w * L::kBytes + r * L::kRegionBytes, &maps.q,
               base + S::kQBar, r * L::kSw, g.head, g.q0 + w * kFwdWgRows,
               g.b);
  const int n_tiles = g.n_tiles();
  int stage = 0, phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t full = base + S::kFull + 8 * stage;
    mbar_wait(base + S::kEmpty + 8 * stage, phase ^ 1);
    mbar_expect_tx(full, 2 * KV::kBytes);
    for (int r = 0; r < KV::kRegions; ++r)
      for (int x = 0; x < kFwdKeys / kBoxRows; ++x) {
        const uint32_t off =
            stage * KV::kBytes + r * KV::kRegionBytes + x * KV::kBoxBytes;
        const int row = t * kFwdKeys + x * kBoxRows;
        tma_load(base + S::kK + off, &maps.k, full, r * KV::kSw, g.head, row,
                 g.b);
        tma_load(base + S::kV + off, &maps.v, full, r * KV::kSw, g.head, row,
                 g.b);
      }
    mbar_arrive(full);
    if (++stage == kFwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// One S tile of a consumer (rows row0 and row0 + 8, the quad's columns
// from c0) folded into the rows' running max m2 (base 2) and this thread's
// share of l: the mask where `mask`, the row max over the quad, alpha =
// exp2(m2 - m2_new) for O's rescale, and P = exp2(S scale log2e - m2_new)
// in place of S.
__device__ __forceinline__ void fold_scores(float (&s)[kFwdKeys / 2],
                                            float (&m2)[2], float (&l)[2],
                                            float (&alpha)[2], const Args& a,
                                            int c0, int row0, int col,
                                            bool mask, float scale2) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < kFwdKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + 8 * j + col + e % 2;
        const int i = row0 + 8 * (e / 2);
        if (key >= a.n_keys || (a.causal && key > a.diag + i))
          s[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kFwdKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
  float mu[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m2[h], mx[h] * scale2);
    // A row with no visible key yet keeps max -inf; subtracting 0 then
    // keeps exp2(-inf) = 0 and never forms -inf - -inf.
    mu[h] = mn == -INFINITY ? 0.f : mn;
    alpha[h] = exp2f(m2[h] - mu[h]);
    m2[h] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kFwdKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[4 * j + e], scale2, -mu[e / 2]));
      s[4 * j + e] = p;
      sum[e / 2] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
}

// O rescaled by its rows' alpha, and P (keys 16 kk .. 16 kk + 15, rounded
// to bf16) packed as the A fragments of P.V.
template <int DH>
__device__ __forceinline__ void rescale_and_pack(
    float (&o)[DH / 2], const float (&alpha)[2],
    const float (&s)[kFwdKeys / 2], uint32_t (&pa)[kFwdKeys / 16][4]) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = attn::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// A consumer warpgroup: its 64 rows' state seeded into registers, every
// K/V tile of the block's range (waiting for and releasing each stage even
// where it skips the tile), then the state or the output written back.
// The tiles its rows see are a prefix of the block's; over them the
// products run one tile apart: S of tile t is issued with P.V of tile
// t - 1, and the softmax of tile t runs while P.V of t - 1 is in flight.
template <int DH>
__device__ __forceinline__ void fwd_consume(const Args& a, const Geom& g,
                                            uint32_t base) {
  using L = Tile<DH>;
  using KV = Tile<DH, kFwdKeys>;
  using S = Smem<DH>;
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int own_lo = g.q0 + wg * kFwdWgRows;
  const int own_last = min(own_lo + kFwdWgRows, a.sq) - 1;
  const bool live = own_lo < a.sq;
  // This thread's rows: row0 and row0 + 8 (the wgmma accumulator layout:
  // element 4 j + e is row row0 + 8 (e / 2), column 8 j + 2 (lane % 4) +
  // e % 2).
  const int row0 = own_lo + warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const float scale2 = a.scale * attn::kLog2e;
  bool ok[2];
  long long rid[2];
  float o[DH / 2], m2[2], l[2];  // m in base 2; l: this thread's share
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + 8 * h;
    ok[h] = i < a.sq;
    rid[h] = (static_cast<long long>(g.b) * a.sq + i) * a.n_heads + g.head;
    m2[h] = ok[h] ? a.ml[rid[h] * 2] * attn::kLog2e : -INFINITY;
    l[h] = ok[h] && lane % 4 == 0 ? a.ml[rid[h] * 2 + 1] : 0.f;
    const float* orow = a.o + rid[h] * DH + col;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float2 v = ok[h] ? *reinterpret_cast<const float2*>(orow + 8 * j)
                             : make_float2(0.f, 0.f);
      o[4 * j + 2 * h] = v.x;
      o[4 * j + 2 * h + 1] = v.y;
    }
  }
  const uint32_t q_tile = base + S::kQ + wg * L::kBytes;
  mbar_wait(base + S::kQBar, 0);

  const int n_tiles = g.n_tiles();
  // The block's tiles that rows [lo, lo + 64) see: under the mask, those up
  // to their last row's edge (a prefix).
  auto tiles_seen = [&](int lo) {
    if (lo >= a.sq) return 0;
    if (!a.causal) return n_tiles;
    const int edge = a.diag + min(lo + kFwdWgRows, a.sq) - 1;
    return edge < 0 ? 0 : min(n_tiles, edge / kFwdKeys + 1);
  };
  const int n_mine = tiles_seen(own_lo);
  // The consumers take turns when they walk the same tiles (the same
  // count of turns each); else each walks its own tiles alone.
  const bool turns = tiles_seen(g.q0) == tiles_seen(g.q0 + kFwdWgRows);
  auto slot = [](int t) { return t % kFwdStages; };
  auto wait_full = [&](int t) {
    mbar_wait(base + S::kFull + 8 * slot(t), (t / kFwdStages) & 1);
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(base + S::kEmpty + 8 * slot(t));
  };
  // Turns: consumer w issues its products after named barrier 1 + w and
  // then hands the turn to the other, so one's softmax runs under the
  // other's products. Consumer 0 goes first.
  auto my_turn = [&] {
    if (turns) named_sync(1 + wg, 2 * 128);
  };
  auto their_turn = [&] {
    if (turns) named_arrive(2 - wg, 2 * 128);
  };
  // Does tile t need the mask (it crosses the diagonal or the keys' end)?
  auto masked = [&](int t) {
    const int c0 = t * kFwdKeys;
    return c0 + kFwdKeys > a.n_keys ||
           (a.causal && c0 + kFwdKeys - 1 > a.diag + own_lo);
  };
  float s[kFwdKeys / 2], alpha[2];
  uint32_t pa[kFwdKeys / 16][4];
  auto issue_s = [&](int t) {
    const uint32_t k_tile = base + S::kK + slot(t) * KV::kBytes;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss<kFwdKeys>(s, L::kmajor(q_tile, kk), KV::kmajor(k_tile, kk),
                         kk);
    wgmma_commit();
  };
  auto issue_pv = [&](int t) {
    const uint32_t v_tile = base + S::kV + slot(t) * KV::kBytes;
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk)
      wgmma_rs<DH>(o, pa[kk], KV::mnmajor(v_tile, kk));
    wgmma_commit();
  };
  if (n_mine > 0) {
    if (wg == 1) their_turn();  // consumer 0 goes first
    wait_full(0);
    my_turn();
    wgmma_fence();
    issue_s(0);
    their_turn();
    wgmma_wait<0>();
    fence_regs(s);
    fold_scores(s, m2, l, alpha, a, 0, row0, col, masked(0), scale2);
    rescale_and_pack<DH>(o, alpha, s, pa);
    for (int t = 1; t < n_mine; ++t) {
      wait_full(t);
      my_turn();
      wgmma_fence();
      issue_s(t);
      issue_pv(t - 1);
      their_turn();
      wgmma_wait<1>();
      fence_regs(s);
      fold_scores(s, m2, l, alpha, a, t * kFwdKeys, row0, col, masked(t),
                  scale2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(t - 1);
      rescale_and_pack<DH>(o, alpha, s, pa);
    }
    my_turn();
    wgmma_fence();
    issue_pv(n_mine - 1);
    their_turn();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(n_mine - 1);
    // Consumer 1's last hand-over still waits on barrier 1.
    if (wg == 0) my_turn();
  }
  for (int t = n_mine; t < n_tiles; ++t) {
    wait_full(t);
    release(t);
  }

  if (!live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!ok[h]) continue;
    const float m = m2[h] * (1.0f / attn::kLog2e);  // natural units
    if (a.out == nullptr) {
      float* orow = a.o + rid[h] * DH + col;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      if (lane % 4 == 0) {
        a.ml[rid[h] * 2] = m;
        a.ml[rid[h] * 2 + 1] = l[h];
      }
    } else {
      const float inv = 1.0f / (l[h] == 0.f ? 1.f : l[h]);
      if (a.lse != nullptr && lane % 4 == 0)
        a.lse[rid[h]] = attn::row_lse(m, l[h]);
      __nv_bfloat16* orow = a.out + rid[h] * DH + col;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                  o[4 * j + 2 * h + 1] * inv);
    }
  }
}

template <int DH>
__device__ void wgmma_fwd(const Args& a, const Maps& maps) {
  using S = Smem<DH>;
  const Geom g(a);
  extern __shared__ float4 smem_f4[];
  const uint32_t raw = attn::smem_addr(smem_f4);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(base + S::kFull + 8 * s, 1);
      mbar_init(base + S::kEmpty + 8 * s, 4 * kFwdConsumers);
    }
    mbar_init(base + S::kQBar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kFwdProducerRegs>();
    if (threadIdx.x == 0) fwd_produce<DH>(maps, g, base);
  } else {
    setmaxnreg_inc<kFwdConsumerRegs>();
    fwd_consume<DH>(a, g, base);
  }
}

// The TMA maps of q [batch, sq, heads, DH] and k, v [batch, sk, heads, DH].
template <int DH>
int encode_maps(Maps& m, const void* q, const void* k, const void* v,
                int batch, int sq, int sk, int heads) {
  if (int e = encode_rows<DH>(&m.q, q, batch, sq, heads)) return e;
  if (int e = encode_rows<DH>(&m.k, k, batch, sk, heads)) return e;
  return encode_rows<DH>(&m.v, v, batch, sk, heads);
}

}  // namespace attn_fwd
}  // namespace brpc_tpu_torch

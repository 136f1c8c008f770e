// Hopper building blocks shared by the bf16 attention cores on wgmma fed
// by TMA: the forward (csrc/attention_forward.cuh, K5) and the backward
// (csrc/attention_backward.cuh, K2b and K5b). A tile is rows of one head
// of a [batch, rows, heads, DH] bf16 array, copied by TMA (boxes of
// kBoxRows rows) into
// shared memory with its 16-byte chunks swizzled; the wgmma descriptors
// below read it K-major (its rows a product's M or N) or MN-major (its rows
// the product's K). Barriers are mbarriers in shared memory; the register
// split between a producer warpgroup and its consumers is setmaxnreg's.
// Hopper only (sm_90a).
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace brpc_tpu_torch {
namespace hopper {

constexpr int kBoxRows = 64;  // rows of a TMA box and of a wgmma M tile

// A tile of kRows rows (a multiple of kBoxRows) of a [B, S, heads, DH]
// bf16 array as TMA lays it out in shared memory: DH / kSw regions of kRows
// rows x kSw columns, each row kSw x 2 bytes with its 16-byte chunks
// swizzled (128-byte swizzle for DH >= 64, 64-byte at DH 32), the layout
// the wgmma descriptors below name. A region takes kRows / kBoxRows boxes,
// one after the other.
template <int DH, int kRows = kBoxRows>
struct Tile {
  static constexpr int kSw = DH < 64 ? DH : 64;
  static constexpr int kRowBytes = kSw * 2;
  static constexpr int kRegionBytes = kRows * kRowBytes;
  static constexpr int kBytes = kRows * DH * 2;
  static constexpr int kRegions = DH / kSw;
  static constexpr int kBoxBytes = kBoxRows * kRowBytes;
  static_assert(kRows % kBoxRows == 0, "a tile is whole boxes");

  // Shared-memory matrix descriptor: start address, leading and stride
  // byte offsets (16-byte units), swizzle mode (1: 128 bytes, 2: 64).
  static __device__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                  uint32_t sbo) {
    constexpr uint64_t kMode = kSw == 64 ? 1 : 2;
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>(lbo >> 4) << 16 |
           static_cast<uint64_t>(sbo >> 4) << 32 | kMode << 62;
  }
  // The tile as a K-major operand (its rows the operand's M or N, its
  // columns K), k step kk: columns 16 kk .. 16 kk + 15. 8-row groups are
  // 8 rows apart; the swizzle is applied on the address, so a step inside
  // a region only moves the start.
  static __device__ uint64_t kmajor(uint32_t tile, int kk) {
    return desc(tile + (kk * 16 / kSw) * kRegionBytes + (kk * 16 % kSw) * 2,
                16, 8 * kRowBytes);
  }
  // The tile as an MN-major operand (its rows K, its columns N), k step
  // kk: rows 16 kk .. 16 kk + 15; N crosses regions at the leading offset.
  static __device__ uint64_t mnmajor(uint32_t tile, int kk) {
    return desc(tile + kk * 16 * kRowBytes, kRegionBytes, 8 * kRowBytes);
  }
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Adds `bytes` to the transaction count that TMA loads complete.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D map (coordinates innermost first) into shared memory,
// completing on `bar`; rows out of the array's bounds arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Named barrier `id` (1..15; 0 is __syncthreads) of `threads` threads:
// sync waits for the count, arrive adds to it without waiting.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of a wgmma's registers above the
// wait that retires it, or reusing its A registers before then.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64) = A . B^T, or += with `accumulate`: A 64 x 16 and B 64 x 16,
// both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) = A . B^T, or += with `accumulate`: A 64 x 16 and B 128 x
// 16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, accumulate);
  else
    wgmma_ss_n128(d, da, db, accumulate);
}

// d (64 x 32) += A . B: A 64 x 16 in registers, B 16 x 32 MN-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15 "
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A . B: A 64 x 16 in registers, B 16 x 64 MN-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A . B: A 64 x 16 in registers, B 16 x 128 MN-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 32)
    wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// cuTensorMapEncodeTiled, a driver call, reached through the runtime so
// that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [batch, rows, heads, DH] bf16 as a 4-D map (DH, heads, rows, batch) whose
// box is 64 rows of one head by Tile<DH>::kSw columns.
template <int DH>
int encode_rows(CUtensorMap* map, const void* ptr, int batch, int rows,
                int heads) {
  using L = Tile<DH>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(DH) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * rows};
  const cuuint32_t box[4] = {L::kSw, 1, kBoxRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::kSw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
}  // namespace brpc_tpu_torch

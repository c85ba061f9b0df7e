// Tensor-core and asynchronous-copy building blocks for Hopper (sm_90a),
// written as inline PTX: the pieces swiglu_mlp.cu and flash_attention.cu
// build their bf16 kernels from.
//
//   cp_async16      one 16-byte copy global -> shared (cp.async.cg, L1
//                   bypassed), zero-filled instead when the predicate is false;
//                   cp_async_commit / cp_async_wait<N> close and await groups,
//                   so a ring of shared-memory stages fills while the tensor
//                   cores work on an earlier stage
//   ldmatrix_x4     four 8x8 b16 tiles from shared memory into the fragment
//                   layout of mma; ldmatrix_x4_trans transposes each tile on
//                   the way, for operands stored [K][N] (row-major weights, V)
//   mma_bf16_16816  D += A * B, mma.sync.aligned.m16n8k16.row.col.f32.bf16
//                   .bf16.f32: A 16x16 bf16, B 16x8 bf16, fp32 accumulators
//                   (flash_attention)
//   wgmma_m64n128k16_bt  one warpgroup's D += A * B on wgmma.mma_async, both
//   wgmma_m64n64k16_bt   operands read from 128-byte-swizzled shared memory
//                   through descriptors, 128 or 64 output columns (swiglu_mlp,
//                   the MoE kernels of moe_tc_sm90.cuh; see the section below)
//
// Fragment layouts (lane = 4 * g + t; PTX ISA, "Matrix fragments for
// mma.m16n8k16"): A regs {a0..a3} hold (row g, k 2t..2t+1), (row g+8, k
// 2t..), (row g, k 8+2t..), (row g+8, k 8+2t..); B regs {b0, b1} hold (k
// 2t..2t+1, n g), (k 8+2t.., n g); C/D {c0..c3} hold (row g, n 2t), (row g,
// n 2t+1), (row g+8, n 2t), (row g+8, n 2t+1).
//
// Each D element is (A row) . (B column) added to its own accumulator: rows of
// A never mix, so a row's result does not depend on what the other rows of
// its tile hold. The kernels build their row invariance on that.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst (both 16-byte aligned); with pred false the 16
// bytes of dst are zero-filled and src is not read (it must still be a valid
// address: pass the tensor's base).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are still pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Lanes 8i..8i+7 give the row addresses of tile i (16 bytes each); r[i] is
// tile i's fragment: lane holds row lane / 4, columns 2 (lane % 4) .. +1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// As ldmatrix_x4, each tile transposed: lane holds rows 2 (lane % 4) .. +1
// of column lane / 4 of the stored tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 and packed, lo in the low half (the
// element of the lower column / k index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lane offsets of the x4 loads of one 16x16 operand tile at (r0, c0) of a
// row-major shared array:
//   A (rows = M, columns = K), ldmatrix_x4: tiles (r, c), (r+8, c),
//     (r, c+8), (r+8, c+8) -> a0..a3
__device__ __forceinline__ int a_row(int lane) { return lane % 16; }
__device__ __forceinline__ int a_col(int lane) { return (lane / 16) * 8; }
//   B stored [N][K] (rows = N), ldmatrix_x4: tiles (n, k), (n, k+8),
//     (n+8, k), (n+8, k+8) -> {b0, b1} of n-tile 0, {b0, b1} of n-tile 1
__device__ __forceinline__ int bnk_row(int lane) {
  return lane % 8 + (lane / 16) * 8;
}
__device__ __forceinline__ int bnk_col(int lane) { return ((lane / 8) % 2) * 8; }
//   B stored [K][N] (rows = K), ldmatrix_x4_trans: tiles (k, n), (k+8, n),
//     (k, n+8), (k+8, n+8) -> {b0, b1} of n-tile 0, {b0, b1} of n-tile 1
__device__ __forceinline__ int bkn_row(int lane) {
  return lane % 8 + ((lane / 8) % 2) * 8;
}
__device__ __forceinline__ int bkn_col(int lane) { return (lane / 16) * 8; }

// ---- warpgroup MMA (wgmma) over 128-byte-swizzled shared-memory tiles ----
//
// A tile of rows of 64 bf16 values (128 bytes) is stored with its 16-byte
// chunk c of row r at chunk c ^ (r % 8) (CuTe's Swizzle<3,4,3>; the tile's
// base 1024-byte aligned). K-major operand (x, h: [rows][k]): rows of 128
// bytes one after another, 8-row groups 1024 bytes apart. MN-major operand
// (a weight tile [k][n], n contiguous): 64-column blocks of [64 k][128 B],
// 8 KB apart (LBO), 8-k groups 1024 bytes apart (SBO).

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// Generic-proxy writes (cp.async included) made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A * B for one warpgroup: A 64 x 16 (K-major, descriptor a), B 16 x
// 128 stored [k][n] (MN-major, descriptor b, transposed), fp32 accumulate;
// acc == 0 overwrites d. d[4 j + e] holds row 16 (warp % 4) + lane / 4 + 8 (e
// / 2), column 8 j + 2 (lane % 4) + e % 2, as mma.m16n8's C fragment.
__device__ __forceinline__ void wgmma_m64n128k16_bt(float (&d)[64], uint64_t a,
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// As wgmma_m64n128k16_bt over 64 columns (one 64-column block of B):
// d[4 j + e] for j < 8.
__device__ __forceinline__ void wgmma_m64n64k16_bt(float (&d)[32], uint64_t a,
                                                  uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

}  // namespace tc

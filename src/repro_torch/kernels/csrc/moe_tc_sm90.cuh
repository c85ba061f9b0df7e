// The bf16 MoE SwiGLU on Hopper's tensor cores (sm_90a): the GEMM core and
// tiles shared by the tensor-core routes of grouped_swiglu.cu (admission /
// ragged) and gather_swiglu.cu (decode). It computes what moe_swiglu.cuh
// computes, under the same contract (the TPU kernels' and the plain
// version's):
//
//   up   : g, u = x_row . wg[e], x_row . wu[e] in fp32;
//          h = round_bf16(silu(g) * u)
//   down : y = round_bf16(h_row . wd[e]) in fp32, one rounding per pair row
//
// What bounds it on this card: bytes. At decode (T 8, k 8, E 128, d 2048,
// f 768) the 64 pairs hit about 49 experts, whose tables (9.44 MB each) are
// 0.138 ms at 3.35 TB/s; at admission (2048 rows, every expert hit) the 128
// experts' tables are 0.366 ms, while the 19.3 GFLOP take 0.02 ms at the bf16
// tensor peak. The design:
//   * a tile is up to kBM = 64 rows of ONE expert (one warpgroup: a decode
//     segment holds 1 to 8 rows, an admission segment about 16) and a column
//     tile of the outputs (g and u, then y). Its rows come from a list in
//     shared memory: consecutive rows of a segment (grouped) or the pairs of
//     one expert (gather), so each expert's tables stream once per column
//     tile however many rows share them. The column tile is the grid's
//     fastest axis, so the blocks that run together read whole rows of one
//     expert's tables rather than a 128-byte piece of each of many;
//   * x's (h's) rows and the expert's weight tiles stream through a ring of
//     kStages shared-memory stages of kBK reduction values (16-byte cp.async
//     into 128-byte-swizzled tiles, tc_sm90.cuh) while the warpgroup runs
//     wgmma.m64nNk16 (bf16 in, fp32 accumulate; N = kUpBN up, kDownBN
//     down) on an earlier stage: x / h
//     K-major, the [d, f] / [f, d] tables row-major, so MN-major;
//   * the up epilogue computes silu(g) * u in fp32 and rounds h to bf16 in
//     device memory (h is a tiny share of the bytes); the down pass runs over
//     the whole of f in one block (no slices: at decode d / kDownBN column
//     tiles of 49 experts already make 784 blocks).
// Invariance by construction: a row's bits depend on (d, f) alone. Every
// caller runs the same wgmma shape over the same k-tiles in ascending order
// with the same column tile, and rows of a wgmma never mix. Pad rows of a
// tile are zero-filled on load and never stored. So a pair's y is bitwise the
// same from gather and from grouped, and a row is the same alone, among 8,
// 64 or 2048 rows, and in a segment of 1 or of 100 (a second 64-row tile).
// The tile plan (kBM, kUpBN, kDownBN, kBK, kStages) is the wrapper's
// (kernels/moe_tc.py :: plan, a function of (d, f, SM count)); the entry
// points refuse any other (kBadPlan). On an H100 an up-pass column tile of
// 64 ran faster than one of 128 at decode and at admission (PERF.md §6).
// d and f must be multiples of 8 (one 16-byte copy holds 8 values); ragged
// tile edges are zero-filled on load and masked on store. fp32 stays on the
// CUDA-core kernels of moe_swiglu.cuh (on tensor cores it would be TF32).
#pragma once

#include "moe_swiglu.cuh"
#include "tc_sm90.cuh"

namespace moetc {

using tc::bf16;

constexpr int kBM = 64;       // rows of a tile: one warpgroup
constexpr int kUpBN = 64;     // g / u columns of an up-pass block (each table)
constexpr int kDownBN = 128;  // y columns of a down-pass block
constexpr int kBK = 64;       // reduction values of one ring stage
constexpr int kStages = 3;
constexpr int kThreads = 128;
// Blocks an SM (launch bounds: at most 170 registers a thread). Occupancy
// beats ring depth here: on an H100 three blocks of 3 stages ran faster than
// two of 4 and far faster than one of 6.
constexpr int kBlocksPerSm = 3;
constexpr int kATile = kBM * kBK;    // [64 rows][64 k] K-major: 8 KB
constexpr int kColBlock = kBK * 64;  // values of one 64-column block of B
constexpr int kBadPlan = -2;

template <int NMAT>
struct Tabs {
  const bf16* p[NMAT];
};

// A ring of kStages stages, each an A tile and NMAT [kBK][BN] weight tiles.
// Up at BN 64 (two tables) and down at BN 128 (one table): 24 KB a stage,
// 73 KB a block, three blocks an SM.
template <int BN, int NMAT>
struct Ring {
  static_assert(BN == 64 || BN == 128, "wgmma column tiles of 64 or 128");
  static constexpr int kBTile = kBK * BN;
  static constexpr int kStage = kATile + NMAT * kBTile;
  static constexpr size_t kSmem =
      (size_t)kStages * kStage * sizeof(bf16) + 1024;  // + base alignment
};

// The rows of one tile, in shared memory: n live rows; tile row r reads row
// a_row[r] of A (x or h) and writes row o_row[r] of the output.
struct Tile {
  const int* a_row;
  const int* o_row;
  int n;
};

// The dynamic shared memory rounded up to the 1024-byte alignment the
// 128-byte swizzle needs.
__device__ __forceinline__ bf16* aligned_smem(unsigned char* raw) {
  const uint32_t a = tc::smem_u32(raw);
  return reinterpret_cast<bf16*>(raw + (((a + 1023) & ~1023u) - a));
}

// One ring stage: the tile's rows x reduction [k0, k0 + kBK) of A (row
// length lda), and of each table reduction rows [k0, k0 + kBK) x columns
// [n0, n0 + BN) (row length N). Reduction indices >= k_end and columns >= N
// are zero-filled. So are the pad rows (>= t.n), on a stage's first load of
// a gemm only (its k-tiles 0 .. kStages - 1 fill the kStages stages once
// each): later loads leave them, still zero, alone.
template <int BN, int NMAT>
__device__ __forceinline__ void load_stage(bf16* st, const bf16* __restrict__ A,
                                           int lda, const Tile& t,
                                           const Tabs<NMAT>& B, int N, int n0,
                                           int k0, int k_end) {
  char* base = reinterpret_cast<char*>(st);
  const int a_rows = k0 < kStages * kBK ? kBM : t.n;
  for (int i = threadIdx.x; i < a_rows * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < t.n && k0 + c * 8 < k_end;
    tc::cp_async16(base + tc::sw128(r, c),
                   ok ? A + (size_t)t.a_row[r] * lda + k0 + c * 8 : A, ok);
  }
  constexpr int kChunks = BN / 8;  // 16-byte chunks of a weight-tile row
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat) {
    char* bt = base + (size_t)(kATile + mat * Ring<BN, NMAT>::kBTile) *
                          sizeof(bf16);
#pragma unroll 4
    for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = k0 + r < k_end && n0 + c * 8 < N;
      tc::cp_async16(bt + (c >> 3) * (kColBlock * 2) + tc::sw128(r, c & 7),
                     ok ? B.p[mat] + (size_t)(k0 + r) * N + n0 + c * 8
                        : B.p[mat],
                     ok);
    }
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_bt(float (&d)[BN / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (BN == 128)
    tc::wgmma_m64n128k16_bt(d, a, b, 1);
  else
    tc::wgmma_m64n64k16_bt(d, a, b, 1);
}

// acc[mat] = A[tile rows, 0:K] @ B[mat][0:K, n0 .. n0 + BN] for the block's
// one warpgroup, k-tiles of kBK in ascending order through the cp.async
// ring, four wgmma k16 steps a tile. Ends with every copy landed and the
// block synchronised, so the ring may be refilled by the next tile.
template <int BN, int NMAT>
__device__ __forceinline__ void gemm(float (&acc)[NMAT][BN / 2], bf16* smem,
                                     const bf16* A, int lda, const Tile& t,
                                     const Tabs<NMAT>& B, int N, int n0,
                                     int K) {
  using R = Ring<BN, NMAT>;
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mat][i] = 0.0f;
  const int n_k = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k)
      load_stage<BN, NMAT>(smem + s * R::kStage, A, lda, t, B, N, n0, s * kBK,
                           K);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    tc::cp_async_wait<kStages - 2>();  // stage kt has landed (own copies)
    tc::fence_async_smem();            // ... visible to wgmma
    __syncthreads();                   // ... everyone's; stage kt-1 is free
    const int nxt = kt + kStages - 1;
    if (nxt < n_k)
      load_stage<BN, NMAT>(smem + (nxt % kStages) * R::kStage, A, lda, t, B,
                           N, n0, nxt * kBK, K);
    tc::cp_async_commit();
    const bf16* st = smem + (kt % kStages) * R::kStage;
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) tc::fence_regs(acc[mat]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = tc::sw128_desc(st + kk * 16, 16, 1024);
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) {
        const uint64_t db = tc::sw128_desc(
            st + kATile + mat * R::kBTile + kk * 16 * 64, kColBlock * 2, 1024);
        wgmma_bt<BN>(acc[mat], da, db);
      }
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();  // before the stage is refilled
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) tc::fence_regs(acc[mat]);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
}

// Tile row and output column of this thread's accumulator pair (j, half):
// d[4 j + 2 half] and d[4 j + 2 half + 1] (tc_sm90.cuh, wgmma fragment).
__device__ __forceinline__ int acc_row(int half) {
  return (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 4 + 8 * half;
}
__device__ __forceinline__ int acc_col(int n0, int j) {
  return n0 + 8 * j + 2 * (threadIdx.x % 4);
}

// h[o_row[r]][n0 .. n0 + BN) = round_bf16(silu(g) * u) for the tile's rows,
// g / u over the expert's tables wg_e / wu_e ([d, f]).
template <int BN>
__device__ __forceinline__ void up_tile(bf16* smem, const bf16* x, int d,
                                        const Tile& t, const bf16* wg_e,
                                        const bf16* wu_e, bf16* h, int f,
                                        int n0) {
  float acc[2][BN / 2];
  gemm<BN, 2>(acc, smem, x, d, t, Tabs<2>{{wg_e, wu_e}}, f, n0, d);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = acc_col(n0, j);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = acc_row(half), e = 4 * j + 2 * half;
      if (r < t.n && col < f)
        *reinterpret_cast<uint32_t*>(h + (size_t)t.o_row[r] * f + col) =
            tc::pack_bf16(moe::silu_mul(acc[0][e], acc[1][e]),
                          moe::silu_mul(acc[0][e + 1], acc[1][e + 1]));
    }
  }
}

// y[o_row[r]][n0 .. n0 + BN) = round_bf16(h_row . wd_e[:, c]), the whole of
// f in one fp32 accumulator (wd_e: [f, d]).
template <int BN>
__device__ __forceinline__ void down_tile(bf16* smem, const bf16* h, int f,
                                          const Tile& t, const bf16* wd_e,
                                          bf16* y, int d, int n0) {
  float acc[1][BN / 2];
  gemm<BN, 1>(acc, smem, h, f, t, Tabs<1>{{wd_e}}, d, n0, f);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = acc_col(n0, j);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = acc_row(half), e = 4 * j + 2 * half;
      if (r < t.n && col < d)
        *reinterpret_cast<uint32_t*>(y + (size_t)t.o_row[r] * d + col) =
            tc::pack_bf16(acc[0][e], acc[0][e + 1]);
    }
  }
}

// The wrapper's tile plan against the compiled one, and the widths the
// route takes.
inline bool plan_ok(int m_tile, int up_n, int down_n, int k_tile, int stages,
                    int d, int f) {
  return m_tile == kBM && up_n == kUpBN && down_n == kDownBN &&
         k_tile == kBK && stages == kStages && d % 8 == 0 && f % 8 == 0 &&
         d > 0 && f > 0;
}

// Lets a kernel of BN-column tiles over NMAT tables use its ring.
template <int BN, int NMAT, typename K>
int allow_ring(K kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Ring<BN, NMAT>::kSmem);
}

}  // namespace moetc

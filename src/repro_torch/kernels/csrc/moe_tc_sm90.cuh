// The MoE SwiGLU on Hopper's tensor cores (sm_90a), bf16 activations: the
// GEMM core and tiles shared by the tensor-core routes of grouped_swiglu.cu /
// grouped_swiglu_q.cu (admission / ragged) and gather_swiglu.cu /
// gather_swiglu_q.cu (decode), over bf16 tables or int8 ones.
//
// bf16 tables: the contract of moe_swiglu.cuh, the TPU kernels' and the
// plain version's:
//
//   up   : g, u = x_row . wg[e], x_row . wu[e] in fp32;
//          h = round_bf16(silu(g) * u)
//   down : y = round_bf16(h_row . wd[e]) in fp32, one rounding per pair row
//
// int8 tables (q, with fp32 scales s per (expert, output column)). x is bf16
// and int8 -> bf16 is exact, so wgmma (bf16 x bf16 -> fp32) accumulates the
// products x . q, which fp32 holds exactly, and each column's scale is
// applied once, in the epilogue:
//
//   up   : g[c] = s_g[c] * sum_i x[i] q_g[i][c]  (u likewise);
//          h = silu(g) * u in fp32
//   down : h is split into hi = round_bf16(h) and lo = round_bf16(h - hi), so
//          |h - hi - lo| <= 2^-16 |h| (about 16 bits of h, 256 times below
//          the one bf16 rounding of y); each k-step runs two wgmma into one
//          accumulator, hi then lo, against the same widened wd tile;
//          y[c] = round_bf16(s_d[c] * acc), the one rounding to the model type
//
// The reference (repro/kernels/decode_moe.py :: _kernel_q, grouped_mlp.py ::
// _kernel_q) computes sum x (q s) with h in fp32; the two differ by fp32
// rounding order and h's 2^-16. Not taken: TF32 for the down pass (10 bits of
// h, half the bf16 rate); int8 wgmma (it would quantize x, another model);
// the down pass on CUDA cores (a third of the bytes at the old rate). fp32 x
// stays on the CUDA-core kernels of moe_swiglu.cuh either way (on tensor
// cores it would be TF32).
//
// What bounds it on this card: bytes. At decode (T 8, k 8, E 128, d 2048,
// f 768) the 64 pairs hit about 49 experts, whose bf16 tables (9.44 MB each)
// are 0.138 ms at 3.35 TB/s, int8 ones half that; at admission (2048 rows,
// every expert hit) the 128 experts' tables are 0.366 ms in bf16 and 0.186
// ms in int8, while the 19.3 GFLOP take 0.02 ms at the bf16 tensor peak. The
// design:
//   * a tile is up to kBM = 64 rows of ONE expert (one warpgroup: a decode
//     segment holds 1 to 8 rows, an admission segment about 16) and a column
//     tile of the outputs (g and u, then y). Its rows come from a list in
//     shared memory: consecutive rows of a segment (grouped) or the pairs of
//     one expert (gather), so each expert's tables stream once per column
//     tile however many rows share them. The column tile is the grid's
//     fastest axis, so the blocks that run together read whole rows of one
//     expert's tables rather than a 128-byte piece of each of many;
//   * x's (h's, or hi's and lo's) rows and the expert's weight tiles stream
//     through a ring of shared-memory stages of kBK reduction values
//     (kStages deep with bf16 tables, kStagesQ with int8 ones; 16-byte
//     cp.async; A tiles and bf16 weight tiles 128-byte-swizzled,
//     tc_sm90.cuh) while the warpgroup runs wgmma.m64nNk16 (bf16 in, fp32
//     accumulate; N = kUpBN up, kDownBN down) on an earlier stage: x / h
//     K-major, the [d, f] / [f, d] tables row-major, so MN-major. An int8
//     weight tile arrives as it is stored (16 values a copy, half a bf16
//     tile's bytes) and the warpgroup widens it into one bf16 staging tile
//     of the bf16 tiles' layout before its wgmma;
//   * the up epilogue computes silu(g) * u in fp32 and writes h rounded to
//     bf16 (bf16 tables) or as hi and lo (int8 tables) to device memory (h is
//     a tiny share of the bytes); the down pass runs over the whole of f in
//     one block (no slices: at decode d / kDownBN column tiles of 49 experts
//     already make 784 blocks).
// Invariance by construction: a row's bits depend on (d, f) alone. Every
// caller runs the same wgmma shape over the same k-tiles in ascending order
// with the same column tile, and rows of a wgmma never mix. Pad rows of a
// tile are zero-filled on load and never stored. So a pair's y is bitwise the
// same from gather and from grouped, and a row is the same alone, among 8,
// 64 or 2048 rows, and in a segment of 1 or of 100 (a second 64-row tile).
// The tile plan (kBM, kUpBN, kDownBN, kBK and kStages or kStagesQ) is the
// wrapper's (kernels/moe_tc.py :: plan / plan_q, functions of (d, f, SM
// count)); the entry points refuse any other (kBadPlan). On an H100 an
// up-pass column tile of 64 ran faster than one of 128 at decode and at
// admission (PERF.md §6).
// d and f must be multiples of 8 with bf16 tables (one 16-byte copy holds 8
// values) and of 16 with int8 ones (16 values a copy); ragged tile edges are
// zero-filled on load and masked on store.
#pragma once

#include "moe_swiglu.cuh"
#include "tc_sm90.cuh"

namespace moetc {

using tc::bf16;
using i8 = signed char;

constexpr int kBM = 64;       // rows of a tile: one warpgroup
constexpr int kUpBN = 64;     // g / u columns of an up-pass block (each table)
constexpr int kDownBN = 128;  // y columns of a down-pass block
constexpr int kBK = 64;       // reduction values of one ring stage
constexpr int kStages = 3;   // ring stages, bf16 tables
constexpr int kStagesQ = 2;  // ring stages, int8 tables
constexpr int kThreads = 128;
// Blocks an SM (launch bounds: at most 170 registers a thread). Occupancy
// beats ring depth here: on an H100 three blocks of 3 stages ran faster than
// two of 4 and far faster than one of 6 (bf16 tables); with int8 tables two
// stages (four up-pass and three down-pass blocks an SM) ran faster than
// three (three and two) at decode and at admission (PERF.md §6).
constexpr int kBlocksPerSm = 3;
constexpr int kATile = kBM * kBK;    // [64 rows][64 k] K-major: 8 KB
constexpr int kColBlock = kBK * 64;  // values of one 64-column block of B
constexpr int kBadPlan = -2;

// The A operands of a pass: x (up), h (bf16 down) or hi and lo (int8 down),
// all [rows, K] with one row list.
template <int NA>
struct Ops {
  const bf16* p[NA];
};

template <int NMAT, typename Wt>
struct Tabs {
  const Wt* p[NMAT];
};

// A ring of kDepth stages, each NA A tiles and NMAT [kBK][BN] weight tiles
// in Wt; int8 adds one staging area, NMAT bf16 tiles the stage's weights
// are widened into. bf16 (kStages deep): up at BN 64 (two tables) and down
// at BN 128 (one table), 24 KB a stage, 73 KB a block, three blocks an SM.
// int8 (kStagesQ deep): up 16 KB a stage + 16 KB of staging, 49 KB, four
// blocks an SM; down (hi and lo) 24 KB a stage + 16 KB, 65 KB, three. Every
// piece is a multiple of 1024 bytes, so every swizzled tile keeps the base's
// alignment.
template <int BN, int NMAT, typename Wt = bf16, int NA = 1>
struct Ring {
  static_assert(BN == 64 || BN == 128, "wgmma column tiles of 64 or 128");
  static constexpr bool kQuant = sizeof(Wt) == 1;
  static constexpr int kDepth = kQuant ? kStagesQ : kStages;
  static constexpr int kBTile = kBK * BN;  // values of one weight tile
  static constexpr int kABytes = NA * kATile * (int)sizeof(bf16);
  static constexpr int kStage = kABytes + NMAT * kBTile * (int)sizeof(Wt);
  static constexpr int kStaging = kQuant ? NMAT * kBTile * (int)sizeof(bf16)
                                         : 0;
  static constexpr size_t kSmem =
      (size_t)kDepth * kStage + kStaging + 1024;  // + base alignment
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
__device__ __forceinline__ char* aligned_smem(unsigned char* raw) {
  const uint32_t a = tc::smem_u32(raw);
  return reinterpret_cast<char*>(raw + (((a + 1023) & ~1023u) - a));
}

// Byte offset of 16-byte chunk c (8 columns) of k-row r in a bf16 [kBK][BN]
// weight tile: 64-column blocks of [64 k][128 B], 128-byte-swizzled.
__device__ __forceinline__ int b_off(int r, int c) {
  return (c >> 3) * (kColBlock * 2) + tc::sw128(r, c & 7);
}

// One ring stage: the tile's rows x reduction [k0, k0 + kBK) of each A
// operand (row length lda), and of each table reduction rows [k0, k0 + kBK)
// x columns [n0, n0 + BN) (row length N; bf16 tiles swizzled, int8 tiles as
// stored, [kBK][BN] bytes). Reduction indices >= k_end and columns >= N are
// zero-filled. So are the pad rows (>= t.n), on a stage's first load of a
// gemm only (its k-tiles 0 .. kDepth - 1 fill the kDepth stages once each):
// later loads leave them, still zero, alone.
template <int BN, int NMAT, typename Wt, int NA>
__device__ __forceinline__ void load_stage(char* st, const Ops<NA>& A, int lda,
                                           const Tile& t,
                                           const Tabs<NMAT, Wt>& B, int N,
                                           int n0, int k0, int k_end) {
  using R = Ring<BN, NMAT, Wt, NA>;
  const int a_rows = k0 < R::kDepth * kBK ? kBM : t.n;
  for (int i = threadIdx.x; i < a_rows * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < t.n && k0 + c * 8 < k_end;
#pragma unroll
    for (int a = 0; a < NA; ++a)
      tc::cp_async16(st + a * kATile * 2 + tc::sw128(r, c),
                     ok ? A.p[a] + (size_t)t.a_row[r] * lda + k0 + c * 8
                        : A.p[a],
                     ok);
  }
  constexpr int kVals = 16 / (int)sizeof(Wt);  // values of one 16-byte copy
  constexpr int kChunks = BN / kVals;          // copies of a weight-tile row
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat) {
    char* bt = st + R::kABytes + mat * R::kBTile * (int)sizeof(Wt);
#pragma unroll 4
    for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = k0 + r < k_end && n0 + c * kVals < N;
      tc::cp_async16(R::kQuant ? bt + r * BN + c * 16 : bt + b_off(r, c),
                     ok ? B.p[mat] + (size_t)(k0 + r) * N + n0 + c * kVals
                        : B.p[mat],
                     ok);
    }
  }
}

// Four int8 values (one 32-bit word) as two packed bf16 pairs, exactly:
// byte j biased to j ^ 0x80 is the low byte of the fp32 2^23 + 128 + q, and
// the subtraction leaves q, which bf16 holds (|q| <= 128).
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t b = w ^ 0x80808080u;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440u | j)) -
           8388736.0f;
  return make_uint2(tc::pack_bf16(v[0], v[1]), tc::pack_bf16(v[2], v[3]));
}

// The stage's NMAT int8 [kBK][BN] weight tiles (src) widened into bf16 tiles
// of load_stage's bf16 layout (dst), which wgmma_bt reads. A thread takes 16
// values of one k-row (one 16-byte load) and writes two 16-byte chunks; in a
// 128-column tile the upper half of a row's threads writes its odd chunk
// first, so the 8 threads of a store phase hit 8 distinct bank groups.
template <int BN, int NMAT>
__device__ __forceinline__ void widen_stage(const char* src, char* dst) {
  constexpr int kChunks = BN / 16;
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat) {
    const char* s = src + mat * kBK * BN;
    char* d = dst + mat * kBK * BN * 2;
#pragma unroll 2
    for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const uint4 q = *reinterpret_cast<const uint4*>(s + r * BN + c * 16);
      const uint2 w0 = widen4(q.x), w1 = widen4(q.y), w2 = widen4(q.z),
                  w3 = widen4(q.w);
      const uint4 lo = make_uint4(w0.x, w0.y, w1.x, w1.y);  // columns 0..7
      const uint4 hi = make_uint4(w2.x, w2.y, w3.x, w3.y);  // columns 8..15
      const int odd = (c >> 2) & 1;
      *reinterpret_cast<uint4*>(d + b_off(r, 2 * c + odd)) = odd ? hi : lo;
      *reinterpret_cast<uint4*>(d + b_off(r, 2 * c + 1 - odd)) = odd ? lo : hi;
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

// acc[mat] = sum over the NA A operands of A[tile rows, 0:K] @ B[mat][0:K,
// n0 .. n0 + BN] for the block's one warpgroup, k-tiles of kBK in ascending
// order through the cp.async ring, four k16 steps a tile, each running the A
// operands in order (hi then lo) into one accumulator. int8 tables are
// widened to bf16 in the staging tiles first. Ends with every copy landed and
// the block synchronised, so the ring may be refilled by the next tile.
template <int BN, int NMAT, typename Wt, int NA>
__device__ __forceinline__ void gemm(float (&acc)[NMAT][BN / 2], char* smem,
                                     const Ops<NA>& A, int lda, const Tile& t,
                                     const Tabs<NMAT, Wt>& B, int N, int n0,
                                     int K) {
  using R = Ring<BN, NMAT, Wt, NA>;
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mat][i] = 0.0f;
  const int n_k = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < R::kDepth - 1; ++s) {
    if (s < n_k)
      load_stage<BN, NMAT, Wt, NA>(smem + s * R::kStage, A, lda, t, B, N, n0,
                                   s * kBK, K);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    tc::cp_async_wait<R::kDepth - 2>();  // stage kt landed (own copies)
    tc::fence_async_smem();              // ... visible to wgmma
    __syncthreads();                     // ... everyone's; stage kt-1 free
    const int nxt = kt + R::kDepth - 1;
    if (nxt < n_k)
      load_stage<BN, NMAT, Wt, NA>(smem + (nxt % R::kDepth) * R::kStage, A,
                                   lda, t, B, N, n0, nxt * kBK, K);
    tc::cp_async_commit();
    const char* st = smem + (kt % R::kDepth) * R::kStage;
    const char* bt = st + R::kABytes;
    if constexpr (R::kQuant) {
      // the staging tiles' last reader, the previous k-step's wgmma, has
      // finished (waited for before the barrier above)
      char* staging = smem + R::kDepth * R::kStage;
      widen_stage<BN, NMAT>(bt, staging);
      tc::fence_async_smem();  // the widened tiles visible to wgmma
      __syncthreads();
      bt = staging;
    }
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) tc::fence_regs(acc[mat]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) {
        const uint64_t db = tc::sw128_desc(
            bt + (mat * R::kBTile + kk * 16 * 64) * 2, kColBlock * 2, 1024);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          wgmma_bt<BN>(acc[mat],
                       tc::sw128_desc(st + a * kATile * 2 + kk * 32, 16, 1024),
                       db);
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
__device__ __forceinline__ void up_tile(char* smem, const bf16* x, int d,
                                        const Tile& t, const bf16* wg_e,
                                        const bf16* wu_e, bf16* h, int f,
                                        int n0) {
  float acc[2][BN / 2];
  gemm<BN, 2, bf16, 1>(acc, smem, Ops<1>{{x}}, d, t,
                       Tabs<2, bf16>{{wg_e, wu_e}}, f, n0, d);
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
__device__ __forceinline__ void down_tile(char* smem, const bf16* h, int f,
                                          const Tile& t, const bf16* wd_e,
                                          bf16* y, int d, int n0) {
  float acc[1][BN / 2];
  gemm<BN, 1, bf16, 1>(acc, smem, Ops<1>{{h}}, f, t, Tabs<1, bf16>{{wd_e}}, d,
                       n0, f);
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

// ---- int8 tables ----

// The scale row s (fp32 [N]) of a column tile [n0, n0 + BN) into shared
// memory, zero past N; read once per block, before its first tile (whose
// gemm's first barrier makes it visible).
template <int BN>
__device__ __forceinline__ void load_scales(float (&sc)[BN], const float* s,
                                            int N, int n0) {
  for (int c = threadIdx.x; c < BN; c += kThreads)
    sc[c] = n0 + c < N ? s[n0 + c] : 0.0f;
}

// hi / lo[o_row[r]][n0 .. n0 + BN) = the split of h = silu(g) * u, g =
// sg * (x_row . qg_e) and u likewise, for the tile's rows (qg_e / qu_e: int8
// [d, f]; sc: the column tile's scales of wg, wu). The products and the
// fp32 subtraction are written with _rn intrinsics so that no fma contracts
// them.
template <int BN>
__device__ __forceinline__ void up_tile_q(char* smem, const bf16* x, int d,
                                          const Tile& t, const i8* qg_e,
                                          const i8* qu_e,
                                          const float (&sc)[2][BN], bf16* hi,
                                          bf16* lo, int f, int n0) {
  float acc[2][BN / 2];
  gemm<BN, 2, i8, 1>(acc, smem, Ops<1>{{x}}, d, t, Tabs<2, i8>{{qg_e, qu_e}},
                     f, n0, d);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = acc_col(n0, j);
    const int c = col - n0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = acc_row(half), e = 4 * j + 2 * half;
      if (r < t.n && col < f) {
        float h[2];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          h[q] = moe::silu_mul(__fmul_rn(acc[0][e + q], sc[0][c + q]),
                               __fmul_rn(acc[1][e + q], sc[1][c + q]));
        const __nv_bfloat162 hv = __floats2bfloat162_rn(h[0], h[1]);
        const size_t o = (size_t)t.o_row[r] * f + col;
        *reinterpret_cast<__nv_bfloat162*>(hi + o) = hv;
        *reinterpret_cast<uint32_t*>(lo + o) =
            tc::pack_bf16(__fsub_rn(h[0], __low2float(hv)),
                          __fsub_rn(h[1], __high2float(hv)));
      }
    }
  }
}

// y[o_row[r]][n0 .. n0 + BN) = round_bf16(sd * (hi_row . qd_e + lo_row .
// qd_e)), the whole of f in one fp32 accumulator, hi then lo at every k16
// step (qd_e: int8 [f, d]; sc: the column tile's scales of wd).
template <int BN>
__device__ __forceinline__ void down_tile_q(char* smem, const bf16* hi,
                                            const bf16* lo, int f,
                                            const Tile& t, const i8* qd_e,
                                            const float (&sc)[1][BN], bf16* y,
                                            int d, int n0) {
  float acc[1][BN / 2];
  gemm<BN, 1, i8, 2>(acc, smem, Ops<2>{{hi, lo}}, f, t, Tabs<1, i8>{{qd_e}},
                     d, n0, f);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = acc_col(n0, j);
    const int c = col - n0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = acc_row(half), e = 4 * j + 2 * half;
      if (r < t.n && col < d)
        *reinterpret_cast<uint32_t*>(y + (size_t)t.o_row[r] * d + col) =
            tc::pack_bf16(__fmul_rn(acc[0][e], sc[0][c]),
                          __fmul_rn(acc[0][e + 1], sc[0][c + 1]));
    }
  }
}

// ---- row lists ----

// Runs tile(n) over the pairs whose id, clipped to [0, E), is e, in ascending
// pair order, n <= kBM pairs at a time, their indices in list[0, n). The ids
// are walked kThreads at a time and the matches appended to list (room for
// kBM + kThreads); whenever kBM are held, or the walk has ended with some
// held, a tile runs and the rest move to the front. No pair: no tile.
template <typename F>
__device__ __forceinline__ void for_each_pair_tile(const int* __restrict__ idx,
                                                   int n_pairs, int E, int e,
                                                   int* list, int* warp_n,
                                                   F&& tile) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int held = 0;
  for (int base = 0; base < n_pairs; base += kThreads) {
    const int p = base + threadIdx.x;
    const bool hit = p < n_pairs && min(max(idx[p], 0), E - 1) == e;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int at = held, added = 0;
#pragma unroll
    for (int wi = 0; wi < kThreads / 32; ++wi) {
      at += wi < warp ? warp_n[wi] : 0;
      added += warp_n[wi];
    }
    if (hit) list[at + __popc(ballot & ((1u << lane) - 1u))] = p;
    held += added;
    __syncthreads();
    while (held >= kBM) {
      tile(kBM);
      const int rest = held - kBM;  // < kThreads
      const int v = threadIdx.x < rest ? list[kBM + threadIdx.x] : 0;
      __syncthreads();
      if (threadIdx.x < rest) list[threadIdx.x] = v;
      held = rest;
      __syncthreads();
    }
  }
  if (held > 0) tile(held);
}

// This block's rows: the segment tile SegmentLayout gives blockIdx.y, as a
// row list.
__device__ __forceinline__ moe::RowBlock segment_rows(const int* group_sizes,
                                                      int E, int T, int* rows) {
  const moe::RowBlock rb =
      moe::SegmentLayout{group_sizes, E, T, kBM}.block(blockIdx.y);
  if (threadIdx.x < kBM) rows[threadIdx.x] = rb.row0 + threadIdx.x;
  __syncthreads();
  return rb;
}

// Segment tiles of a grouped launch: every expert can end in one partial
// tile, so ceil(T / kBM) + min(E, T) bounds their number whatever the group
// sizes are.
inline int segment_tiles(int T, int E) {
  return moe::ceil_div(T, kBM) + (E < T ? E : T);
}

// The wrapper's tile plan against the compiled one, and the widths the
// route takes: bf16 tables kStages deep, d and f multiples of 8; int8 tables
// (quant) kStagesQ deep, multiples of 16.
inline bool plan_ok(int m_tile, int up_n, int down_n, int k_tile, int stages,
                    int d, int f, bool quant = false) {
  const int multiple = quant ? 16 : 8;
  return m_tile == kBM && up_n == kUpBN && down_n == kDownBN &&
         k_tile == kBK && stages == (quant ? kStagesQ : kStages) &&
         d % multiple == 0 && f % multiple == 0 && d > 0 && f > 0;
}

// Lets a kernel of BN-column tiles over NMAT tables use its ring.
template <int BN, int NMAT, typename Wt = bf16, int NA = 1, typename K>
int allow_ring(K kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Ring<BN, NMAT, Wt, NA>::kSmem);
}

}  // namespace moetc

// swiglu_mlp: the dense SwiGLU MLP y = (silu(x @ wg) * (x @ wu)) @ wd for
// Hopper (sm_90a). Replaces the TPU kernel src/repro/kernels/swiglu.py ::
// swiglu_mlp (_kernel). Its contract: g and u in fp32, h = round(silu(g) * u)
// in the model type, the down product accumulated in fp32, one rounding of the
// output. Two routes, chosen by the wrapper from the dtype (kernels/swiglu.py
// :: route), each with its own C entry point:
//
// bf16, tensor cores (namespace tcmlp, swiglu_mlp_tc_launch). What bounds it:
// at decode the weight stream (3 d f bf16 values read once; granite-8b 352 MB,
// 0.105 ms at 3.35 TB/s), at admission close to the same bytes and 90 GFLOP
// (T 256), 0.091 ms at the bf16 tensor peak. The design:
//   up    one block owns a 128-row x 128-column tile of BOTH g and u: x's
//         rows and the two weight tiles stream through a ring of 4 shared-
//         memory stages (16-byte cp.async into 128-byte-swizzled tiles, kBK
//         = 64 reduction values a stage) while two warpgroups, 64 rows each,
//         run wgmma.m64n128k16 (bf16 in, fp32 accumulate) on an earlier
//         stage: x K-major, the weights [d, f] row-major, so MN-major (the
//         instruction's transposed B). The epilogue computes silu(g) * u in
//         fp32 and rounds h to bf16. h goes to device memory: it is 0.07 % of
//         the bytes at decode and 2 % at T 256, not worth a fused pass. Wide
//         tiles matter at admission: every column tile reads all of x, every
//         row tile all of the weights, from L2.
//   down  d / 128 column tiles do not fill the card, so the reduction axis f
//         is cut into S slices (bounds multiples of kBK), each block writing
//         its fp32 partial to scratch [S, T, d]; reduce_tc sums the partials
//         in slice order and rounds once (S == 1: the block rounds itself). No
//         atomics on values.
// The up epilogue has one option, round_gu: the model's arithmetic
// (models/layers.py :: mlp_apply, as the reference's model and the port's
// CPU path compute it) rounds g and u to bf16 before the activation: gb =
// bf16(g), ub = bf16(u), s = bf16(silu(gb)), h = bf16(s * ub). silu takes
// moe::silu_mul's form, gb * (1 / (1 + exp(-gb))): on an H100 the precise
// divide gb / (1 + exp(-gb)) slowed the admission up pass (same registers,
// no spills) and gave the same bits on every input tried (PERF.md §6).
// Without the option, the TPU kernel's contract above.
// The fp32 route needs no such option: rounding to fp32 is the identity.
// The tile plan (128-column tiles, kBK, S and the slice bounds) is computed by
// the wrapper from (d, f, SM count) only and passed in; nothing of it reads T.
// A row's bits therefore depend on (d, f) and the card alone: the k-tiles run
// in the same order and slices for every T, always through the same wgmma
// shape, whose rows never mix; pad rows of a tile are zero-filled and never
// stored, and a warpgroup with no live row skips its products. A row alone ==
// among 8 == among 256, fused decode == stepwise, admission alone == in a
// group. d and f must be multiples of 8 (one 16-byte copy holds 8 values);
// ragged tile edges are zero-filled on load and masked on store.
//
// fp32, CUDA cores (namespace mlp, swiglu_mlp_launch): on tensor cores fp32
// would become TF32, so fp32 keeps the kernel pair below, one expert of
// moe_swiglu.cuh, bit for bit grouped_swiglu with one group. A thread owns W
// adjacent output columns of up to kRows rows and walks its reduction axis in
// index order with fmaf (moe::rows_dot_columns_acc): i < d for the gate and up
// products, j < f for the down product; h is rounded between the passes and
// the output once. The block's rows are staged in shared memory kChunk values
// of the reduction axis at a time (consecutive pieces of the same fmaf chain),
// so the shared memory a block needs does not grow with d or f.
#include "moe_swiglu.cuh"
#include "tc_sm90.cuh"

namespace mlp {

using moe::Num;

constexpr int kRows = 8;
constexpr int kChunk = 1024;
constexpr int kMaxThreads = moe::kThreads;

// rows[r][i] = src[row0 + r][i0 + i] as fp32 for i < n (zero for r >= nrows).
template <typename S>
__device__ __forceinline__ void stage(float* rows, const S* src, int row0,
                                      int nrows, int depth, int i0, int n) {
  for (int r = 0; r < kRows; ++r) {
    const bool live = r < nrows;
    const S* p = src + (size_t)(row0 + (live ? r : 0)) * depth + i0;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      rows[r * kChunk + i] = live ? Num<S>::to_f32(p[i]) : 0.0f;
  }
}

// h[row][c] = round_T(silu(x_row . wg[:, c]) * (x_row . wu[:, c]))
// grid: (ceil(n_rows / kRows), ceil(f / (blockDim.x * W)))
template <typename T, int W>
__global__ void __launch_bounds__(kMaxThreads)
up_kernel(const T* __restrict__ x, const T* __restrict__ wg,
          const T* __restrict__ wu, T* __restrict__ h, int n_rows, int d,
          int f) {
  __shared__ float rows[kRows * kChunk];
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, n_rows - row0);
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * W;
  const bool live = c < f;
  float acc[2][kRows][W];
  moe::zero_acc<kRows, W, 2>(acc);
  for (int i0 = 0; i0 < d; i0 += kChunk) {
    const int n = min(kChunk, d - i0);
    __syncthreads();
    stage(rows, x, row0, nrows, d, i0, n);
    __syncthreads();
    if (live)
      moe::rows_dot_columns_acc<T, kRows, W, 2>(
          rows, kChunk, n, wg + (size_t)i0 * f, wu + (size_t)i0 * f, nullptr,
          nullptr, f, c, acc);
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < nrows) {
#pragma unroll
      for (int q = 0; q < W; ++q)
        h[(size_t)(row0 + r) * f + c + q] =
            Num<T>::from_f32(moe::silu_mul(acc[0][r][q], acc[1][r][q]));
    }
  }
}

// y[row][c] = round_T(h_row . wd[:, c])
// grid: (ceil(n_rows / kRows), ceil(d / (blockDim.x * W)))
template <typename T, int W>
__global__ void __launch_bounds__(kMaxThreads)
down_kernel(const T* __restrict__ h, const T* __restrict__ wd,
            T* __restrict__ y, int n_rows, int d, int f) {
  __shared__ float rows[kRows * kChunk];
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, n_rows - row0);
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * W;
  const bool live = c < d;
  float acc[1][kRows][W];
  moe::zero_acc<kRows, W, 1>(acc);
  for (int j0 = 0; j0 < f; j0 += kChunk) {
    const int n = min(kChunk, f - j0);
    __syncthreads();
    stage(rows, h, row0, nrows, f, j0, n);
    __syncthreads();
    if (live) {
      const T* t = wd + (size_t)j0 * d;
      moe::rows_dot_columns_acc<T, kRows, W, 1>(rows, kChunk, n, t, t, nullptr,
                                                nullptr, d, c, acc);
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < nrows) {
#pragma unroll
      for (int q = 0; q < W; ++q)
        y[(size_t)(row0 + r) * d + c + q] = Num<T>::from_f32(acc[0][r][q]);
    }
  }
}

// Threads per block: the most (128, 64 or 32) that still give every SM two
// blocks. A thread's arithmetic does not depend on it; at decode (one row
// block) fewer threads a block spread the weight stream over more SMs.
inline int pick_threads(int row_blocks, int cols, int W, int sms) {
  for (int t = kMaxThreads; t > 32; t /= 2)
    if ((long long)row_blocks * moe::ceil_div(cols, t * W) >= 2LL * sms)
      return t;
  return 32;
}

template <typename T>
int launch(const T* x, const T* wg, const T* wu, const T* wd, T* h, T* y,
           int n_rows, int d, int f, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int rb = moe::ceil_div(n_rows, kRows);
  if (f % 2 == 0) {
    const int t = pick_threads(rb, f, 2, sms);
    up_kernel<T, 2><<<dim3(rb, moe::ceil_div(f, t * 2)), t, 0, s>>>(
        x, wg, wu, h, n_rows, d, f);
  } else {
    const int t = pick_threads(rb, f, 1, sms);
    up_kernel<T, 1><<<dim3(rb, moe::ceil_div(f, t)), t, 0, s>>>(
        x, wg, wu, h, n_rows, d, f);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (d % 2 == 0) {
    const int t = pick_threads(rb, d, 2, sms);
    down_kernel<T, 2><<<dim3(rb, moe::ceil_div(d, t * 2)), t, 0, s>>>(
        h, wd, y, n_rows, d, f);
  } else {
    const int t = pick_threads(rb, d, 1, sms);
    down_kernel<T, 1><<<dim3(rb, moe::ceil_div(d, t)), t, 0, s>>>(
        h, wd, y, n_rows, d, f);
  }
  return (int)cudaGetLastError();
}

}  // namespace mlp

namespace tcmlp {

using tc::bf16;

constexpr int kBM = 128;          // rows of a block tile: two warpgroups of 64
constexpr int kBN = 128;          // output columns of a block tile (each table)
constexpr int kBK = 64;           // reduction values of one ring stage
constexpr int kThreads = 256;
constexpr int kATile = kBM * kBK;   // [128 rows][64 k] K-major: 16 KB
constexpr int kBTile = kBK * kBN;   // [64 k][128 n] MN-major: two 8 KB blocks
constexpr int kColBlock = kBK * 64; // values of one 64-column block
constexpr int kUpStages = 4;        // 48 KB a stage: one block an SM
constexpr int kDownStages = 3;      // 32 KB a stage: two blocks an SM
constexpr int kMaxSlices = 16;
constexpr int kBadPlan = -2;

template <int NMAT>
struct Tabs {
  const bf16* p[NMAT];
};

struct Slices {
  int n;
  int lo[kMaxSlices + 1];
};

template <int NMAT, int STAGES>
struct Ring {
  static constexpr int kStage = kATile + NMAT * kBTile;
  static constexpr size_t kSmem =
      (size_t)STAGES * kStage * sizeof(bf16) + 1024;  // + base alignment
};

// The dynamic shared memory rounded up to the 1024-byte alignment the
// 128-byte swizzle needs.
__device__ __forceinline__ bf16* aligned_smem(unsigned char* raw) {
  const uint32_t a = tc::smem_u32(raw);
  return reinterpret_cast<bf16*>(raw + (((a + 1023) & ~1023u) - a));
}

// One ring stage, 128-byte swizzled: rows [m0, m0 + a_rows) x reduction
// [k0, k0 + kBK) of A (lda = its row length), and of each table reduction
// rows [k0, k0 + kBK) x columns [n0, n0 + kBN) (row length N). Rows >= M,
// reduction indices >= k_end and columns >= N are zero-filled.
template <int NMAT>
__device__ __forceinline__ void load_stage(bf16* st, const bf16* __restrict__ A,
                                           int M, int lda, int m0, int a_rows,
                                           const Tabs<NMAT>& B, int N, int n0,
                                           int k0, int k_end) {
  char* base = reinterpret_cast<char*>(st);
  for (int i = threadIdx.x; i < a_rows * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = m0 + r < M && k0 + c * 8 < k_end;
    tc::cp_async16(base + tc::sw128(r, c),
                   ok ? A + (size_t)(m0 + r) * lda + k0 + c * 8 : A, ok);
  }
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat) {
    char* bt = base + (size_t)(kATile + mat * kBTile) * sizeof(bf16);
#pragma unroll 4
    for (int i = threadIdx.x; i < kBK * 16; i += kThreads) {
      const int r = i >> 4, c = i & 15;
      const bool ok = k0 + r < k_end && n0 + c * 8 < N;
      tc::cp_async16(bt + (c >> 3) * (kColBlock * 2) + tc::sw128(r, c & 7),
                     ok ? B.p[mat] + (size_t)(k0 + r) * N + n0 + c * 8
                        : B.p[mat],
                     ok);
    }
  }
}

// acc[mat] = A[m0 + 64 wg .. + 64, k_lo:k_hi] @ B[mat][k_lo:k_hi, n0 .. +
// 128] for warpgroup wg, k-tiles of kBK in ascending order through the
// cp.async ring, four wgmma k16 steps a tile. A warpgroup whose 64 rows are
// all past M copies but does not compute.
template <int NMAT, int STAGES>
__device__ __forceinline__ void gemm(float (&acc)[NMAT][64], bf16* smem,
                                     const bf16* A, int M, int lda, int m0,
                                     const Tabs<NMAT>& B, int N, int n0,
                                     int k_lo, int k_hi) {
  using R = Ring<NMAT, STAGES>;
  const int wg = threadIdx.x / 128;
  const int live = min(kBM, M - m0);
  const int a_rows = (live + 63) / 64 * 64;
  const bool mine = wg * 64 < live;
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mat][i] = 0.0f;
  const int n_k = (k_hi - k_lo + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k)
      load_stage<NMAT>(smem + s * R::kStage, A, M, lda, m0, a_rows, B, N, n0,
                       k_lo + s * kBK, k_hi);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    tc::cp_async_wait<STAGES - 2>();  // stage kt has landed (own copies)
    tc::fence_async_smem();           // ... visible to wgmma
    __syncthreads();                  // ... everyone's; stage kt-1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < n_k)
      load_stage<NMAT>(smem + (nxt % STAGES) * R::kStage, A, M, lda, m0,
                       a_rows, B, N, n0, k_lo + nxt * kBK, k_hi);
    tc::cp_async_commit();
    if (!mine) continue;
    const bf16* st = smem + (kt % STAGES) * R::kStage;
    const bf16* at = st + wg * 64 * kBK;
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) tc::fence_regs(acc[mat]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = tc::sw128_desc(at + kk * 16, 16, 1024);
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) {
        const uint64_t db = tc::sw128_desc(
            st + kATile + mat * kBTile + kk * 16 * 64, kColBlock * 2, 1024);
        tc::wgmma_m64n128k16_bt(acc[mat], da, db, 1);
      }
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();  // before the stage is refilled
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) tc::fence_regs(acc[mat]);
  }
  tc::cp_async_wait<0>();
}

// First row of this thread's accumulators: warpgroup, warp, lane / 4.
__device__ __forceinline__ int acc_row(int m0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return m0 + (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// h of one (g, u) before its rounding to bf16: silu(g) * u in fp32, or with
// kRoundGU the model's arithmetic, bf16(silu(bf16(g))) * bf16(u).
template <bool kRoundGU>
__device__ __forceinline__ float gu_to_h(float g, float u) {
  if constexpr (kRoundGU) {
    const float gb = round_bf16(g);
    return round_bf16(gb * (1.0f / (1.0f + expf(-gb)))) * round_bf16(u);
  } else {
    return moe::silu_mul(g, u);
  }
}

// h[row][c] = round_bf16(gu_to_h(g, u)), g / u = x_row . wg / wu[:, c]
// grid: (ceil(T / kBM), ceil(f / kBN))
template <bool kRoundGU>
__global__ void __launch_bounds__(kThreads, 1)
up_tc(const bf16* __restrict__ x, Tabs<2> w, bf16* __restrict__ h, int T,
      int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[2][64];
  gemm<2, kUpStages>(acc, aligned_smem(smem_raw), x, T, d, m0, w, f, n0, 0,
                     d);
  const int r0 = acc_row(m0);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (threadIdx.x % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half, e = 4 * j + 2 * half;
      if (row < T && col < f)
        *reinterpret_cast<uint32_t*>(h + (size_t)row * f + col) =
            tc::pack_bf16(gu_to_h<kRoundGU>(acc[0][e], acc[1][e]),
                          gu_to_h<kRoundGU>(acc[0][e + 1], acc[1][e + 1]));
    }
  }
}

// Slice s of the down product: h_row[lo:hi] . wd[lo:hi, c] in fp32, written to
// part[s][row][c]; with one slice the output itself, rounded.
// grid: (ceil(T / kBM), ceil(d / kBN), S)
__global__ void __launch_bounds__(kThreads, 2)
down_tc(const bf16* __restrict__ h, Tabs<1> w, Slices sl,
        float* __restrict__ part, bf16* __restrict__ y, int T, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, s = blockIdx.z;
  float acc[1][64];
  gemm<1, kDownStages>(acc, aligned_smem(smem_raw), h, T, f, m0, w, d, n0,
                       sl.lo[s], sl.lo[s + 1]);
  const int r0 = acc_row(m0);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (threadIdx.x % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half, e = 4 * j + 2 * half;
      if (row >= T || col >= d) continue;
      if (sl.n == 1)
        *reinterpret_cast<uint32_t*>(y + (size_t)row * d + col) =
            tc::pack_bf16(acc[0][e], acc[0][e + 1]);
      else
        *reinterpret_cast<float2*>(part + ((size_t)s * T + row) * d + col) =
            make_float2(acc[0][e], acc[0][e + 1]);
    }
  }
}

// y[i] = round_bf16(part[0][i] + part[1][i] + ... + part[S-1][i]), in slice
// order; n = T * d, a multiple of 4. grid: ceil(n / 4 / 256) x 256
__global__ void __launch_bounds__(256)
reduce_tc(const float* __restrict__ part, int S, bf16* __restrict__ y,
          size_t n) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 a = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < S; ++s) {
    const float4 b = *reinterpret_cast<const float4*>(part + s * n + i);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  *reinterpret_cast<uint2*>(y + i) =
      make_uint2(tc::pack_bf16(a.x, a.y), tc::pack_bf16(a.z, a.w));
}

inline int launch(const bf16* x, const bf16* wg, const bf16* wu,
                  const bf16* wd, bf16* h, float* part, bf16* y, int T, int d,
                  int f, int n_tile, int k_tile, const int* bounds, int S,
                  bool round_gu, cudaStream_t s) {
  if (n_tile != kBN || k_tile != kBK || S < 1 || S > kMaxSlices ||
      d % 8 != 0 || f % 8 != 0 || bounds == nullptr)
    return kBadPlan;
  Slices sl;
  sl.n = S;
  for (int i = 0; i <= S; ++i) sl.lo[i] = bounds[i];
  if (sl.lo[0] != 0 || sl.lo[S] != f) return kBadPlan;
  for (int i = 1; i <= S; ++i)
    if (sl.lo[i] <= sl.lo[i - 1] || (i < S && sl.lo[i] % kBK != 0))
      return kBadPlan;
  if (S > 1 && part == nullptr) return kBadPlan;
  using UpR = Ring<2, kUpStages>;
  using DownR = Ring<1, kDownStages>;
  auto up = round_gu ? &up_tc<true> : &up_tc<false>;
  cudaError_t err = cudaFuncSetAttribute(
      up, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)UpR::kSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(down_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DownR::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int rb = moe::ceil_div(T, kBM);
  up<<<dim3(rb, moe::ceil_div(f, kBN)), kThreads, UpR::kSmem, s>>>(
      x, Tabs<2>{{wg, wu}}, h, T, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_tc<<<dim3(rb, moe::ceil_div(d, kBN), S), kThreads, DownR::kSmem, s>>>(
      h, Tabs<1>{{wd}}, sl, part, y, T, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  const size_t n = (size_t)T * d;
  reduce_tc<<<(unsigned)((n / 4 + 255) / 256), 256, 0, s>>>(part, S, y, n);
  return (int)cudaGetLastError();
}

}  // namespace tcmlp

// The fp32 route (CUDA cores). x [T, d], wg / wu [d, f], wd [f, d], h
// scratch [T, f], out [T, d], all float32, contiguous and 16-byte aligned.
// Returns 0 or the cudaError_t of the refused launch; -1 for a dtype other
// than 0 (float32: bf16 takes swiglu_mlp_tc_launch).
extern "C" int swiglu_mlp_launch(const void* x, const void* wg, const void* wu,
                                 const void* wd, void* h, void* out, int T,
                                 int d, int f, int dtype, void* stream) {
  if (dtype != 0) return -1;
  if (T <= 0) return 0;
  return mlp::launch<float>((const float*)x, (const float*)wg,
                            (const float*)wu, (const float*)wd, (float*)h,
                            (float*)out, T, d, f, (cudaStream_t)stream);
}

// The bf16 route (tensor cores). x [T, d], wg / wu [d, f], wd [f, d], h
// scratch [T, f], out [T, d], all bfloat16, contiguous and 16-byte aligned,
// d and f multiples of 8; part: fp32 scratch [S, T, d] (unused, may be null,
// when S == 1). The tile plan: n_tile and k_tile must equal the kernel's
// (64, 64); bounds: a HOST array of S + 1 cut points of f, 0 first and f
// last, the inner ones multiples of k_tile. round_gu != 0: g and u rounded
// to bf16 before the activation (the model's arithmetic). Returns 0, the
// cudaError_t of a refused launch, or -2 for a plan or shape the kernel does
// not take.
extern "C" int swiglu_mlp_tc_launch(const void* x, const void* wg,
                                    const void* wu, const void* wd, void* h,
                                    void* part, void* out, const int* bounds,
                                    int T, int d, int f, int n_tile,
                                    int k_tile, int S, int round_gu,
                                    void* stream) {
  if (T <= 0) return 0;
  using tc::bf16;
  return tcmlp::launch((const bf16*)x, (const bf16*)wg, (const bf16*)wu,
                       (const bf16*)wd, (bf16*)h, (float*)part, (bf16*)out, T,
                       d, f, n_tile, k_tile, bounds, S, round_gu != 0,
                       (cudaStream_t)stream);
}

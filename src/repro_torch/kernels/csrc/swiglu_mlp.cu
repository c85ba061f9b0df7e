// swiglu_mlp: the dense SwiGLU MLP y = (silu(x @ wg) * (x @ wu)) @ wd for
// Hopper (sm_90a), as ONE expert of moe_swiglu.cuh. Replaces the TPU kernel
// src/repro/kernels/swiglu.py :: swiglu_mlp (_kernel).
//
// A thread owns W adjacent output columns of up to kRows rows and walks its
// reduction axis in index order with fmaf (moe::rows_dot_columns_acc): i < d
// for the gate and up products, j < f for the down product; h is rounded to
// the model type between the passes and the output once. A row's bits
// therefore depend on (d, f) alone: not on T, not on which rows share its
// block, and they equal grouped_swiglu's with one expert.
//
// The block's rows are staged in shared memory kChunk values of the reduction
// axis at a time (consecutive pieces of the same fmaf chain), so the shared
// memory a block needs does not grow with d or f and every dense config's
// published widths fit. grouped_swiglu holds whole fp32 rows instead, which
// leaves one row a block at f = 20480 and none past f = 58112.
//
// Two passes on the current stream, as the MoE kernels: gate/up writes
// h [T, f] to device memory in the model type, down reads it back. Keeping h
// on chip, as the TPU kernel does, is the known next step.
#include "moe_swiglu.cuh"

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

// dtype: 0 = float32, 1 = bfloat16. x [T, d], wg / wu [d, f], wd [f, d], h
// scratch [T, f], out [T, d], all in the same type, contiguous and 16-byte
// aligned. Returns 0 or the cudaError_t of the refused launch; -1 for a bad
// dtype.
extern "C" int swiglu_mlp_launch(const void* x, const void* wg, const void* wu,
                                 const void* wd, void* h, void* out, int T,
                                 int d, int f, int dtype, void* stream) {
  if (T <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return mlp::launch<float>((const float*)x, (const float*)wg,
                              (const float*)wu, (const float*)wd, (float*)h,
                              (float*)out, T, d, f, s);
  if (dtype == 1)
    return mlp::launch<__nv_bfloat16>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)wg,
        (const __nv_bfloat16*)wu, (const __nv_bfloat16*)wd, (__nv_bfloat16*)h,
        (__nv_bfloat16*)out, T, d, f, s);
  return -1;
}

// Per-expert SwiGLU for MoE layers on Hopper (sm_90a): the arithmetic shared by
// gather_swiglu.cu (decode) and grouped_swiglu.cu (admission / ragged).
//
// Every output element is produced by ONE thread that walks its reduction
// axis in index order with fp32 fmaf:
//
//   up   : g[c] = sum_{i<d} x[i] * wg[e][i][c]     (and u with wu), i ascending
//          h[c] = round_T(silu(g[c]) * u[c])
//   down : y[c] = round_T(sum_{j<f} h[j] * wd[e][j][c]), j ascending
//
// The order depends on nothing but (d, f): not on how many rows a block holds,
// not on the token count, not on which of the two wrappers asked. That is what
// makes a row's result bitwise identical whether the gather or the grouped
// kernel computed it.
//
// Work layout: a block owns up to R rows that share one expert and
// kThreads * W adjacent output columns. The rows sit in shared memory as fp32;
// a thread owns W adjacent columns, so a warp's weight loads are coalesced,
// and every weight element a block loads is used for all R rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace moe {

constexpr int kThreads = 128;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
  template <int W>
  static __device__ __forceinline__ void load(const float* p, float (&o)[W]) {
    if constexpr (W == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      o[0] = v.x;
      o[1] = v.y;
    } else {
      o[0] = *p;
    }
  }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16_rn(v);
  }
  template <int W>
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[W]) {
    if constexpr (W == 2) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
      o[0] = __low2float(v);
      o[1] = __high2float(v);
    } else {
      o[0] = __bfloat162float(*p);
    }
  }
};

// The rows one block works on: `nrows` consecutive rows of the row space,
// starting at `row0`, all through expert `expert`. nrows == 0: nothing to do.
struct RowBlock {
  int expert;
  int row0;
  int nrows;
};

// Decode layout: the row space is the T*k (token, j) pairs, token-major; each
// pair is a block of one row with its own expert id, clipped to [0, E).
struct PairLayout {
  const int* idx;  // [T*k]
  int k;
  int E;
  int n_pairs;
  __device__ RowBlock block(int b) const {
    RowBlock rb;
    rb.row0 = b;
    rb.nrows = b < n_pairs ? 1 : 0;
    const int e = b < n_pairs ? idx[b] : 0;
    rb.expert = min(max(e, 0), E - 1);
    return rb;
  }
  __device__ int x_row(int row) const { return row / k; }
};

// Admission layout: rows are sorted by expert and group_sizes[e] counts the
// rows of expert e. Expert e contributes ceil(size/R) blocks, so a zero-sized
// group contributes none and can never be mistaken for its neighbour.
struct SegmentLayout {
  const int* group_sizes;  // [E]
  int E;
  int T;
  int R;
  __device__ RowBlock block(int b) const {
    int start = 0;
    int nb = 0;
    for (int e = 0; e < E; ++e) {
      const int sz = max(group_sizes[e], 0);
      const int blocks = (sz + R - 1) / R;
      if (b < nb + blocks) {
        RowBlock rb;
        rb.expert = e;
        rb.row0 = start + (b - nb) * R;
        rb.nrows = max(min(min(R, start + sz - rb.row0), T - rb.row0), 0);
        return rb;
      }
      nb += blocks;
      start += sz;
    }
    return RowBlock{0, 0, 0};
  }
  __device__ int x_row(int row) const { return row; }
};

// acc[n][r][q] = sum_{i<depth} rows[r][i] * table_n[i][c + q], i ascending.
// `rows` is shared memory [R][depth] fp32; table_n is [depth][ncols] in T.
template <typename T, int R, int W, int NTAB>
__device__ __forceinline__ void rows_dot_columns(const float* rows, int depth,
                                                 const T* t0, const T* t1,
                                                 int ncols, int c,
                                                 float (&acc)[NTAB][R][W]) {
#pragma unroll
  for (int n = 0; n < NTAB; ++n)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < W; ++q) acc[n][r][q] = 0.0f;
  const T* p0 = t0 + c;
  const T* p1 = NTAB > 1 ? t1 + c : t0 + c;
#pragma unroll 4
  for (int i = 0; i < depth; ++i) {
    float a[NTAB][W];
    Num<T>::template load<W>(p0 + (size_t)i * ncols, a[0]);
    if constexpr (NTAB > 1) Num<T>::template load<W>(p1 + (size_t)i * ncols, a[1]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xv = rows[r * depth + i];
#pragma unroll
      for (int n = 0; n < NTAB; ++n)
#pragma unroll
        for (int q = 0; q < W; ++q) acc[n][r][q] = fmaf(xv, a[n][q], acc[n][r][q]);
    }
  }
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  const float s = 1.0f / (1.0f + expf(-g));
  return (g * s) * u;
}

// h[row][c] = round_T(silu(x_row . wg[e][:, c]) * (x_row . wu[e][:, c]))
// grid: (row blocks, ceil(f / (kThreads * W))); shared memory: R * d floats.
template <typename T, int R, int W, typename Layout>
__global__ void __launch_bounds__(kThreads)
swiglu_up_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                 const T* __restrict__ wu, T* __restrict__ h, Layout lay, int d,
                 int f) {
  extern __shared__ float rows[];
  const RowBlock rb = lay.block(blockIdx.x);
  if (rb.nrows == 0) return;
  for (int r = 0; r < R; ++r) {
    const bool live = r < rb.nrows;
    const T* src = x + (size_t)lay.x_row(rb.row0 + (live ? r : 0)) * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      rows[r * d + i] = live ? Num<T>::to_f32(src[i]) : 0.0f;
  }
  __syncthreads();
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * W;
  if (c >= f) return;
  const size_t off = (size_t)rb.expert * d * f;
  float acc[2][R][W];
  rows_dot_columns<T, R, W, 2>(rows, d, wg + off, wu + off, f, c, acc);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rb.nrows) {
#pragma unroll
      for (int q = 0; q < W; ++q)
        h[(size_t)(rb.row0 + r) * f + c + q] =
            Num<T>::from_f32(silu_mul(acc[0][r][q], acc[1][r][q]));
    }
  }
}

// y[row][c] = round_T(h_row . wd[e][:, c])
// grid: (row blocks, ceil(d / (kThreads * W))); shared memory: R * f floats.
template <typename T, int R, int W, typename Layout>
__global__ void __launch_bounds__(kThreads)
swiglu_down_kernel(const T* __restrict__ h, const T* __restrict__ wd,
                   T* __restrict__ y, Layout lay, int d, int f) {
  extern __shared__ float rows[];
  const RowBlock rb = lay.block(blockIdx.x);
  if (rb.nrows == 0) return;
  for (int r = 0; r < R; ++r) {
    const bool live = r < rb.nrows;
    const T* src = h + (size_t)(rb.row0 + (live ? r : 0)) * f;
    for (int i = threadIdx.x; i < f; i += blockDim.x)
      rows[r * f + i] = live ? Num<T>::to_f32(src[i]) : 0.0f;
  }
  __syncthreads();
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * W;
  if (c >= d) return;
  const size_t off = (size_t)rb.expert * f * d;
  float acc[1][R][W];
  rows_dot_columns<T, R, W, 1>(rows, f, wd + off, wd + off, d, c, acc);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rb.nrows) {
#pragma unroll
      for (int q = 0; q < W; ++q)
        y[(size_t)(rb.row0 + r) * d + c + q] = Num<T>::from_f32(acc[0][r][q]);
    }
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Launches the up and the down pass for `n_blocks` row blocks on `stream`.
// `h` is scratch [rows, f], `y` the result [rows, d]. W = 2 needs even widths
// (the caller checks the base pointers' alignment). Returns a cudaError_t.
template <typename T, int R, typename Layout>
int launch_up_down(const T* x, const T* wg, const T* wu, const T* wd, T* h, T* y,
                   Layout lay, int n_blocks, int d, int f, cudaStream_t stream) {
  if (n_blocks <= 0) return 0;
  const size_t smem_up = (size_t)R * d * sizeof(float);
  const size_t smem_down = (size_t)R * f * sizeof(float);
  cudaError_t err;
  if (f % 2 == 0) {
    auto k = swiglu_up_kernel<T, R, 2, Layout>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_up);
    if (err != cudaSuccess) return (int)err;
    k<<<dim3(n_blocks, ceil_div(f, kThreads * 2)), kThreads, smem_up, stream>>>(
        x, wg, wu, h, lay, d, f);
  } else {
    auto k = swiglu_up_kernel<T, R, 1, Layout>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_up);
    if (err != cudaSuccess) return (int)err;
    k<<<dim3(n_blocks, ceil_div(f, kThreads)), kThreads, smem_up, stream>>>(
        x, wg, wu, h, lay, d, f);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (d % 2 == 0) {
    auto k = swiglu_down_kernel<T, R, 2, Layout>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_down);
    if (err != cudaSuccess) return (int)err;
    k<<<dim3(n_blocks, ceil_div(d, kThreads * 2)), kThreads, smem_down, stream>>>(
        h, wd, y, lay, d, f);
  } else {
    auto k = swiglu_down_kernel<T, R, 1, Layout>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_down);
    if (err != cudaSuccess) return (int)err;
    k<<<dim3(n_blocks, ceil_div(d, kThreads)), kThreads, smem_down, stream>>>(
        h, wd, y, lay, d, f);
  }
  return (int)cudaGetLastError();
}

}  // namespace moe

// Per-expert SwiGLU for MoE layers on Hopper (sm_90a): the arithmetic shared by
// gather_swiglu.cu / gather_swiglu_q.cu (decode), grouped_swiglu.cu /
// grouped_swiglu_q.cu (admission / ragged) and swiglu_mlp.cu (the dense MLP,
// one expert).
//
// Every output element is produced by ONE thread that walks its reduction
// axis in index order with fp32 fmaf:
//
//   up   : g[c] = sum_{i<d} x[i] * wg[e][i][c]     (and u with wu), i ascending
//          h[c] = round_H(silu(g[c]) * u[c])
//   down : y[c] = round_T(sum_{j<f} h[j] * wd[e][j][c]), j ascending
//
// Plain tables (Wt = T): the stored weight, widened; h is rounded to the
// model type (H = T). Int8 tables (Wt = int8): the weight is
// __fmul_rn((float)q, scale[e][c]) with the scale of the OUTPUT column c (f for
// wg/wu, d for wd), one rounding the compiler may not contract into the fma
// that follows, and h stays fp32 (H = float): the only rounding to the model
// type is the output's. These are the CUDA-core routes: fp32 activations, and
// bf16 ones at widths the tensor-core tiles do not take. bf16 activations at
// widths that are multiples of 8 (plain tables) or 16 (int8 tables) run on
// the tensor cores instead (moe_tc_sm90.cuh, with its own int8 contract:
// the scale after the sum, h kept as a bf16 hi + lo pair).
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

// How a thread turns W adjacent stored weights of one row of a table into
// fp32. `sc` holds the scales of its W output columns (int8 only).
template <typename Wt>
struct Weight {
  static constexpr bool kQuant = false;
  template <int W>
  static __device__ __forceinline__ void load(const Wt* p, const float (&)[W],
                                              float (&o)[W]) {
    Num<Wt>::template load<W>(p, o);
  }
};

template <>
struct Weight<signed char> {
  static constexpr bool kQuant = true;
  template <int W>
  static __device__ __forceinline__ void load(const signed char* p,
                                              const float (&sc)[W],
                                              float (&o)[W]) {
    if constexpr (W == 2) {
      const char2 v = *reinterpret_cast<const char2*>(p);
      o[0] = __fmul_rn((float)v.x, sc[0]);
      o[1] = __fmul_rn((float)v.y, sc[1]);
    } else {
      o[0] = __fmul_rn((float)*p, sc[0]);
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

template <int R, int W, int NTAB>
__device__ __forceinline__ void zero_acc(float (&acc)[NTAB][R][W]) {
#pragma unroll
  for (int n = 0; n < NTAB; ++n)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < W; ++q) acc[n][r][q] = 0.0f;
}

// acc[n][r][q] += sum_{i<depth} rows[r * stride + i] * table_n[i][c + q], i
// ascending, one fmaf each. `rows` is shared memory holding R rows of fp32
// `stride` apart; table_n is [depth][ncols] in Wt; s0/s1 are the tables'
// scale rows [ncols] (int8 only, else unused). Walking a reduction axis in
// consecutive pieces through this function gives the same bits as walking it
// in one call: the fmaf chain is the same.
template <typename Wt, int R, int W, int NTAB>
__device__ __forceinline__ void rows_dot_columns_acc(
    const float* rows, int stride, int depth, const Wt* t0, const Wt* t1,
    const float* s0, const float* s1, int ncols, int c,
    float (&acc)[NTAB][R][W]) {
  float sc[NTAB][W];
#pragma unroll
  for (int n = 0; n < NTAB; ++n)
#pragma unroll
    for (int q = 0; q < W; ++q) sc[n][q] = 1.0f;
  if constexpr (Weight<Wt>::kQuant) {
#pragma unroll
    for (int n = 0; n < NTAB; ++n)
#pragma unroll
      for (int q = 0; q < W; ++q) sc[n][q] = (n == 0 ? s0 : s1)[c + q];
  }
  const Wt* p0 = t0 + c;
  const Wt* p1 = NTAB > 1 ? t1 + c : t0 + c;
#pragma unroll 4
  for (int i = 0; i < depth; ++i) {
    float a[NTAB][W];
    Weight<Wt>::template load<W>(p0 + (size_t)i * ncols, sc[0], a[0]);
    if constexpr (NTAB > 1)
      Weight<Wt>::template load<W>(p1 + (size_t)i * ncols, sc[NTAB - 1],
                                   a[NTAB - 1]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xv = rows[r * stride + i];
#pragma unroll
      for (int n = 0; n < NTAB; ++n)
#pragma unroll
        for (int q = 0; q < W; ++q) acc[n][r][q] = fmaf(xv, a[n][q], acc[n][r][q]);
    }
  }
}

// acc[n][r][q] = sum_{i<depth} rows[r][i] * table_n[i][c + q], i ascending.
// `rows` is shared memory [R][depth] fp32.
template <typename Wt, int R, int W, int NTAB>
__device__ __forceinline__ void rows_dot_columns(const float* rows, int depth,
                                                 const Wt* t0, const Wt* t1,
                                                 const float* s0,
                                                 const float* s1, int ncols,
                                                 int c,
                                                 float (&acc)[NTAB][R][W]) {
  zero_acc<R, W, NTAB>(acc);
  rows_dot_columns_acc<Wt, R, W, NTAB>(rows, depth, depth, t0, t1, s0, s1,
                                       ncols, c, acc);
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  const float s = 1.0f / (1.0f + expf(-g));
  return (g * s) * u;
}

// h[row][c] = round_H(silu(x_row . wg[e][:, c]) * (x_row . wu[e][:, c]))
// grid: (row blocks, ceil(f / (kThreads * W))); shared memory: R * d floats.
// sg/su: scales [E][f] (int8 tables; nullptr otherwise).
template <typename T, typename Wt, typename H, int R, int W, typename Layout>
__global__ void __launch_bounds__(kThreads)
swiglu_up_kernel(const T* __restrict__ x, const Wt* __restrict__ wg,
                 const Wt* __restrict__ wu, const float* __restrict__ sg,
                 const float* __restrict__ su, H* __restrict__ h, Layout lay,
                 int d, int f) {
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
  const size_t soff = (size_t)rb.expert * f;
  float acc[2][R][W];
  rows_dot_columns<Wt, R, W, 2>(rows, d, wg + off, wu + off,
                                Weight<Wt>::kQuant ? sg + soff : sg,
                                Weight<Wt>::kQuant ? su + soff : su, f, c,
                                acc);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rb.nrows) {
#pragma unroll
      for (int q = 0; q < W; ++q)
        h[(size_t)(rb.row0 + r) * f + c + q] =
            Num<H>::from_f32(silu_mul(acc[0][r][q], acc[1][r][q]));
    }
  }
}

// y[row][c] = round_T(h_row . wd[e][:, c])
// grid: (row blocks, ceil(d / (kThreads * W))); shared memory: R * f floats.
// sd: scales [E][d] (int8 tables; nullptr otherwise).
template <typename T, typename Wt, typename H, int R, int W, typename Layout>
__global__ void __launch_bounds__(kThreads)
swiglu_down_kernel(const H* __restrict__ h, const Wt* __restrict__ wd,
                   const float* __restrict__ sd, T* __restrict__ y, Layout lay,
                   int d, int f) {
  extern __shared__ float rows[];
  const RowBlock rb = lay.block(blockIdx.x);
  if (rb.nrows == 0) return;
  for (int r = 0; r < R; ++r) {
    const bool live = r < rb.nrows;
    const H* src = h + (size_t)(rb.row0 + (live ? r : 0)) * f;
    for (int i = threadIdx.x; i < f; i += blockDim.x)
      rows[r * f + i] = live ? Num<H>::to_f32(src[i]) : 0.0f;
  }
  __syncthreads();
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * W;
  if (c >= d) return;
  const size_t off = (size_t)rb.expert * f * d;
  const float* s = Weight<Wt>::kQuant ? sd + (size_t)rb.expert * d : sd;
  float acc[1][R][W];
  rows_dot_columns<Wt, R, W, 1>(rows, f, wd + off, wd + off, s, s, d, c, acc);
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

// The gather forms' slot-order combine, one pass on the stream: out[t] =
// round_T(((0 + w[t,0]*y[t,0]) + w[t,1]*y[t,1]) + ...) in fp32, product and
// sum rounded separately, j ascending: bitwise kernels/ref.py ::
// combine_in_order and the ragged path's combine. y: [T, k, d]; w: [T, k]
// fp32; out: [T, d]. Launched by gather_swiglu.cu and gather_swiglu_q.cu.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ y, const float* __restrict__ w,
               T* __restrict__ out, int d, int k) {
  const int t = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float acc = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float yv = Num<T>::to_f32(y[((size_t)t * k + j) * d + c]);
    // explicit intrinsics: the compiler must not contract this into an fma,
    // the ragged path's combine rounds the product and the sum separately
    acc = __fadd_rn(acc, __fmul_rn(w[(size_t)t * k + j], yv));
  }
  out[(size_t)t * d + c] = Num<T>::from_f32(acc);
}

template <typename T>
int combine_launch(const T* y, const float* w, T* out, int T_, int d, int k,
                   cudaStream_t stream) {
  combine_kernel<T><<<dim3(T_, ceil_div(d, kThreads)), kThreads, 0, stream>>>(
      y, w, out, d, k);
  return (int)cudaGetLastError();
}


// Launches the up and the down pass for `n_blocks` row blocks on `stream`.
// `h` is scratch [rows, f] in H, `y` the result [rows, d] in T; sg/su/sd are
// the int8 tables' scales (nullptr for plain tables). W = 2 needs even widths
// (the caller checks the base pointers' alignment). Returns a cudaError_t.
template <typename T, typename Wt, typename H, int R, typename Layout>
int launch_up_down(const T* x, const Wt* wg, const Wt* wu, const Wt* wd,
                   const float* sg, const float* su, const float* sd, H* h,
                   T* y, Layout lay, int n_blocks, int d, int f,
                   cudaStream_t stream) {
  if (n_blocks <= 0) return 0;
  const size_t smem_up = (size_t)R * d * sizeof(float);
  const size_t smem_down = (size_t)R * f * sizeof(float);
  cudaError_t err;
  if (f % 2 == 0) {
    auto k = swiglu_up_kernel<T, Wt, H, R, 2, Layout>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_up);
    if (err != cudaSuccess) return (int)err;
    k<<<dim3(n_blocks, ceil_div(f, kThreads * 2)), kThreads, smem_up, stream>>>(
        x, wg, wu, sg, su, h, lay, d, f);
  } else {
    auto k = swiglu_up_kernel<T, Wt, H, R, 1, Layout>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_up);
    if (err != cudaSuccess) return (int)err;
    k<<<dim3(n_blocks, ceil_div(f, kThreads)), kThreads, smem_up, stream>>>(
        x, wg, wu, sg, su, h, lay, d, f);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (d % 2 == 0) {
    auto k = swiglu_down_kernel<T, Wt, H, R, 2, Layout>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_down);
    if (err != cudaSuccess) return (int)err;
    k<<<dim3(n_blocks, ceil_div(d, kThreads * 2)), kThreads, smem_down, stream>>>(
        h, wd, sd, y, lay, d, f);
  } else {
    auto k = swiglu_down_kernel<T, Wt, H, R, 1, Layout>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_down);
    if (err != cudaSuccess) return (int)err;
    k<<<dim3(n_blocks, ceil_div(d, kThreads)), kThreads, smem_down, stream>>>(
        h, wd, sd, y, lay, d, f);
  }
  return (int)cudaGetLastError();
}

// The SegmentLayout launch of the grouped kernels: every expert can end in one
// partial block, so ceil(T/R) + min(E, T) bounds the number of blocks
// whatever the group sizes are.
template <typename T, typename Wt, typename H, int R>
int grouped_launch(const T* x, const Wt* wg, const Wt* wu, const Wt* wd,
                   const float* sg, const float* su, const float* sd,
                   const int* group_sizes, H* h, T* out, int T_, int E, int d,
                   int f, cudaStream_t stream) {
  SegmentLayout lay{group_sizes, E, T_, R};
  const int n_blocks = ceil_div(T_, R) + (E < T_ ? E : T_);
  return launch_up_down<T, Wt, H, R, SegmentLayout>(
      x, wg, wu, wd, sg, su, sd, h, out, lay, n_blocks, d, f, stream);
}

// grouped_launch with the row count R chosen at run time (8, 4 or 1: the
// wrapper picks the largest whose rows fit in shared memory); -2 otherwise.
template <typename T, typename Wt, typename H>
int grouped_dispatch(const T* x, const Wt* wg, const Wt* wu, const Wt* wd,
                     const float* sg, const float* su, const float* sd,
                     const int* group_sizes, H* h, T* out, int T_, int E, int d,
                     int f, int rows, cudaStream_t s) {
  switch (rows) {
    case 8:
      return grouped_launch<T, Wt, H, 8>(x, wg, wu, wd, sg, su, sd, group_sizes,
                                         h, out, T_, E, d, f, s);
    case 4:
      return grouped_launch<T, Wt, H, 4>(x, wg, wu, wd, sg, su, sd, group_sizes,
                                         h, out, T_, E, d, f, s);
    case 1:
      return grouped_launch<T, Wt, H, 1>(x, wg, wu, wd, sg, su, sd, group_sizes,
                                         h, out, T_, E, d, f, s);
    default:
      return -2;
  }
}

}  // namespace moe

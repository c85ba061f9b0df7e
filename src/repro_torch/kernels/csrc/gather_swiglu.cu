// gather_swiglu: decode-mode MoE. Row t of the result is
//   sum_j w[t, j] * SwiGLU_{idx[t, j]}(x[t])
// Three passes on one stream, no sort, no atomics:
//   up      h[pair]  for the T*k (token, j) pairs, each through its own expert
//   down    y[pair]  rounded to the model type
//   combine out[t] = round_T(((0 + w[t,0]*y[t,0]) + w[t,1]*y[t,1]) + ...)
//           in fp32, product and sum rounded separately, j ascending
// Two routes for the up and down passes, chosen by the wrapper
// (kernels/moe_tc.py :: route), each the one grouped_swiglu.cu launches for
// the same route, so a pair's y is bitwise the grouped kernel's row:
//   bf16, d and f multiples of 8: tensor cores (moe_tc_sm90.cuh,
//     gather_swiglu_tc_launch), on an EXPERT-MAJOR grid: block (column tile,
//     e) reads the T*k ids (clipped to [0, E)), collects the pairs whose id is
//     e in ascending pair order, 64 rows a tile, and exits at once if there
//     are none. Each expert that is hit streams its tables once per column
//     tile (from L2 again for a second 64-pair tile), not once per pair;
//   anything else (fp32, odd widths): CUDA cores (moe_swiglu.cuh,
//     gather_swiglu_launch), one block per pair (PairLayout).
#include "moe_swiglu.cuh"
#include "moe_tc_sm90.cuh"

namespace moe {

template <typename T>
int gather_launch(const void* x, const void* wg, const void* wu, const void* wd,
                  const int* idx, const float* w, void* h, void* y, void* out,
                  int T_, int E, int d, int f, int k, cudaStream_t stream) {
  const int n_pairs = T_ * k;
  PairLayout lay{idx, k, E, n_pairs};
  int err = launch_up_down<T, T, T, 1, PairLayout>(
      (const T*)x, (const T*)wg, (const T*)wu, (const T*)wd, nullptr, nullptr,
      nullptr, (T*)h, (T*)y, lay, n_pairs, d, f, stream);
  if (err != 0) return err;
  return combine_launch<T>((const T*)y, w, (T*)out, T_, d, k, stream);
}

}  // namespace moe

namespace moetc {

// h[pair] = round_bf16(silu(x[pair / k] . wg[e]) * (x[pair / k] . wu[e])) for
// the pairs of expert e = blockIdx.y; grid: (ceil(f / kUpBN), E)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gather_up_tc(const bf16* __restrict__ x, const bf16* __restrict__ wg,
             const bf16* __restrict__ wu, const int* __restrict__ idx,
             bf16* __restrict__ h, int n_pairs, int k, int E, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int list[kBM + kThreads];
  __shared__ int x_row[kBM];
  __shared__ int warp_n[kThreads / 32];
  const int e = blockIdx.y;
  const size_t off = (size_t)e * d * f;
  char* smem = aligned_smem(smem_raw);
  for_each_pair_tile(idx, n_pairs, E, e, list, warp_n, [&](int n) {
    if (threadIdx.x < n) x_row[threadIdx.x] = list[threadIdx.x] / k;
    __syncthreads();
    up_tile<kUpBN>(smem, x, d, Tile{x_row, list, n}, wg + off, wu + off, h,
                   f, blockIdx.x * kUpBN);
    __syncthreads();
  });
}

// y[pair] = round_bf16(h[pair] . wd[e]) for the pairs of expert e =
// blockIdx.y; grid: (ceil(d / kDownBN), E)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gather_down_tc(const bf16* __restrict__ h, const bf16* __restrict__ wd,
               const int* __restrict__ idx, bf16* __restrict__ y, int n_pairs,
               int E, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int list[kBM + kThreads];
  __shared__ int warp_n[kThreads / 32];
  const int e = blockIdx.y;
  const bf16* wd_e = wd + (size_t)e * f * d;
  char* smem = aligned_smem(smem_raw);
  for_each_pair_tile(idx, n_pairs, E, e, list, warp_n, [&](int n) {
    down_tile<kDownBN>(smem, h, f, Tile{list, list, n}, wd_e, y, d,
                       blockIdx.x * kDownBN);
    __syncthreads();
  });
}

int gather_tc(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wd,
              const int* idx, const float* w, bf16* h, bf16* y, bf16* out,
              int T, int E, int d, int f, int k, cudaStream_t s) {
  int err = allow_ring<kUpBN, 2>(gather_up_tc);
  if (err != 0) return err;
  err = allow_ring<kDownBN, 1>(gather_down_tc);
  if (err != 0) return err;
  const int n_pairs = T * k;
  gather_up_tc<<<dim3(moe::ceil_div(f, kUpBN), E), kThreads,
                 Ring<kUpBN, 2>::kSmem, s>>>(x, wg, wu, idx, h, n_pairs, k, E,
                                             d, f);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  gather_down_tc<<<dim3(moe::ceil_div(d, kDownBN), E), kThreads,
                   Ring<kDownBN, 1>::kSmem, s>>>(h, wd, idx, y, n_pairs, E, d,
                                                 f);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return moe::combine_launch<bf16>(y, w, out, T, d, k, s);
}

}  // namespace moetc

// The CUDA-core route. dtype: 0 = float32, 1 = bfloat16. h: scratch [T*k, f];
// y: scratch [T*k, d]. Returns 0 or the cudaError_t of the refused launch; -1
// for a bad dtype.
extern "C" int gather_swiglu_launch(const void* x, const void* wg,
                                    const void* wu, const void* wd,
                                    const int* idx, const float* w, void* h,
                                    void* y, void* out, int T, int E, int d,
                                    int f, int k, int dtype, void* stream) {
  if (T <= 0 || k <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return moe::gather_launch<float>(x, wg, wu, wd, idx, w, h, y, out, T, E, d,
                                     f, k, s);
  if (dtype == 1)
    return moe::gather_launch<__nv_bfloat16>(x, wg, wu, wd, idx, w, h, y, out,
                                             T, E, d, f, k, s);
  return -1;
}

// The tensor-core route: x [T, d], wg / wu [E, d, f], wd [E, f, d], h scratch
// [T*k, f], y scratch [T*k, d], out [T, d], all bfloat16, contiguous and
// 16-byte aligned, d and f multiples of 8; idx [T, k] int32, w [T, k] fp32.
// The tile plan (m_tile, up_n, down_n, k_tile, stages) must be the compiled
// one. Returns 0, the cudaError_t of a refused launch, or -2 for a plan or
// shape the kernels do not take.
extern "C" int gather_swiglu_tc_launch(const void* x, const void* wg,
                                       const void* wu, const void* wd,
                                       const int* idx, const float* w, void* h,
                                       void* y, void* out, int T, int E, int d,
                                       int f, int k, int m_tile, int up_n,
                                       int down_n, int k_tile, int stages,
                                       void* stream) {
  if (T <= 0 || k <= 0) return 0;
  if (E < 1 || !moetc::plan_ok(m_tile, up_n, down_n, k_tile, stages, d, f))
    return moetc::kBadPlan;
  using moetc::bf16;
  return moetc::gather_tc((const bf16*)x, (const bf16*)wg, (const bf16*)wu,
                          (const bf16*)wd, idx, w, (bf16*)h, (bf16*)y,
                          (bf16*)out, T, E, d, f, k, (cudaStream_t)stream);
}

// gather_swiglu: decode-mode MoE. Row t of the result is
//   sum_j w[t, j] * SwiGLU_{idx[t, j]}(x[t])
// Three passes on one stream, no atomics:
//   up      h[pair]  for the T*k (token, j) pairs, each through its own expert
//   down    y[pair]  rounded to the model type
//   combine out[t] = round_T(((0 + w[t,0]*y[t,0]) + w[t,1]*y[t,1]) + ...)
//           in fp32, product and sum rounded separately, j ascending
// The up and down passes are the ones grouped_swiglu.cu launches
// (moe_swiglu.cuh), so a pair's y is bitwise the grouped kernel's row.
#include "moe_swiglu.cuh"

namespace moe {

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
int gather_launch(const void* x, const void* wg, const void* wu, const void* wd,
                  const int* idx, const float* w, void* h, void* y, void* out,
                  int T_, int E, int d, int f, int k, cudaStream_t stream) {
  const int n_pairs = T_ * k;
  PairLayout lay{idx, k, E, n_pairs};
  int err = launch_up_down<T, T, T, 1, PairLayout>(
      (const T*)x, (const T*)wg, (const T*)wu, (const T*)wd, nullptr, nullptr,
      nullptr, (T*)h, (T*)y, lay, n_pairs, d, f, stream);
  if (err != 0) return err;
  combine_kernel<T><<<dim3(T_, ceil_div(d, kThreads)), kThreads, 0, stream>>>(
      (const T*)y, w, (T*)out, d, k);
  return (int)cudaGetLastError();
}

}  // namespace moe

// dtype: 0 = float32, 1 = bfloat16. h: scratch [T*k, f]; y: scratch [T*k, d].
// Returns 0 or the cudaError_t of the refused launch; -1 for a bad dtype.
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

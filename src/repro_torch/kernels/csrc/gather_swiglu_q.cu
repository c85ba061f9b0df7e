// gather_swiglu_q: decode-mode MoE over int8 expert tables. For each of the
// T*k (token, j) pairs, token-major, row (t, j) of the result is
//   SwiGLU_{idx[t, j]}(x[t])   rounded once, to the model type
// through the int8 weight policy of moe_swiglu.cuh (dequantize with one fp32
// multiply, h kept fp32). Two passes, up and down, the ones grouped_swiglu_q.cu
// launches, so a pair's row is bitwise the grouped kernel's row. The result
// is [T, k, d]: the k rows are combined outside the kernel, as the TPU kernel
// leaves them (decode_moe.py :: gather_swiglu_q).
#include "moe_swiglu.cuh"

namespace moe {

template <typename T>
int gather_q(const void* x, const void* wg, const void* wu, const void* wd,
             const float* sg, const float* su, const float* sd, const int* idx,
             float* h, void* y, int T_, int E, int d, int f, int k,
             cudaStream_t stream) {
  const int n_pairs = T_ * k;
  PairLayout lay{idx, k, E, n_pairs};
  return launch_up_down<T, signed char, float, 1, PairLayout>(
      (const T*)x, (const signed char*)wg, (const signed char*)wu,
      (const signed char*)wd, sg, su, sd, h, (T*)y, lay, n_pairs, d, f, stream);
}

}  // namespace moe

// dtype (of x and y): 0 = float32, 1 = bfloat16. wg/wu/wd: int8; sg/su: fp32
// [E, f]; sd: fp32 [E, d]. idx: [T, k] int32 (clipped to [0, E) in the
// kernel). h: fp32 scratch [T*k, f]; y: the result [T, k, d]. Returns 0 or
// the cudaError_t of the refused launch; -1 for a bad dtype.
extern "C" int gather_swiglu_q_launch(const void* x, const void* wg,
                                      const void* wu, const void* wd,
                                      const float* sg, const float* su,
                                      const float* sd, const int* idx, float* h,
                                      void* y, int T, int E, int d, int f,
                                      int k, int dtype, void* stream) {
  if (T <= 0 || k <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return moe::gather_q<float>(x, wg, wu, wd, sg, su, sd, idx, h, y, T, E, d,
                                f, k, s);
  if (dtype == 1)
    return moe::gather_q<__nv_bfloat16>(x, wg, wu, wd, sg, su, sd, idx, h, y,
                                        T, E, d, f, k, s);
  return -1;
}

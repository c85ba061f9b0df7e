// grouped_swiglu_q: grouped_swiglu.cu over int8 expert tables with fp32
// per-(expert, output-channel) scales. The same two passes (moe_swiglu.cuh)
// with the int8 weight policy: each weight is dequantized with one fp32
// multiply by its output column's scale, and h stays fp32 between the passes,
// so the only rounding to the model type is the output's. A row's result is
// bitwise the one gather_swiglu_q.cu computes for the same (row, expert).
#include "moe_swiglu.cuh"

namespace moe {

template <typename T>
int grouped_q(const void* x, const void* wg, const void* wu, const void* wd,
              const float* sg, const float* su, const float* sd,
              const int* group_sizes, float* h, void* out, int T_, int E, int d,
              int f, int rows, cudaStream_t s) {
  return grouped_dispatch<T, signed char, float>(
      (const T*)x, (const signed char*)wg, (const signed char*)wu,
      (const signed char*)wd, sg, su, sd, group_sizes, h, (T*)out, T_, E, d, f,
      rows, s);
}

}  // namespace moe

// dtype (of x and out): 0 = float32, 1 = bfloat16. wg/wu/wd: int8; sg/su:
// fp32 [E, f]; sd: fp32 [E, d]. rows: 8, 4 or 1. h: fp32 scratch [T, f].
// Returns 0 or the cudaError_t of the refused launch; -1 / -2 for a bad
// dtype / rows.
extern "C" int grouped_swiglu_q_launch(const void* x, const void* wg,
                                       const void* wu, const void* wd,
                                       const float* sg, const float* su,
                                       const float* sd, const int* group_sizes,
                                       float* h, void* out, int T, int E, int d,
                                       int f, int rows, int dtype,
                                       void* stream) {
  if (T <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return moe::grouped_q<float>(x, wg, wu, wd, sg, su, sd, group_sizes, h, out,
                                 T, E, d, f, rows, s);
  if (dtype == 1)
    return moe::grouped_q<__nv_bfloat16>(x, wg, wu, wd, sg, su, sd, group_sizes,
                                         h, out, T, E, d, f, rows, s);
  return -1;
}

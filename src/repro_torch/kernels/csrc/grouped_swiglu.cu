// grouped_swiglu: rows sorted by expert; row r goes through the expert whose
// segment of group_sizes holds it. Two passes on one stream (up, down), the
// same ones gather_swiglu.cu launches (moe_swiglu.cuh); a block holds up to R
// rows of one expert so that every weight element it loads serves R rows.
#include "moe_swiglu.cuh"

namespace moe {

template <typename T>
int grouped_plain(const void* x, const void* wg, const void* wu, const void* wd,
                  const int* group_sizes, void* h, void* out, int T_, int E,
                  int d, int f, int rows, cudaStream_t s) {
  return grouped_dispatch<T, T, T>((const T*)x, (const T*)wg, (const T*)wu,
                                   (const T*)wd, nullptr, nullptr, nullptr,
                                   group_sizes, (T*)h, (T*)out, T_, E, d, f,
                                   rows, s);
}

}  // namespace moe

// dtype: 0 = float32, 1 = bfloat16. rows: rows per block, one of 8, 4, 1 (the
// wrapper picks the largest whose rows fit in shared memory). h: scratch
// [T, f]. Returns 0 or the cudaError_t of the refused launch; -1 / -2 for a
// bad dtype / rows.
extern "C" int grouped_swiglu_launch(const void* x, const void* wg,
                                     const void* wu, const void* wd,
                                     const int* group_sizes, void* h, void* out,
                                     int T, int E, int d, int f, int rows,
                                     int dtype, void* stream) {
  if (T <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return moe::grouped_plain<float>(x, wg, wu, wd, group_sizes, h, out, T, E,
                                     d, f, rows, s);
  if (dtype == 1)
    return moe::grouped_plain<__nv_bfloat16>(x, wg, wu, wd, group_sizes, h, out,
                                             T, E, d, f, rows, s);
  return -1;
}

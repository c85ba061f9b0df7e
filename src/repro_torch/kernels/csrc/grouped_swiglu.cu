// grouped_swiglu: rows sorted by expert; row r goes through the expert whose
// segment of group_sizes holds it. Two passes on one stream (up, down), the
// same ones gather_swiglu.cu launches (moe_swiglu.cuh); a block holds up to R
// rows of one expert so that every weight element it loads serves R rows.
#include "moe_swiglu.cuh"

namespace moe {

template <typename T, int R>
int grouped_launch(const void* x, const void* wg, const void* wu,
                   const void* wd, const int* group_sizes, void* h, void* out,
                   int T_, int E, int d, int f, cudaStream_t stream) {
  SegmentLayout lay{group_sizes, E, T_, R};
  // every expert can end in one partial block: ceil(T/R) + min(E, T) bounds
  // the number of blocks whatever the group sizes are
  const int n_blocks = ceil_div(T_, R) + (E < T_ ? E : T_);
  return launch_up_down<T, R, SegmentLayout>(
      (const T*)x, (const T*)wg, (const T*)wu, (const T*)wd, (T*)h, (T*)out,
      lay, n_blocks, d, f, stream);
}

template <typename T>
int grouped_dispatch(const void* x, const void* wg, const void* wu,
                     const void* wd, const int* group_sizes, void* h, void* out,
                     int T_, int E, int d, int f, int rows, cudaStream_t s) {
  switch (rows) {
    case 8:
      return grouped_launch<T, 8>(x, wg, wu, wd, group_sizes, h, out, T_, E, d, f, s);
    case 4:
      return grouped_launch<T, 4>(x, wg, wu, wd, group_sizes, h, out, T_, E, d, f, s);
    case 1:
      return grouped_launch<T, 1>(x, wg, wu, wd, group_sizes, h, out, T_, E, d, f, s);
    default:
      return -2;
  }
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
    return moe::grouped_dispatch<float>(x, wg, wu, wd, group_sizes, h, out, T,
                                        E, d, f, rows, s);
  if (dtype == 1)
    return moe::grouped_dispatch<__nv_bfloat16>(x, wg, wu, wd, group_sizes, h,
                                                out, T, E, d, f, rows, s);
  return -1;
}

// grouped_swiglu: rows sorted by expert; row r goes through the expert whose
// segment of group_sizes holds it. Two passes on one stream (up, down) and
// two routes, chosen by the wrapper (kernels/moe_tc.py :: route):
//   bf16, d and f multiples of 8: tensor cores (moe_tc_sm90.cuh,
//     grouped_swiglu_tc_launch). A block owns up to 64 rows of ONE segment
//     (SegmentLayout at R = 64: a zero-sized group contributes no block) and
//     one column tile, so each expert's tables stream from device memory once
//     per column tile;
//   anything else (fp32, odd widths): CUDA cores (moe_swiglu.cuh,
//     grouped_swiglu_launch), the passes gather_swiglu.cu launches too; a
//     block holds up to R rows of one expert so that every weight element it
//     loads serves R rows.
// Either way a row's bits are those the gather kernel of the same route gives
// the same (token, expert) pair.
#include "moe_swiglu.cuh"
#include "moe_tc_sm90.cuh"

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

namespace moetc {

// h[row] = round_bf16(silu(x_row . wg[e]) * (x_row . wu[e]))
// grid: (ceil(f / kUpBN), segment tiles)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
grouped_up_tc(const bf16* __restrict__ x, const bf16* __restrict__ wg,
              const bf16* __restrict__ wu, const int* __restrict__ group_sizes,
              bf16* __restrict__ h, int T, int E, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int rows[kBM];
  const moe::RowBlock rb = segment_rows(group_sizes, E, T, rows);
  if (rb.nrows == 0) return;
  const size_t off = (size_t)rb.expert * d * f;
  up_tile<kUpBN>(aligned_smem(smem_raw), x, d, Tile{rows, rows, rb.nrows},
                 wg + off, wu + off, h, f, blockIdx.x * kUpBN);
}

// y[row] = round_bf16(h_row . wd[e]); grid: (ceil(d / kDownBN), segment
// tiles)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
grouped_down_tc(const bf16* __restrict__ h, const bf16* __restrict__ wd,
                const int* __restrict__ group_sizes, bf16* __restrict__ y,
                int T, int E, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int rows[kBM];
  const moe::RowBlock rb = segment_rows(group_sizes, E, T, rows);
  if (rb.nrows == 0) return;
  down_tile<kDownBN>(aligned_smem(smem_raw), h, f, Tile{rows, rows, rb.nrows},
                     wd + (size_t)rb.expert * f * d, y, d,
                     blockIdx.x * kDownBN);
}

int grouped_tc(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wd,
               const int* group_sizes, bf16* h, bf16* out, int T, int E, int d,
               int f, cudaStream_t s) {
  int err = allow_ring<kUpBN, 2>(grouped_up_tc);
  if (err != 0) return err;
  err = allow_ring<kDownBN, 1>(grouped_down_tc);
  if (err != 0) return err;
  const int n_blocks = segment_tiles(T, E);
  grouped_up_tc<<<dim3(moe::ceil_div(f, kUpBN), n_blocks), kThreads,
                  Ring<kUpBN, 2>::kSmem, s>>>(x, wg, wu, group_sizes, h, T, E,
                                              d, f);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  grouped_down_tc<<<dim3(moe::ceil_div(d, kDownBN), n_blocks), kThreads,
                    Ring<kDownBN, 1>::kSmem, s>>>(h, wd, group_sizes, out, T,
                                                  E, d, f);
  return (int)cudaGetLastError();
}

}  // namespace moetc

// The CUDA-core route. dtype: 0 = float32, 1 = bfloat16. rows: rows per
// block, one of 8, 4, 1 (the wrapper picks the largest whose rows fit in
// shared memory). h: scratch [T, f]. Returns 0 or the cudaError_t of the
// refused launch; -1 / -2 for a bad dtype / rows.
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

// The tensor-core route: x [T, d], wg / wu [E, d, f], wd [E, f, d], h scratch
// [T, f], out [T, d], all bfloat16, contiguous and 16-byte aligned, d and f
// multiples of 8; group_sizes [E] int32. The tile plan (m_tile, up_n, down_n,
// k_tile, stages) must be the compiled one. Returns 0, the cudaError_t of a
// refused launch, or -2 for a plan or shape the kernels do not take.
extern "C" int grouped_swiglu_tc_launch(const void* x, const void* wg,
                                        const void* wu, const void* wd,
                                        const int* group_sizes, void* h,
                                        void* out, int T, int E, int d, int f,
                                        int m_tile, int up_n, int down_n,
                                        int k_tile, int stages, void* stream) {
  if (T <= 0) return 0;
  if (E < 1 || !moetc::plan_ok(m_tile, up_n, down_n, k_tile, stages, d, f))
    return moetc::kBadPlan;
  using moetc::bf16;
  return moetc::grouped_tc((const bf16*)x, (const bf16*)wg, (const bf16*)wu,
                           (const bf16*)wd, group_sizes, (bf16*)h, (bf16*)out,
                           T, E, d, f, (cudaStream_t)stream);
}

// grouped_swiglu_q: grouped_swiglu.cu over int8 expert tables with fp32
// per-(expert, output-channel) scales: rows sorted by expert; row r goes
// through the expert whose segment of group_sizes holds it; two passes on one
// stream (up, down) and two routes, chosen by the wrapper (kernels/moe_tc.py
// :: route_q):
//   bf16 x, d and f multiples of 16: tensor cores (moe_tc_sm90.cuh,
//     grouped_swiglu_q_tc_launch) on grouped_swiglu.cu's segment tiles: a
//     block owns up to 64 rows of ONE segment (SegmentLayout at R = 64: a
//     zero-sized group contributes no block) and one column tile, so each
//     expert's int8 tables stream once per column tile, widened to bf16 for
//     wgmma; the scales are applied after the sums, and h crosses the passes
//     as a bf16 hi + lo pair (the int8 contract of moe_tc_sm90.cuh);
//   anything else (fp32 x, other widths): CUDA cores (moe_swiglu.cuh,
//     grouped_swiglu_q_launch): each weight dequantized with one fp32
//     multiply by its output column's scale, h kept fp32 between the passes.
// Either way the only rounding to the model type is the output's, and a
// row's result is bitwise the one gather_swiglu_q.cu computes on the same
// route for the same (row, expert).
#include "moe_swiglu.cuh"
#include "moe_tc_sm90.cuh"

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

namespace moetc {

// hi / lo[row] = the split of silu(g) * u for x_row through its segment's
// expert; grid: (ceil(f / kUpBN), segment tiles)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
grouped_up_q_tc(const bf16* __restrict__ x, const i8* __restrict__ qg,
                const i8* __restrict__ qu, const float* __restrict__ sg,
                const float* __restrict__ su,
                const int* __restrict__ group_sizes, bf16* __restrict__ hi,
                bf16* __restrict__ lo, int T, int E, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int rows[kBM];
  __shared__ float sc[2][kUpBN];
  const moe::RowBlock rb = segment_rows(group_sizes, E, T, rows);
  if (rb.nrows == 0) return;
  const int n0 = blockIdx.x * kUpBN;
  const size_t off = (size_t)rb.expert * d * f;
  load_scales<kUpBN>(sc[0], sg + (size_t)rb.expert * f, f, n0);
  load_scales<kUpBN>(sc[1], su + (size_t)rb.expert * f, f, n0);
  up_tile_q<kUpBN>(aligned_smem(smem_raw), x, d, Tile{rows, rows, rb.nrows},
                   qg + off, qu + off, sc, hi, lo, f, n0);
}

// y[row] = round_bf16(sd * (hi_row . qd[e] + lo_row . qd[e])); grid:
// (ceil(d / kDownBN), segment tiles)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
grouped_down_q_tc(const bf16* __restrict__ hi, const bf16* __restrict__ lo,
                  const i8* __restrict__ qd, const float* __restrict__ sd,
                  const int* __restrict__ group_sizes, bf16* __restrict__ y,
                  int T, int E, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int rows[kBM];
  __shared__ float sc[1][kDownBN];
  const moe::RowBlock rb = segment_rows(group_sizes, E, T, rows);
  if (rb.nrows == 0) return;
  const int n0 = blockIdx.x * kDownBN;
  load_scales<kDownBN>(sc[0], sd + (size_t)rb.expert * d, d, n0);
  down_tile_q<kDownBN>(aligned_smem(smem_raw), hi, lo, f,
                       Tile{rows, rows, rb.nrows},
                       qd + (size_t)rb.expert * f * d, sc, y, d, n0);
}

int grouped_q_tc(const bf16* x, const i8* qg, const i8* qu, const i8* qd,
                 const float* sg, const float* su, const float* sd,
                 const int* group_sizes, bf16* hi, bf16* lo, bf16* out, int T,
                 int E, int d, int f, cudaStream_t s) {
  int err = allow_ring<kUpBN, 2, i8, 1>(grouped_up_q_tc);
  if (err != 0) return err;
  err = allow_ring<kDownBN, 1, i8, 2>(grouped_down_q_tc);
  if (err != 0) return err;
  const int n_blocks = segment_tiles(T, E);
  grouped_up_q_tc<<<dim3(moe::ceil_div(f, kUpBN), n_blocks), kThreads,
                    Ring<kUpBN, 2, i8, 1>::kSmem, s>>>(
      x, qg, qu, sg, su, group_sizes, hi, lo, T, E, d, f);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  grouped_down_q_tc<<<dim3(moe::ceil_div(d, kDownBN), n_blocks), kThreads,
                      Ring<kDownBN, 1, i8, 2>::kSmem, s>>>(
      hi, lo, qd, sd, group_sizes, out, T, E, d, f);
  return (int)cudaGetLastError();
}

}  // namespace moetc

// The CUDA-core route. dtype (of x and out): 0 = float32, 1 = bfloat16.
// wg/wu/wd: int8; sg/su: fp32 [E, f]; sd: fp32 [E, d]. rows: 8, 4 or 1. h:
// fp32 scratch [T, f]. Returns 0 or the cudaError_t of the refused launch;
// -1 / -2 for a bad dtype / rows.
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

// The tensor-core route: x [T, d] bfloat16; wg / wu int8 [E, d, f], wd int8
// [E, f, d]; sg / su fp32 [E, f], sd fp32 [E, d]; group_sizes [E] int32;
// hi / lo bfloat16 scratch [T, f]; out [T, d] bfloat16; all contiguous and
// 16-byte aligned, d and f multiples of 16. The tile plan (m_tile, up_n,
// down_n, k_tile, stages) must be the compiled one. Returns 0, the
// cudaError_t of a refused launch, or -2 for a plan or shape the kernels do
// not take.
extern "C" int grouped_swiglu_q_tc_launch(
    const void* x, const void* wg, const void* wu, const void* wd,
    const float* sg, const float* su, const float* sd, const int* group_sizes,
    void* hi, void* lo, void* out, int T, int E, int d, int f, int m_tile,
    int up_n, int down_n, int k_tile, int stages, void* stream) {
  if (T <= 0) return 0;
  if (E < 1 ||
      !moetc::plan_ok(m_tile, up_n, down_n, k_tile, stages, d, f, true))
    return moetc::kBadPlan;
  using moetc::bf16;
  using moetc::i8;
  return moetc::grouped_q_tc((const bf16*)x, (const i8*)wg, (const i8*)wu,
                             (const i8*)wd, sg, su, sd, group_sizes, (bf16*)hi,
                             (bf16*)lo, (bf16*)out, T, E, d, f,
                             (cudaStream_t)stream);
}

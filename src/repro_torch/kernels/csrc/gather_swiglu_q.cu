// gather_swiglu_q: decode-mode MoE over int8 expert tables (fp32 scales per
// (expert, output column)). For each of the T*k (token, j) pairs,
// token-major, row (t, j) of the per-pair result is
//   SwiGLU_{idx[t, j]}(x[t])   rounded once, to the model type
// emitted as [T, k, d] as the TPU kernel leaves it (decode_moe.py ::
// gather_swiglu_q), and optionally combined in slot order on the card on
// either route (moe_swiglu.cuh :: combine_kernel, bitwise kernels/ref.py ::
// combine_in_order). Two routes for the up and down passes, chosen by the
// wrapper (kernels/moe_tc.py :: route_q), each the one grouped_swiglu_q.cu
// launches for the same route, so a pair's row is bitwise the grouped
// kernel's row:
//   bf16 x, d and f multiples of 16: tensor cores (moe_tc_sm90.cuh,
//     gather_swiglu_q_tc_launch) on gather_swiglu.cu's EXPERT-MAJOR grid:
//     block (column tile, e) collects the pairs whose clipped id is e in
//     ascending pair order, 64 rows a tile, and exits at once if there are
//     none. The int8 tiles stream through the cp.async ring at half the bf16
//     tiles' bytes and are widened to bf16 for wgmma; the scales are applied
//     after the sums, and h crosses the passes as a bf16 hi + lo pair (the
//     int8 contract of moe_tc_sm90.cuh);
//   anything else (fp32 x, other widths): CUDA cores (moe_swiglu.cuh,
//     gather_swiglu_q_launch), one block per pair (PairLayout), each weight
//     dequantized with one fp32 multiply and h kept fp32.
#include "moe_swiglu.cuh"
#include "moe_tc_sm90.cuh"

namespace moe {

template <typename T>
int gather_q(const void* x, const void* wg, const void* wu, const void* wd,
             const float* sg, const float* su, const float* sd, const int* idx,
             const float* w, float* h, void* y, void* out, int T_, int E, int d,
             int f, int k, cudaStream_t stream) {
  const int n_pairs = T_ * k;
  PairLayout lay{idx, k, E, n_pairs};
  int err = launch_up_down<T, signed char, float, 1, PairLayout>(
      (const T*)x, (const signed char*)wg, (const signed char*)wu,
      (const signed char*)wd, sg, su, sd, h, (T*)y, lay, n_pairs, d, f, stream);
  if (err != 0 || out == nullptr) return err;
  return combine_launch<T>((const T*)y, w, (T*)out, T_, d, k, stream);
}

}  // namespace moe

namespace moetc {

// hi / lo[pair] = the split of silu(g) * u for x[pair / k] through expert e =
// blockIdx.y; grid: (ceil(f / kUpBN), E)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gather_up_q_tc(const bf16* __restrict__ x, const i8* __restrict__ qg,
               const i8* __restrict__ qu, const float* __restrict__ sg,
               const float* __restrict__ su, const int* __restrict__ idx,
               bf16* __restrict__ hi, bf16* __restrict__ lo, int n_pairs,
               int k, int E, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int list[kBM + kThreads];
  __shared__ int x_row[kBM];
  __shared__ int warp_n[kThreads / 32];
  __shared__ float sc[2][kUpBN];
  const int e = blockIdx.y, n0 = blockIdx.x * kUpBN;
  const size_t off = (size_t)e * d * f;
  load_scales<kUpBN>(sc[0], sg + (size_t)e * f, f, n0);
  load_scales<kUpBN>(sc[1], su + (size_t)e * f, f, n0);
  char* smem = aligned_smem(smem_raw);
  for_each_pair_tile(idx, n_pairs, E, e, list, warp_n, [&](int n) {
    if (threadIdx.x < n) x_row[threadIdx.x] = list[threadIdx.x] / k;
    __syncthreads();
    up_tile_q<kUpBN>(smem, x, d, Tile{x_row, list, n}, qg + off, qu + off, sc,
                     hi, lo, f, n0);
    __syncthreads();
  });
}

// y[pair] = round_bf16(sd * (hi[pair] . qd[e] + lo[pair] . qd[e])) for the
// pairs of expert e = blockIdx.y; grid: (ceil(d / kDownBN), E)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gather_down_q_tc(const bf16* __restrict__ hi, const bf16* __restrict__ lo,
                 const i8* __restrict__ qd, const float* __restrict__ sd,
                 const int* __restrict__ idx, bf16* __restrict__ y,
                 int n_pairs, int E, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int list[kBM + kThreads];
  __shared__ int warp_n[kThreads / 32];
  __shared__ float sc[1][kDownBN];
  const int e = blockIdx.y, n0 = blockIdx.x * kDownBN;
  load_scales<kDownBN>(sc[0], sd + (size_t)e * d, d, n0);
  const i8* qd_e = qd + (size_t)e * f * d;
  char* smem = aligned_smem(smem_raw);
  for_each_pair_tile(idx, n_pairs, E, e, list, warp_n, [&](int n) {
    down_tile_q<kDownBN>(smem, hi, lo, f, Tile{list, list, n}, qd_e, sc, y, d,
                         n0);
    __syncthreads();
  });
}

int gather_q_tc(const bf16* x, const i8* qg, const i8* qu, const i8* qd,
                const float* sg, const float* su, const float* sd,
                const int* idx, const float* w, bf16* hi, bf16* lo, bf16* y,
                bf16* out, int T, int E, int d, int f, int k, cudaStream_t s) {
  int err = allow_ring<kUpBN, 2, i8, 1>(gather_up_q_tc);
  if (err != 0) return err;
  err = allow_ring<kDownBN, 1, i8, 2>(gather_down_q_tc);
  if (err != 0) return err;
  const int n_pairs = T * k;
  gather_up_q_tc<<<dim3(moe::ceil_div(f, kUpBN), E), kThreads,
                   Ring<kUpBN, 2, i8, 1>::kSmem, s>>>(x, qg, qu, sg, su, idx,
                                                      hi, lo, n_pairs, k, E, d,
                                                      f);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  gather_down_q_tc<<<dim3(moe::ceil_div(d, kDownBN), E), kThreads,
                     Ring<kDownBN, 1, i8, 2>::kSmem, s>>>(hi, lo, qd, sd, idx,
                                                          y, n_pairs, E, d, f);
  err = (int)cudaGetLastError();
  if (err != 0 || out == nullptr) return err;
  return moe::combine_launch<bf16>(y, w, out, T, d, k, s);
}

}  // namespace moetc

// The CUDA-core route. dtype (of x and y): 0 = float32, 1 = bfloat16.
// wg/wu/wd: int8; sg/su: fp32 [E, f]; sd: fp32 [E, d]. idx: [T, k] int32
// (clipped to [0, E) in the kernel). h: fp32 scratch [T*k, f]; y: the result
// [T, k, d]. With w ([T, k] fp32) and out ([T, d] in x's type) both given,
// the rows are combined into out in slot order; with both null, only y is
// written. Returns 0 or the cudaError_t of the refused launch; -1 for a bad
// dtype or a w without an out.
extern "C" int gather_swiglu_q_launch(const void* x, const void* wg,
                                      const void* wu, const void* wd,
                                      const float* sg, const float* su,
                                      const float* sd, const int* idx,
                                      const float* w, float* h, void* y,
                                      void* out, int T, int E, int d, int f,
                                      int k, int dtype, void* stream) {
  if (T <= 0 || k <= 0) return 0;
  if ((w == nullptr) != (out == nullptr)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return moe::gather_q<float>(x, wg, wu, wd, sg, su, sd, idx, w, h, y, out,
                                T, E, d, f, k, s);
  if (dtype == 1)
    return moe::gather_q<__nv_bfloat16>(x, wg, wu, wd, sg, su, sd, idx, w, h,
                                        y, out, T, E, d, f, k, s);
  return -1;
}

// The tensor-core route: x [T, d] bfloat16; wg / wu int8 [E, d, f], wd int8
// [E, f, d]; sg / su fp32 [E, f], sd fp32 [E, d]; idx [T, k] int32; hi / lo
// bfloat16 scratch [T*k, f]; y the per-pair rows [T, k, d] bfloat16; all
// contiguous and 16-byte aligned, d and f multiples of 16. With w ([T, k]
// fp32) and out ([T, d] bfloat16) both given, the rows are combined into out
// in slot order; with both null, only y is written. The tile plan (m_tile,
// up_n, down_n, k_tile, stages) must be the compiled one. Returns 0, the
// cudaError_t of a refused launch, or -2 for a plan or shape the kernels do
// not take.
extern "C" int gather_swiglu_q_tc_launch(
    const void* x, const void* wg, const void* wu, const void* wd,
    const float* sg, const float* su, const float* sd, const int* idx,
    const float* w, void* hi, void* lo, void* y, void* out, int T, int E, int d,
    int f, int k, int m_tile, int up_n, int down_n, int k_tile, int stages,
    void* stream) {
  if (T <= 0 || k <= 0) return 0;
  if (E < 1 || (w == nullptr) != (out == nullptr) ||
      !moetc::plan_ok(m_tile, up_n, down_n, k_tile, stages, d, f, true))
    return moetc::kBadPlan;
  using moetc::bf16;
  using moetc::i8;
  return moetc::gather_q_tc((const bf16*)x, (const i8*)wg, (const i8*)wu,
                            (const i8*)wd, sg, su, sd, idx, w, (bf16*)hi,
                            (bf16*)lo, (bf16*)y, (bf16*)out, T, E, d, f, k,
                            (cudaStream_t)stream);
}

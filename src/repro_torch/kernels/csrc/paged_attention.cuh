// Paged decode attention on Hopper (sm_90a): the body shared by
// paged_attention.cu (pools in the model type) and paged_attention_q.cu (int8
// pools with per-(row, head) fp32 scales).
//
// Replaces the TPU kernels repro/kernels/paged_attention.py :: paged_attention
// and paged_attention_q, whose grid (B, max_blocks) carries the online-softmax
// state from one table entry to the next in VMEM. Blocks on this card run in no
// order, so the sequential axis becomes a loop inside one block:
//
//   block (b, g) = one slot and one kv head; warp w = query head g * n_rep + w.
//   The block walks the slot's table entries j < ceil(lens[b] / bs) in order.
//   For each entry it stages the valid rows of that pool block (head g) in
//   shared memory as fp32 (int8: one fp32 multiply by the row's scale), once
//   for all n_rep query heads. Lane l of a warp computes the logit of row l
//   (q . k / sqrt(hd), fp32); the warp then updates its running max m, its
//   normaliser l and its fp32 accumulator (each lane owns hd / 32 columns).
//
// Table entries >= n_blocks (sentinels) are clipped to n_blocks - 1. Rows at or
// past lens[b] are never loaded and never enter a sum, so whatever a clipped or
// stale block holds (even inf or nan) contributes exactly nothing. A slot with
// lens == 0 has l == 0 and returns zeros (the TPU kernel's l == 0 guard).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace paged {

constexpr int kWarp = 32;
constexpr int kMaxCols = 8;  // hd <= 256: at most 8 columns per lane

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16_rn(v);
  }
};

// One pool element as fp32: widened, or (int8) times its row's scale.
template <typename P>
struct Pool {
  static __device__ __forceinline__ float load(const P* p, size_t i,
                                               const float*, size_t) {
    return Num<P>::to_f32(p[i]);
  }
};

template <>
struct Pool<signed char> {
  static __device__ __forceinline__ float load(const signed char* p, size_t i,
                                               const float* s, size_t si) {
    return __fmul_rn((float)p[i], s[si]);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q: [B, nq, hd]; kp/vp: [nb, bs, nkv, hd]; ks/vs: [nb, bs, nkv] (int8 only);
// tab: [B, mb]; lens: [B]; out: [B, nq, hd]. grid (B, nkv), n_rep warps.
// Shared memory: q [n_rep][hd], K [bs][hd + 1] (padded: lane l reads row l),
// V [bs][hd], all fp32.
template <typename T, typename P>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const P* __restrict__ kp, const P* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ tab, const int* __restrict__ lens,
    T* __restrict__ out, int nb, int bs, int nkv, int hd, int mb, int n_rep,
    float sqrt_hd) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [n_rep][hd]
  float* kt = qs + n_rep * hd;               // [bs][hd + 1]
  float* vt = kt + bs * (hd + 1);            // [bs][hd]
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int nq = nkv * n_rep;
  const size_t q0 = ((size_t)b * nq + (size_t)g * n_rep) * hd;
  for (int i = threadIdx.x; i < n_rep * hd; i += blockDim.x)
    qs[i] = Num<T>::to_f32(q[q0 + i]);

  const int len = lens[b] > 0 ? lens[b] : 0;
  const int n_entries = min((len + bs - 1) / bs, mb);
  const float* qw = qs + warp * hd;
  float m = -INFINITY;
  float l = 0.0f;
  float acc[kMaxCols];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) acc[i] = 0.0f;

  for (int j = 0; j < n_entries; ++j) {
    const int blk = min(max(tab[(size_t)b * mb + j], 0), nb - 1);
    const int nvalid = min(bs, len - j * bs);
    __syncthreads();  // the previous entry's rows are consumed (and q staged)
    for (int i = threadIdx.x; i < nvalid * hd; i += blockDim.x) {
      const int r = i / hd;
      const int c = i % hd;
      const size_t row = ((size_t)blk * bs + r) * nkv + g;
      kt[r * (hd + 1) + c] = Pool<P>::load(kp, row * hd + c, ks, row);
      vt[r * hd + c] = Pool<P>::load(vp, row * hd + c, vs, row);
    }
    __syncthreads();
    for (int r0 = 0; r0 < nvalid; r0 += kWarp) {
      const int r = r0 + lane;
      float s = -INFINITY;
      if (r < nvalid) {
        const float* kr = kt + r * (hd + 1);
        float dot = 0.0f;
        for (int c = 0; c < hd; ++c) dot = fmaf(qw[c], kr[c], dot);
        s = __fdiv_rn(dot, sqrt_hd);
      }
      const float m_new = fmaxf(m, warp_max(s));     // row r0 is valid: finite
      const float p = r < nvalid ? expf(s - m_new) : 0.0f;
      const float alpha = expf(m - m_new);           // 0 on the first update
      l = l * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < kMaxCols; ++i) acc[i] *= alpha;
      const int n_here = min(kWarp, nvalid - r0);
      for (int rr = 0; rr < n_here; ++rr) {
        const float pr = __shfl_sync(0xffffffffu, p, rr);   // the whole warp
        const float* vr = vt + (r0 + rr) * hd;
#pragma unroll
        for (int i = 0; i < kMaxCols; ++i) {
          const int c = lane + i * kWarp;
          if (c < hd) acc[i] = fmaf(pr, vr[c], acc[i]);
        }
      }
      m = m_new;
    }
  }
  const float denom = l == 0.0f ? 1.0f : l;
  const size_t o0 = ((size_t)b * nq + (size_t)g * n_rep + warp) * hd;
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) {
    const int c = lane + i * kWarp;
    if (c < hd) out[o0 + c] = Num<T>::from_f32(__fdiv_rn(acc[i], denom));
  }
}

inline size_t smem_bytes(int n_rep, int bs, int hd) {
  return ((size_t)n_rep * hd + (size_t)bs * (hd + 1) + (size_t)bs * hd) *
         sizeof(float);
}

// Returns 0 or the cudaError_t of the refused launch.
template <typename T, typename P>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* tab, const int* lens, void* out, int B,
           int nb, int bs, int nkv, int hd, int mb, int n_rep, float sqrt_hd,
           cudaStream_t stream) {
  if (B <= 0 || nkv <= 0) return 0;
  const size_t smem = smem_bytes(n_rep, bs, hd);
  auto k = paged_attention_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k<<<dim3(B, nkv), n_rep * kWarp, smem, stream>>>(
      (const T*)q, (const P*)kp, (const P*)vp, ks, vs, tab, lens, (T*)out, nb,
      bs, nkv, hd, mb, n_rep, sqrt_hd);
  return (int)cudaGetLastError();
}

}  // namespace paged

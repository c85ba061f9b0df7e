// flash_attention: full-sequence attention with an online softmax on Hopper
// (sm_90a). Replaces repro/kernels/flash_attention.py :: flash_attention
// (_kernel), whose grid (B*H, Sq/bq, Sk/bk) carries the running max, the
// normaliser and the fp32 accumulator of a query tile from one kv block to the
// next in VMEM. Blocks on this card run in no order, so the kv axis becomes a
// loop inside one block:
//
//   block (tile, h, b) = 64 query rows of one head; 8 warps, warp w owns rows
//   w, w + 8, ... of the tile. The block walks the key tiles of kBK = 64 keys
//   from key 0 (key tiles are aligned at absolute key positions), stages each
//   tile's K and V rows in shared memory as fp32 once for all 64 rows, and
//   every warp updates the state of each of its rows (running max m,
//   normaliser l, fp32 accumulator; kept in shared memory between tiles) one
//   32-key chunk at a time: lane l computes the logit of key l of the chunk,
//   s = (q . k) * scale in fp32 (fmaf in column order), then
//   m' = max(m, max s), p = exp(s - m'), l = l exp(m - m') + sum p, and
//   acc = acc exp(m - m') + sum round_T(p) v, each lane owning hd / 32
//   columns. One division by l at the end (l == 0 -> 1), output in q's type.
//
// Causal: query row i of batch row b sits at position qoff[b] + i (qoff ==
// null: Sk - Sq, the oracle's bottom-right alignment) and sees the keys at
// positions <= that; the block stops at the last key any of its rows sees
// (fully masked key tiles are skipped), and a row stops at its own last key.
// A row that sees no key at all (causal with Sq > Sk) gets the oracle's
// answer for a fully masked row: every key with equal weight. A key a row
// does not see never enters a sum, so a row's result depends only on its
// position and the keys it sees, never on B, Sq, or which tile holds it: the
// chunks are the same absolute 32-key ranges, reduced in the same order.
//
// GQA: head h reads kv head h / n_rep, so the model path need not expand K/V.
// q, k, v and out are addressed through strides (in elements; the last axis
// contiguous), so [B, S, H, hd] activations are read without a transposed copy.
//
// What bounds it on this card: at the shapes of this port (S <= 512, hd 128)
// the work is small and the kernel is bound by its own fp32 CUDA-core
// arithmetic and shared-memory traffic, far from both the byte bound and the
// tensor cores. Tensor cores (wgmma), TMA and a split-K walk are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace flash {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kBQ = 64;      // query rows per block
constexpr int kBK = 64;      // keys per staged tile (a multiple of kWarp)
constexpr int kMaxCols = 8;  // hd <= 256: at most 8 columns per lane

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
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

struct Strides {
  long long b, h, s;
};

// Shared memory (fp32): K tile [kBK][hd + 1] (padded: lane l reads row l),
// V tile [kBK][hd], q rows [kBQ][hd], accumulators [kBQ][hd], m [kBQ], l [kBQ].
template <typename T>
__global__ void __launch_bounds__(kWarps * kWarp)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             const int* __restrict__ qoff, int Sq, int Sk, int hd, int n_rep,
             Strides qs, Strides ks, Strides vs, Strides os, int causal,
             float scale) {
  extern __shared__ float smem[];
  float* kt = smem;
  float* vt = kt + kBK * (hd + 1);
  float* qt = vt + kBK * hd;
  float* at = qt + kBQ * hd;
  float* mt = at + kBQ * hd;
  float* lt = mt + kBQ;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / n_rep;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int rows = min(kBQ, Sq - q0);
  const int off = qoff != nullptr ? qoff[b] : Sk - Sq;

  const T* qb = q + b * qs.b + h * qs.h;
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd;
    const int c = i % hd;
    qt[r * hd + c] = Num<T>::to_f32(qb[(q0 + r) * qs.s + c]);
    at[r * hd + c] = 0.0f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    mt[r] = -INFINITY;
    lt[r] = 0.0f;
  }
  // the keys this tile needs: up to the last key its last row sees, or all
  // of them when a row sees none (equal weights over every key)
  int n_keys = Sk;
  if (causal) {
    const int first_last = q0 + off;               // row 0's last key
    const int tile_last = q0 + rows - 1 + off;     // the tile's last row's
    n_keys = first_last < 0 ? Sk : min(Sk, tile_last + 1);
  }
  const T* kb = k + b * ks.b + g * ks.h;
  const T* vb = v + b * vs.b + g * vs.h;

  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    const int nk = min(kBK, n_keys - k0);
    __syncthreads();  // the previous tile is consumed (and q staged)
    for (int i = threadIdx.x; i < nk * hd; i += blockDim.x) {
      const int r = i / hd;
      const int c = i % hd;
      kt[r * (hd + 1) + c] = Num<T>::to_f32(kb[(k0 + r) * ks.s + c]);
      vt[r * hd + c] = Num<T>::to_f32(vb[(k0 + r) * vs.s + c]);
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      int last = causal ? q0 + r + off : Sk - 1;   // the row's last key
      const bool uniform = last < 0;               // sees no key at all
      if (uniform || last > Sk - 1) last = Sk - 1;
      if (k0 > last) continue;
      const float* qr = qt + r * hd;
      float* ar = at + r * hd;
      float m = mt[r];
      float l = lt[r];
      float acc[kMaxCols];
#pragma unroll
      for (int i = 0; i < kMaxCols; ++i) {
        const int c = lane + i * kWarp;
        acc[i] = c < hd ? ar[c] : 0.0f;
      }
      for (int c0 = 0; c0 < nk && k0 + c0 <= last; c0 += kWarp) {
        const int key = k0 + c0 + lane;
        const bool vis = c0 + lane < nk && key <= last;
        float s = -INFINITY;
        if (vis) {
          const float* kr = kt + (c0 + lane) * (hd + 1);
          float dot = 0.0f;
          for (int c = 0; c < hd; ++c) dot = fmaf(qr[c], kr[c], dot);
          s = uniform ? 0.0f : dot * scale;
        }
        const float m_new = fmaxf(m, warp_max(s));  // key k0 + c0 is seen
        const float p = vis ? expf(s - m_new) : 0.0f;
        const float alpha = expf(m - m_new);        // 0 on the first update
        l = l * alpha + warp_sum(p);
        const float pv = Num<T>::round(p);          // p in v's type
#pragma unroll
        for (int i = 0; i < kMaxCols; ++i) acc[i] *= alpha;
        const int n_vis = min(min(kWarp, nk - c0), last - (k0 + c0) + 1);
        for (int rr = 0; rr < n_vis; ++rr) {
          const float pr = __shfl_sync(0xffffffffu, pv, rr);
          const float* vr = vt + (c0 + rr) * hd;
#pragma unroll
          for (int i = 0; i < kMaxCols; ++i) {
            const int c = lane + i * kWarp;
            if (c < hd) acc[i] = fmaf(pr, vr[c], acc[i]);
          }
        }
        m = m_new;
      }
#pragma unroll
      for (int i = 0; i < kMaxCols; ++i) {
        const int c = lane + i * kWarp;
        if (c < hd) ar[c] = acc[i];
      }
      if (lane == 0) {
        mt[r] = m;
        lt[r] = l;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  T* ob = out + b * os.b + h * os.h;
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd;
    const int c = i % hd;
    const float l = lt[r];
    ob[(q0 + r) * os.s + c] =
        Num<T>::from_f32(__fdiv_rn(at[r * hd + c], l == 0.0f ? 1.0f : l));
  }
}

inline size_t smem_bytes(int hd) {
  return ((size_t)kBK * (hd + 1) + (size_t)kBK * hd + 2 * (size_t)kBQ * hd +
          2 * (size_t)kBQ) *
         sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* qoff, int B, int H, int Sq, int Sk, int hd, int n_rep,
           const long long* st, int causal, float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  const size_t smem = smem_bytes(hd);
  auto kern = flash_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kWarps * kWarp, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, qoff, Sq, Sk, hd, n_rep,
      qs, ks, vs, os, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

// dtype (of q, k, v and out): 0 = float32, 1 = bfloat16. q / out: [B, H, Sq,
// hd], k / v: [B, H / n_rep, Sk, hd], each addressed through `strides`: 12
// int64 (b, h, s) element strides of q, k, v, out in that order, the last axis
// contiguous. qoff: [B] int32 query offsets for the causal mask, or null.
// Returns 0 or the cudaError_t of the refused launch; -1 for a bad dtype.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      const int* qoff, const long long* strides,
                                      int B, int H, int Sq, int Sk, int hd,
                                      int n_rep, int causal, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return flash::launch<float>(q, k, v, out, qoff, B, H, Sq, Sk, hd, n_rep,
                                strides, causal, scale, s);
  if (dtype == 1)
    return flash::launch<__nv_bfloat16>(q, k, v, out, qoff, B, H, Sq, Sk, hd,
                                        n_rep, strides, causal, scale, s);
  return -1;
}

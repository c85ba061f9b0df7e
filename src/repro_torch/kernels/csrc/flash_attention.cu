// flash_attention: full-sequence attention with an online softmax on Hopper
// (sm_90a). Replaces repro/kernels/flash_attention.py :: flash_attention
// (_kernel), whose grid (B*H, Sq/bq, Sk/bk) carries the running max, the
// normaliser and the fp32 accumulator of a query tile from one kv block to the
// next in VMEM. Blocks on this card run in no order, so the kv axis becomes a
// loop inside one block. Two routes, chosen by the wrapper from the dtype
// (kernels/flash_attention.py :: route), each with its own C entry point.
//
// Shared by both. Causal: query row i of batch row b sits at position
// qoff[b] + i (qoff == null: Sk - Sq, the oracle's bottom-right alignment) and
// sees the keys at positions <= that; the block stops at the last key any of
// its rows sees (fully masked key tiles are skipped), and a row's state does
// not move past its own last key. A row that sees no key at all (causal with
// Sq > Sk) gets the oracle's answer for a fully masked row: every key with
// equal weight. Key tiles are aligned at absolute key positions and walked in
// order; a key a row does not see contributes exactly 0 and the row max is
// taken over the keys it sees, so a row's result depends only on its position
// and the keys it sees, never on B, Sq, or which tile holds it. p is rounded
// to the input type before the value product; one division by l at the end
// (l == 0 -> 1), output in q's type. GQA: head h reads kv head h / n_rep, so
// the model path need not expand K/V. q, k, v and out are addressed through
// strides (in elements; the last axis contiguous), so [B, S, H, hd]
// activations are read without a transposed copy.
//
// bf16, tensor cores (namespace flash_tc, flash_attention_tc_launch),
// FlashAttention-2 style: block (tile, h, b) = 64 query rows of one head, 4
// warps, warp w owns rows 16w .. 16w + 15. Q and the K/V tiles of kBK = 64
// keys sit in shared memory as bf16; the K/V tiles are double-buffered by
// 16-byte cp.async, the next tile landing while the current one is consumed.
// S = Q K^T and O += P V run on mma.m16n8k16 (bf16 in, fp32 accumulate; V
// through ldmatrix.trans); the S accumulators become P's A fragments in
// registers. The running max and sum of a row stay in the registers of the
// quad that holds it, reduced by shuffles. hd a multiple of 8 from 8 to 256,
// the kernel compiled for 16, 32, 64, 128 and 256 columns: a narrower hd runs
// the next width, its tiles' columns [hd, HD) zero-filled by the copies (a
// row of hd values is hd / 8 whole 16-byte copies), so the S = Q K^T steps
// stop at the first k16 step past hd and an hd that is an odd multiple of 8
// ends on 8 exact zeros; P V's 8-wide n-tiles cover hd as they are and the
// columns past hd are never stored. What bounds it:
// at the port's shapes (S up to 512, hd 128) neither bytes nor operations but
// latency: one wave of short blocks.
//
// fp32, CUDA cores (namespace flash, flash_attention_launch): on tensor cores
// fp32 would become TF32, so fp32 keeps this kernel: 8 warps, warp w owns rows
// w, w + 8, ... of the tile; K/V tiles staged in shared memory as fp32; every
// warp updates the state of each of its rows (kept in shared memory between
// tiles) one 32-key chunk at a time: lane l computes the logit of key l of the
// chunk, s = (q . k) * scale in fp32 (fmaf in column order), then
// m' = max(m, max s), p = exp(s - m'), l = l exp(m - m') + sum p, and
// acc = acc exp(m - m') + sum round_T(p) v, each lane owning hd / 32 columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "tc_sm90.cuh"

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

namespace flash_tc {

using tc::bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kStages = 2;        // K/V tiles double-buffered (a third
                                  // stage costs the second block an SM)

// Row pitch of the shared tiles, in bf16: HD + 8 keeps the 8 rows of every
// ldmatrix on distinct banks.
template <int HD>
__host__ __device__ constexpr int pitch() {
  return HD + 8;
}

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(kBQ + 2 * kStages * kBK) * pitch<HD>() * sizeof(bf16);
}

// Rows [r0, r0 + 64) of a [rows, hd] slice (row stride ld) into a [64][pitch]
// tile; rows >= n and columns >= hd zero-filled.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          long long ld, int r0, int n,
                                          int hd) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r0 + r < n && c < hd;
    tc::cp_async16(dst + r * pitch<HD>() + c,
                   ok ? base + (r0 + r) * ld + c : base, ok);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// grid: (ceil(Sq / kBQ), H, B); shared memory: smem_bytes<HD>().
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out,
                const int* __restrict__ qoff, int Sq, int Sk, int hd,
                int n_rep, flash::Strides qs, flash::Strides ks,
                flash::Strides vs, flash::Strides os, int causal,
                float scale) {
  constexpr int P = pitch<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * P;            // [kStages][kBK][P]
  bf16* Vs = Ks + kStages * kBK * P;  // [kStages][kBK][P]
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / n_rep;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows = min(kBQ, Sq - q0);
  const int off = qoff != nullptr ? qoff[b] : Sk - Sq;
  // the keys this tile needs: up to the last key its last row sees, or all
  // of them when a row sees none (equal weights over every key)
  int n_keys = Sk;
  if (causal) {
    const int first_last = q0 + off;
    const int tile_last = q0 + rows - 1 + off;
    n_keys = first_last < 0 ? Sk : min(Sk, tile_last + 1);
  }
  const int n_tiles = (n_keys + kBK - 1) / kBK;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + g * ks.h;
  const bf16* vb = v + b * vs.b + g * vs.h;
  load_rows<HD>(Qs, qb, qs.s, q0, Sq, hd);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {  // Q rides with tile 0
    if (t < n_tiles) {
      load_rows<HD>(Ks + t * kBK * P, kb, ks.s, t * kBK, n_keys, hd);
      load_rows<HD>(Vs + t * kBK * P, vb, vs.s, t * kBK, n_keys, hd);
    }
    tc::cp_async_commit();
  }

  // this thread's two rows: 16 warp + lane / 4 + 8 j of the tile
  int last[2];
  bool uni[2];
  float m[2], l[2];
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + warp * 16 + lane / 4 + 8 * j;
    int lst = -1;  // a row past Sq sees nothing and is never stored
    uni[j] = false;
    if (row < Sq) {
      lst = causal ? off + row : Sk - 1;
      uni[j] = lst < 0;
      if (uni[j] || lst > Sk - 1) lst = Sk - 1;
    }
    last[j] = lst;
    m[j] = -INFINITY;
    l[j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
  int warp_last = max(last[0], last[1]);
#pragma unroll
  for (int sh = 16; sh > 0; sh /= 2)
    warp_last = max(warp_last, __shfl_xor_sync(0xffffffffu, warp_last, sh));

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int nxt = kt + kStages - 1;  // lands while this tile is used
    if (nxt < n_tiles) {
      load_rows<HD>(Ks + (nxt % kStages) * kBK * P, kb, ks.s, nxt * kBK,
                    n_keys, hd);
      load_rows<HD>(Vs + (nxt % kStages) * kBK * P, vb, vs.s, nxt * kBK,
                    n_keys, hd);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<kStages - 1>();  // tile kt (and Q) have landed
    __syncthreads();
    const int k0 = kt * kBK;
    if (k0 <= warp_last) {
      const bf16* kt_s = Ks + (kt % kStages) * kBK * P;
      const bf16* vt_s = Vs + (kt % kStages) * kBK * P;
      // s = q . k over the key tile: 8 n8 tiles of keys
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        if (kk * 16 >= hd) break;
        uint32_t a[4];
        tc::ldmatrix_x4(a, Qs + (warp * 16 + tc::a_row(lane)) * P + kk * 16 +
                               tc::a_col(lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          tc::ldmatrix_x4(bb, kt_s + (np * 16 + tc::bnk_row(lane)) * P +
                                  kk * 16 + tc::bnk_col(lane));
          tc::mma_bf16_16816(s[2 * np], a, bb[0], bb[1]);
          tc::mma_bf16_16816(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      // mask and scale; the row max over the keys the row sees
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e / 2;
          const int key = k0 + nt * 8 + (lane % 4) * 2 + (e & 1);
          const float val = key <= last[j]
                                ? (uni[j] ? 0.0f : s[nt][e] * scale)
                                : -INFINITY;
          s[nt][e] = val;
          mx[j] = fmaxf(mx[j], val);
        }
      float alpha[2], base[2], sum[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float m_new = fmaxf(m[j], quad_max(mx[j]));
        base[j] = m_new == -INFINITY ? 0.0f : m_new;
        alpha[j] = expf(m[j] - base[j]);  // 0 on the first update, 1 if the
        m[j] = m_new;                     // max stays
        sum[j] = 0.0f;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - base[e / 2]);
          s[nt][e] = p;
          sum[e / 2] += p;
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + quad_sum(sum[j]);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e / 2];
      // o += round_bf16(p) v, 16 keys at a time
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
        uint32_t a[4];
        a[0] = tc::pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        a[1] = tc::pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        a[2] = tc::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        a[3] = tc::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int nd = 0; nd < HD / 16; ++nd) {
          if (nd * 16 >= hd) break;
          uint32_t bb[4];
          tc::ldmatrix_x4_trans(bb, vt_s + (kc * 16 + tc::bkn_row(lane)) * P +
                                        nd * 16 + tc::bkn_col(lane));
          tc::mma_bf16_16816(o[2 * nd], a, bb[0], bb[1]);
          tc::mma_bf16_16816(o[2 * nd + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed: tile kt + 2 may land in it
  }
  tc::cp_async_wait<0>();  // no key tile at all (Sk == 0): Q's copy

  bf16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + warp * 16 + lane / 4 + 8 * j;
    if (row >= Sq) continue;
    const float den = l[j] == 0.0f ? 1.0f : l[j];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int col = i * 8 + (lane % 4) * 2;
      if (col < hd)
        *reinterpret_cast<uint32_t*>(ob + row * os.s + col) =
            tc::pack_bf16(__fdiv_rn(o[i][2 * j], den),
                          __fdiv_rn(o[i][2 * j + 1], den));
    }
  }
}

template <int HD>
int launch_hd(const bf16* q, const bf16* k, const bf16* v, bf16* out,
              const int* qoff, int B, int H, int Sq, int Sk, int hd,
              int n_rep, const flash::Strides (&st)[4], int causal,
              float scale, cudaStream_t stream) {
  auto kern = flash_tc_kernel<HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, out, qoff, Sq, Sk, hd, n_rep,
                                         st[0], st[1], st[2], st[3], causal,
                                         scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_tc

// The fp32 route (CUDA cores). q / out: [B, H, Sq, hd], k / v: [B, H / n_rep,
// Sk, hd], float32, each addressed through `strides`: 12 int64 (b, h, s)
// element strides of q, k, v, out in that order, the last axis contiguous.
// qoff: [B] int32 query offsets for the causal mask, or null. Returns 0 or
// the cudaError_t of the refused launch; -1 for a dtype other than 0 (bf16
// takes flash_attention_tc_launch).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      const int* qoff, const long long* strides,
                                      int B, int H, int Sq, int Sk, int hd,
                                      int n_rep, int causal, float scale,
                                      int dtype, void* stream) {
  if (dtype != 0) return -1;
  return flash::launch<float>(q, k, v, out, qoff, B, H, Sq, Sk, hd, n_rep,
                              strides, causal, scale, (cudaStream_t)stream);
}

// The bf16 route (tensor cores): the same arguments in bfloat16, hd a
// multiple of 8 from 8 to 256, every stride a multiple of 8 elements and
// every base 16-byte aligned. Returns 0, the cudaError_t of a refused launch,
// or -2 for an hd the kernel does not take.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out,
                                         const int* qoff,
                                         const long long* strides, int B,
                                         int H, int Sq, int Sk, int hd,
                                         int n_rep, int causal, float scale,
                                         int dtype, void* stream) {
  if (dtype != 1) return -1;
  if (hd < 8 || hd > 256 || hd % 8 != 0) return -2;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  using tc::bf16;
  const flash::Strides st[4] = {{strides[0], strides[1], strides[2]},
                                {strides[3], strides[4], strides[5]},
                                {strides[6], strides[7], strides[8]},
                                {strides[9], strides[10], strides[11]}};
  const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v;
  bf16* oo = (bf16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 16)
    return flash_tc::launch_hd<16>(qq, kk, vv, oo, qoff, B, H, Sq, Sk, hd,
                                   n_rep, st, causal, scale, s);
  if (hd <= 32)
    return flash_tc::launch_hd<32>(qq, kk, vv, oo, qoff, B, H, Sq, Sk, hd,
                                   n_rep, st, causal, scale, s);
  if (hd <= 64)
    return flash_tc::launch_hd<64>(qq, kk, vv, oo, qoff, B, H, Sq, Sk, hd,
                                   n_rep, st, causal, scale, s);
  if (hd <= 128)
    return flash_tc::launch_hd<128>(qq, kk, vv, oo, qoff, B, H, Sq, Sk, hd,
                                    n_rep, st, causal, scale, s);
  return flash_tc::launch_hd<256>(qq, kk, vv, oo, qoff, B, H, Sq, Sk, hd,
                                  n_rep, st, causal, scale, s);
}

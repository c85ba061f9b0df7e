// Paged decode attention on Hopper (sm_90a), with the table walk split across
// blocks ("flash-decoding"): the body shared by paged_attention.cu (pools in
// the model type) and paged_attention_q.cu (int8 pools with per-(row, head)
// fp32 scales).
//
// Replaces the TPU kernels repro/kernels/paged_attention.py :: paged_attention
// and paged_attention_q, whose grid (B, max_blocks) carries the online-softmax
// state from one table entry to the next in VMEM. Blocks on this card run in no
// order, so the walk is cut into splits that run side by side, each with its
// own online softmax, and a second pass combines their partials in a fixed
// order.
//
// What bounds it: bytes, then latency. Each valid row is read once per kv head
// (2 * hd elements, int8: bytes plus two fp32 scales) for its n_rep query
// heads: n_rep * 4 * hd flops per 2 * hd elements, n_rep flops a byte in bf16
// (8 for qwen3-moe, 4 for granite-8b). The fp32 CUDA-core ridge is about 20
// (67 TFLOP/s over 3.35 TB/s), so the work stays on CUDA cores in fp32 in
// both pool types: rows, logits, softmax and accumulator in fp32, one
// rounding at the output (what the card's checks hold it to). At the serve
// shape the bytes take under a microsecond, so the latency of a block's
// loads and the launches set the time; the design is for parallelism and
// overlap.
//
// The plan, a function of (bs, mb) only (kernels/paged_attention.py mirrors
// kSplitRows, kChunkRows and kStages):
//   R = max(1, kSplitRows / bs) * bs rows a split (a whole number of table
//   entries), S = ceil(mb * bs / R) splits a slot.
//   split pass, grid (S, nkv, B), kThreads threads: block (s, g, b) covers the
//     rows [s R, min((s + 1) R, len)) of slot b for kv head g and its n_rep
//     query heads (GQA: each K/V row is loaded once for all of them), len =
//     min(lens[b], mb * bs); it exits at once if the range is empty. It writes
//     its partial (acc[hd] unnormalised, m, l) per query head to the fp32
//     workspace ws [B][nq][S][hd + 2].
//   combine pass, grid (nq, B): the n_s = ceil(len / R) partials of (b, h) in
//     ascending split order: M = max m_s, L = sum l_s e^(m_s - M), O = sum
//     acc_s e^(m_s - M) / L, rounded once to the output type. n_s = 0
//     (lens 0) writes zeros, as the TPU kernel's l == 0 guard does; a
//     one-split slot takes the same arithmetic.
// Nothing in a block's arithmetic reads B, nb, the SM count or the table's
// length beyond len, so a slot's rows are cut and summed the same way alone or
// among many slots, in a dense cache's contiguous table or in the pool's, and
// in a table padded with sentinels: those equalities are bitwise.
//
// Inside a split: the rows go through a ring of kStages stages of kChunkRows
// rows (one table entry at the served bs of 16; at R = 32 both stages of a
// split are in flight before the first computes), lane group gr (kGroup
// lanes) copying row gr of head g by 16-byte cp.async in the pool's type
// (int8: its two scales by 4-byte copies), zero-filled past the split's end;
// q arrives the same way with the first stage, in its own type. The split's
// table entries are read beside lens. Logits: group gr holds row gr of the
// stage widened to fp32 in registers, each lane the 16-byte pieces gi,
// gi + kGroup, ..., and for kHeads query heads at a time sums q . k over
// its pieces with fmaf (independent chains, no branch between loads and
// products), then across the group by shuffles (xor 4, 2, 1); the logit is
// that sum (int8: times the row's K scale) divided by sqrt(hd). Softmax: a
// half warp per head, lane = row: the chunk's max, m_new = max(m, max),
// p = e^(s - m_new), l = l alpha + sum p with alpha = e^(m - m_new). Values:
// each thread owns (query head, 16-byte column slice; 8 bytes for int8)
// pairs, scales its
// accumulators by alpha and adds p v over the stage's rows in ascending
// order (rows past the split's end have p = 0 and zero rows: they add
// exactly nothing). Int8 pools: a row's V scale multiplies its weight
// (p s_v) before the row's products, in fp32; l sums the unscaled p.
// kSplitRows, kStages and kHeads were chosen by timing R = 16, 32, 64 rows,
// 2 and 3 stages, 2 and 4 heads at the serve shapes (PERF.md section 6).
//
// Table entries >= n_blocks (sentinels) are clipped to n_blocks - 1. Rows at or
// past len are never loaded and never enter a sum, so whatever a clipped or
// stale block holds (even inf or nan) contributes exactly nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tc_sm90.cuh"

namespace paged {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kSplitRows = 32;  // rows a split at bs <= 32 (whole entries)
constexpr int kChunkRows = 16;  // rows a ring stage
constexpr int kStages = 2;      // ring stages
constexpr int kGroup = kThreads / kChunkRows;  // lanes that share a row's logit
constexpr int kHeads = 4;       // query heads whose logits a lane computes at once
constexpr int kRowRegs = 32;    // fp32 elements of a K row one lane holds
constexpr int kAccRegs = 64;    // fp32 accumulators a thread holds
constexpr int kMaxHd = 256;
constexpr int kMaxRep = 32;
constexpr int kBatch = 8;       // partials the combine pass loads at once

static_assert(kGroup == 8 && kChunkRows == 16 && kHeads <= kGroup,
              "logits: 8 lanes a row, a lane stores one head; "
              "softmax: a half warp a head, lane = row");
// hd <= 256: a lane of a group holds at most kRowRegs elements of its row and
// a thread at most kAccRegs accumulators (n_rep * hd <= kThreads * kAccRegs).
static_assert(kMaxHd / kGroup <= kRowRegs, "row registers");
static_assert(kMaxRep * kMaxHd <= kThreads * kAccRegs, "accumulators");
static_assert(kAccRegs % 16 == 0, "a thread holds whole value slices");

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float from_f32(float v) { return v; }
  // four elements from shared memory (16-byte aligned), as fp32
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16_rn(v);
  }
  // four elements from shared memory (8-byte aligned), widened exactly
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
};

// One 16-byte piece of a pool row: kN elements, widened exactly to fp32.
template <typename P>
struct Piece;

template <>
struct Piece<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void widen(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Piece<signed char> {
  static constexpr int kN = 16;
  static __device__ __forceinline__ void widen(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)  // byte j of word i, sign-extended
        f[4 * i + j] = (float)((int)(w[i] << (24 - 8 * j)) >> 24);
    }
  }
};

// The elements of a row one thread of the value pass takes at a time: a
// 16-byte piece, or half of one for int8 pools (8 bytes), so that the value
// pass has as many (head, slice) pairs as in bf16 and keeps all threads busy.
template <typename P>
struct Slice {
  static constexpr int kN = Piece<P>::kN;
  static __device__ __forceinline__ void load(const unsigned char* p,
                                              float* f) {
    Piece<P>::widen(*reinterpret_cast<const uint4*>(p), f);
  }
};

template <>
struct Slice<signed char> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const unsigned char* p,
                                              float* f) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)  // byte j of word i, sign-extended
        f[4 * i + j] = (float)((int)(w[i] << (24 - 8 * j)) >> 24);
    }
  }
};

// 4 bytes from src to dst (both 4-byte aligned); zero-filled with pred false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_u32(dst)),
               "l"(src), "r"(n));
}

// Reductions over the 16 lanes of a half warp, the same tree in every lane.
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline int split_rows(int bs) {
  return (kSplitRows / bs > 1 ? kSplitRows / bs : 1) * bs;
}

__host__ __device__ inline int n_splits(int mb, int bs) {
  const int r = split_rows(bs);
  return (mb * bs + r - 1) / r;
}

// Dynamic shared memory of the split pass, in bytes; the layout, in order:
// K and V stages [kStages][kChunkRows][hd] in the pool's type (elt bytes),
// q [n_rep][hd] in its own type (q_elt bytes), (int8) K and V scales
// [kStages][kChunkRows], logits / weights [n_rep][kChunkRows], m, l, alpha
// [n_rep], the split's table entries [kSplitRows] int32. Every part starts
// 16-byte aligned (hd * elt and hd * q_elt are multiples of 16).
inline size_t smem_bytes(int n_rep, int hd, int elt, int q_elt, bool int8) {
  return 2 * (size_t)kStages * kChunkRows * hd * elt +
         (size_t)n_rep * hd * q_elt +
         (int8 ? 2 * (size_t)kStages * kChunkRows * 4 : 0) +
         (size_t)n_rep * kChunkRows * 4 + 3 * (size_t)n_rep * 4 +
         (size_t)kSplitRows * 4;
}

// q: [B, nq, hd]; kp/vp: [nb, bs, nkv, hd]; ks/vs: [nb, bs, nkv] (int8 only);
// tab: [B, mb]; lens: [B]; ws: [B, nq, S, hd + 2] fp32.
template <typename T, typename P, bool kQ>
__global__ void __launch_bounds__(kThreads) split_pass_kernel(
    const T* __restrict__ q, const P* __restrict__ kp,
    const P* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ tab,
    const int* __restrict__ lens, float* __restrict__ ws, int nb, int bs,
    int nkv, int hd, int mb, int n_rep, float sqrt_hd) {
  constexpr int kN = Piece<P>::kN;
  constexpr int kPieces = kRowRegs / kN;  // pieces of a row one lane holds
  constexpr int kVN = Slice<P>::kN;       // elements of a value slice
  constexpr int kPairs = kAccRegs / kVN;  // (head, slice) pairs a thread owns
  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int R = split_rows(bs);
  const int S = n_splits(mb, bs);
  const int r0 = s * R;
  const int j0 = r0 / bs;
  // the split's table entries (R / bs <= kSplitRows <= kThreads of them, those
  // inside the table), read beside lens: neither waits for the other
  const int ent = tid < min(R / bs, mb - j0) ? tab[(size_t)b * mb + j0 + tid]
                                              : 0;
  const int len = min(max(lens[b], 0), mb * bs);
  const int r1 = min(r0 + R, len);
  if (r0 >= r1) return;

  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int nq = nkv * n_rep;
  const int row_bytes = hd * (int)sizeof(P);
  const int nc = row_bytes / 16;  // 16-byte pieces a row
  const int stage_bytes = kChunkRows * row_bytes;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kst = smem;
  unsigned char* vst = kst + kStages * stage_bytes;
  T* qs = reinterpret_cast<T*>(vst + kStages * stage_bytes);
  float* ksc = reinterpret_cast<float*>(qs + n_rep * hd);  // int8 only
  float* vsc = ksc + (kQ ? kStages * kChunkRows : 0);
  float* sc = vsc + (kQ ? kStages * kChunkRows : 0);  // [n_rep][kChunkRows]
  float* m_s = sc + n_rep * kChunkRows;
  float* l_s = m_s + n_rep;
  float* a_s = l_s + n_rep;
  int* ents = reinterpret_cast<int*>(a_s + n_rep);    // [kSplitRows]

  // q of the n_rep heads, as stored, by 16-byte copies in the first commit
  // group (with chunk 0's rows); the logits widen it on read
  const unsigned char* qsrc = reinterpret_cast<const unsigned char*>(
      q + ((size_t)b * nq + (size_t)g * n_rep) * hd);
  for (int i = tid; i < n_rep * hd * (int)sizeof(T) / 16; i += kThreads)
    tc::cp_async16(reinterpret_cast<unsigned char*>(qs) + i * 16,
                   qsrc + i * 16, true);
  if (tid < min(R / bs, mb - j0)) ents[tid] = min(max(ent, 0), nb - 1);
  for (int h = tid; h < n_rep; h += kThreads) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.0f;
  }
  __syncthreads();

  const int n_chunks = (r1 - r0 + kChunkRows - 1) / kChunkRows;
  // lane group gr (kGroup lanes) owns row gr of every stage: it copies that
  // row (lane gi the pieces gi, gi + kGroup, ...) and computes its logits
  const int gr = tid / kGroup;
  const int gi = tid % kGroup;
  // chunk c (rows r0 + c kChunkRows ...) into stage c % kStages, one commit
  // group a chunk
  auto load_chunk = [&](int c) {
    if (c < n_chunks) {
      const int st = c % kStages;
      const int r = r0 + c * kChunkRows + gr;
      const bool ok = r < r1;
      size_t row = 0;
      if (ok) {
        const int j = r / bs;
        row = ((size_t)ents[j - j0] * bs + (r - j * bs)) * nkv + g;
      }
      const size_t off = (size_t)(st * kChunkRows + gr) * row_bytes;
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(kp) + row * row_bytes;
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(vp) + row * row_bytes;
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        const int cc = gi + p * kGroup;
        if (cc < nc) {
          tc::cp_async16(kst + off + cc * 16, ksrc + cc * 16, ok);
          tc::cp_async16(vst + off + cc * 16, vsrc + cc * 16, ok);
        }
      }
      if (kQ && gi == 0) {
        cp_async4(ksc + st * kChunkRows + gr, ks + row, ok);
        cp_async4(vsc + st * kChunkRows + gr, vs + row, ok);
      }
    }
    tc::cp_async_commit();
  };

  // the value pairs this thread owns: i = tid + k kThreads < n_rep * nv
  const int nv = hd / kVN;  // value slices a row
  const int n_pairs = n_rep * nv;
  float acc[kPairs][kVN];
#pragma unroll
  for (int k = 0; k < kPairs; ++k)
#pragma unroll
    for (int e = 0; e < kVN; ++e) acc[k][e] = 0.0f;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) load_chunk(c);
  for (int c = 0; c < n_chunks; ++c) {
    load_chunk(c + kStages - 1);
    tc::cp_async_wait<kStages - 1>();
    __syncthreads();  // chunk c has landed for every thread
    const int st = c % kStages;
    const int nvalid = min(kChunkRows, r1 - r0 - c * kChunkRows);

    // ---- logits s = q . k / sqrt(hd) (int8: s_k (q . k_int) / sqrt(hd)):
    // group gr = row gr of the stage (rows past nvalid are zeros and computed
    // anyway, so that every lane takes the shuffles)
    {
      const int rr = gr;
      const int i = gi;
      const unsigned char* krow = kst + (size_t)(st * kChunkRows + rr) * row_bytes;
      float kr[kRowRegs];
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        const int cc = i + p * kGroup;
        if (cc < nc) {
          Piece<P>::widen(*reinterpret_cast<const uint4*>(krow + cc * 16),
                          kr + p * kN);
        } else {
#pragma unroll
          for (int e = 0; e < kN; ++e) kr[p * kN + e] = 0.0f;
        }
      }
      // kHeads heads at a time: independent fmaf chains, one per head, with
      // no branch between the loads and the products (a head index past
      // n_rep reads the last head again and is not stored)
      for (int h0 = 0; h0 < n_rep; h0 += kHeads) {
        const T* qh[kHeads];
        float dot[kHeads];
#pragma unroll
        for (int u = 0; u < kHeads; ++u) {
          qh[u] = qs + min(h0 + u, n_rep - 1) * hd;
          dot[u] = 0.0f;
        }
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          const int cc = i + p * kGroup;
          if (cc < nc) {
#pragma unroll
            for (int e4 = 0; e4 < kN; e4 += 4) {
#pragma unroll
              for (int u = 0; u < kHeads; ++u) {
                const float4 qv = Num<T>::load4(qh[u] + cc * kN + e4);
                dot[u] = fmaf(qv.x, kr[p * kN + e4], dot[u]);
                dot[u] = fmaf(qv.y, kr[p * kN + e4 + 1], dot[u]);
                dot[u] = fmaf(qv.z, kr[p * kN + e4 + 2], dot[u]);
                dot[u] = fmaf(qv.w, kr[p * kN + e4 + 3], dot[u]);
              }
            }
          }
        }
#pragma unroll
        for (int o = kGroup / 2; o > 0; o /= 2) {
#pragma unroll
          for (int u = 0; u < kHeads; ++u)
            dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
        }
        // every lane of the group holds the same sums: lane u stores head u
        float d = dot[0];
#pragma unroll
        for (int u = 1; u < kHeads; ++u)
          if (i == u) d = dot[u];
        if (i < kHeads && h0 + i < n_rep) {
          if (kQ) d = __fmul_rn(d, ksc[st * kChunkRows + rr]);
          sc[(h0 + i) * kChunkRows + rr] = __fdiv_rn(d, sqrt_hd);
        }
      }
    }
    __syncthreads();

    // ---- online softmax: a half warp per head, lane = row
    {
      const int hw = lane / 16;
      const int rr = lane % 16;
      for (int h0 = 2 * warp; h0 < n_rep; h0 += kThreads / 16) {
        const int h = h0 + hw;
        const bool live = h < n_rep && rr < nvalid;
        float sv = -INFINITY;
        float m_old = -INFINITY;
        if (h < n_rep) m_old = m_s[h];
        if (live) sv = sc[h * kChunkRows + rr];
        const float m_new = fmaxf(m_old, half_max(sv));  // a live row: finite
        const float p = live ? expf(sv - m_new) : 0.0f;
        const float sum = half_sum(p);
        if (h < n_rep) {
          sc[h * kChunkRows + rr] = p;
          if (rr == 0) {
            const float alpha = expf(m_old - m_new);  // 0 on the first chunk
            a_s[h] = alpha;
            l_s[h] = __fadd_rn(__fmul_rn(l_s[h], alpha), sum);
            m_s[h] = m_new;
          }
        }
      }
    }
    __syncthreads();

    // ---- p . V: (head, slice) pairs, rows in ascending order; all
    // kChunkRows rows, since past nvalid the weights (and int8 scales) and
    // the rows are zeros, which add exactly nothing
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int pi = tid + k * kThreads;
      if (pi < n_pairs) {
        const int h = pi / nv;
        const int cv = pi - h * nv;
        const float alpha = a_s[h];
#pragma unroll
        for (int e = 0; e < kVN; ++e) acc[k][e] = __fmul_rn(acc[k][e], alpha);
        const unsigned char* vcol =
            vst + (size_t)st * stage_bytes + cv * kVN * sizeof(P);
        const float* ph = sc + h * kChunkRows;
#pragma unroll 4
        for (int rr = 0; rr < kChunkRows; ++rr) {
          float p = ph[rr];
          if (kQ) p = __fmul_rn(p, vsc[st * kChunkRows + rr]);
          float v[kVN];
          Slice<P>::load(vcol + (size_t)rr * row_bytes, v);
#pragma unroll
          for (int e = 0; e < kVN; ++e) acc[k][e] = fmaf(p, v[e], acc[k][e]);
        }
      }
    }
    __syncthreads();  // stage st, the weights and alpha are consumed
  }
  tc::cp_async_wait<0>();  // nothing is left in flight (the empty groups)

  // ---- the partial of every query head: acc, m, l
  const size_t part0 = ((size_t)b * nq + (size_t)g * n_rep) * S + s;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int pi = tid + k * kThreads;
    if (pi < n_pairs) {
      const int h = pi / nv;
      const int cv = pi - h * nv;
      float* o = ws + (part0 + (size_t)h * S) * (hd + 2) + cv * kVN;
#pragma unroll
      for (int e = 0; e < kVN; ++e) o[e] = acc[k][e];
    }
  }
  for (int h = tid; h < n_rep; h += kThreads) {
    float* o = ws + (part0 + (size_t)h * S) * (hd + 2);
    o[hd] = m_s[h];
    o[hd + 1] = l_s[h];
  }
}

// grid (nq, B), one thread a column (blockDim a multiple of 32 >= hd).
template <typename T>
__global__ void combine_pass_kernel(const float* __restrict__ ws,
                               const int* __restrict__ lens,
                               T* __restrict__ out, int nq, int hd, int mb,
                               int bs) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x;
  const int R = split_rows(bs);
  const int S = n_splits(mb, bs);
  const float* part = ws + ((size_t)b * nq + h) * S * (hd + 2);
  // the first kBatch partials (all of them at the serve shapes) are loaded
  // beside lens, before it says how many hold a split's result; the rest one
  // by one; the sums run in ascending split order over the n_s that do
  float mv[kBatch], lv[kBatch], av[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (u < S) {
      const float* ps = part + (size_t)u * (hd + 2);
      mv[u] = ps[hd];
      lv[u] = ps[hd + 1];
      av[u] = c < hd ? ps[c] : 0.0f;
    }
  }
  const int len = min(max(lens[b], 0), mb * bs);
  const int n_s = (len + R - 1) / R;
  float M = -INFINITY;
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if (u < n_s) M = fmaxf(M, mv[u]);
  for (int s = kBatch; s < n_s; ++s)
    M = fmaxf(M, part[(size_t)s * (hd + 2) + hd]);
  float L = 0.0f;
  float O = 0.0f;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (u < n_s) {
      const float w = expf(mv[u] - M);
      L = fmaf(lv[u], w, L);
      O = fmaf(av[u], w, O);
    }
  }
  for (int s = kBatch; s < n_s; ++s) {
    const float* ps = part + (size_t)s * (hd + 2);
    const float w = expf(ps[hd] - M);
    L = fmaf(ps[hd + 1], w, L);
    if (c < hd) O = fmaf(ps[c], w, O);
  }
  if (c < hd)
    out[((size_t)b * nq + h) * hd + c] =
        Num<T>::from_f32(__fdiv_rn(O, L == 0.0f ? 1.0f : L));
}

// Both passes on ``stream``. ws: fp32 [B, nq, n_splits(mb, bs), hd + 2].
// Returns 0 or the cudaError_t of a refused launch.
template <typename T, typename P>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* tab, const int* lens, float* ws,
           void* out, int B, int nb, int bs, int nkv, int hd, int mb,
           int n_rep, float sqrt_hd, cudaStream_t stream) {
  constexpr bool kQ = sizeof(P) == 1;
  if (B <= 0 || nkv <= 0) return 0;
  const int S = n_splits(mb, bs);
  if (S > 0) {
    const size_t smem =
        smem_bytes(n_rep, hd, (int)sizeof(P), (int)sizeof(T), kQ);
    auto k = split_pass_kernel<T, P, kQ>;
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    k<<<dim3(S, nkv, B), kThreads, smem, stream>>>(
        (const T*)q, (const P*)kp, (const P*)vp, ks, vs, tab, lens, ws, nb, bs,
        nkv, hd, mb, n_rep, sqrt_hd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (hd + kWarp - 1) / kWarp * kWarp;
  combine_pass_kernel<T><<<dim3(nkv * n_rep, B), threads, 0, stream>>>(
      ws, lens, (T*)out, nkv * n_rep, hd, mb, bs);
  return (int)cudaGetLastError();
}

}  // namespace paged

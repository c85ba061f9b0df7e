// paged_attention_q: decode attention over an int8 paged KV pool with
// per-(row, head) fp32 scales (paged_attention.cuh): each staged row is
// dequantized with one fp32 multiply and kept fp32. Replaces
// repro/kernels/paged_attention.py :: paged_attention_q.
#include "paged_attention.cuh"

// dtype (of q and out): 0 = float32, 1 = bfloat16. kp/vp: int8
// [nb, bs, nkv, hd]; ks/vs: fp32 [nb, bs, nkv]; tab: [B, mb] int32; lens: [B]
// int32; out: [B, nq, hd]. Returns 0 or the cudaError_t of the refused launch;
// -1 for a bad dtype.
extern "C" int paged_attention_q_launch(const void* q, const void* kp,
                                        const void* vp, const float* ks,
                                        const float* vs, const int* tab,
                                        const int* lens, void* out, int B,
                                        int nb, int bs, int nkv, int hd, int mb,
                                        int n_rep, float sqrt_hd, int dtype,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return paged::launch<float, signed char>(q, kp, vp, ks, vs, tab, lens, out,
                                             B, nb, bs, nkv, hd, mb, n_rep,
                                             sqrt_hd, s);
  if (dtype == 1)
    return paged::launch<__nv_bfloat16, signed char>(
        q, kp, vp, ks, vs, tab, lens, out, B, nb, bs, nkv, hd, mb, n_rep,
        sqrt_hd, s);
  return -1;
}

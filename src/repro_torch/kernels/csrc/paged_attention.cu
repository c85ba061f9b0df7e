// paged_attention: decode attention over a paged KV pool in the model type
// (paged_attention.cuh). Replaces repro/kernels/paged_attention.py ::
// paged_attention.
#include "paged_attention.cuh"

// dtype (of q, the pools and out): 0 = float32, 1 = bfloat16. q: [B, nq, hd];
// kp/vp: [nb, bs, nkv, hd]; tab: [B, mb] int32; lens: [B] int32; out:
// [B, nq, hd]. Returns 0 or the cudaError_t of the refused launch; -1 for a
// bad dtype.
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const int* tab,
                                      const int* lens, void* out, int B, int nb,
                                      int bs, int nkv, int hd, int mb,
                                      int n_rep, float sqrt_hd, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return paged::launch<float, float>(q, kp, vp, nullptr, nullptr, tab, lens,
                                       out, B, nb, bs, nkv, hd, mb, n_rep,
                                       sqrt_hd, s);
  if (dtype == 1)
    return paged::launch<__nv_bfloat16, __nv_bfloat16>(
        q, kp, vp, nullptr, nullptr, tab, lens, out, B, nb, bs, nkv, hd, mb,
        n_rep, sqrt_hd, s);
  return -1;
}

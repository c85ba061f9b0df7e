"""``gather_swiglu`` for Hopper: the decode-mode MoE kernel.

Replaces the TPU kernel ``repro/kernels/decode_moe.py :: gather_swiglu``
(``_kernel``). Row t of the result is ``sum_j w[t, j] *
SwiGLU_{idx[t, j]}(x[t])`` over the token's k routed experts.

What bounds it on this card: bytes. T is the number of serving slots, so each
(token, j) pair streams one expert's three tables, ``3 * d * f`` elements,
for ``2 * 3 * d * f`` flops: about one flop per byte in bf16, far below the
card's ~295. The least time is (distinct experts hit) x (bytes of one expert)
over the memory rate.

What the design does about it (``csrc/gather_swiglu.cu``, ``moe_swiglu.cuh``):
no sort, no padding, no scatter, no atomics. Three passes on the current
stream: the gate/up pass over all T*k pairs at once (grid = pairs x column
slices, so the whole card streams weights), the down pass likewise, then a
combine that adds the k rounded rows of a token in fp32 in slot order. Each
thread owns adjacent output columns, so weight loads coalesce, and walks its
reduction axis in index order: a pair's result is bitwise the row the grouped
kernel computes for it, which is what keeps gather == ragged and fused-K ==
step-at-a-time exact on the card. The TPU kernel's ``(T, k)`` sequential grid
with a VMEM accumulator is not carried over. Pairs that hit the same expert
still stream it once each (the L2 absorbs part of that); sharing the stream
across them is later work.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _common, ref

#: times the wrapper launched the CUDA kernel (never counts the plain version)
LAUNCHES = 0

plain = ref.gather_swiglu

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("gather_swiglu").gather_swiglu_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        _FN = fn
    return _FN


def gather_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                  wd: torch.Tensor, idx: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. x: [T, d]; wg/wu: [E, d, f]; wd: [E, f, d];
    idx: [T, k] integer expert ids (clipped to [0, E) in the kernel); w:
    [T, k] combine weights. Returns [T, d] in ``x.dtype``. Everything must be
    contiguous and on one CUDA device; raises otherwise."""
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError("gather_swiglu kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    T, d, E, f = _common.check_tables("gather_swiglu", x, wg, wu, wd)
    if idx.dim() != 2 or idx.shape[0] != T or w.shape != idx.shape:
        raise ValueError(f"gather_swiglu: idx {tuple(idx.shape)} / w "
                         f"{tuple(w.shape)} do not fit T={T}")
    if idx.device != x.device or w.device != x.device:
        raise ValueError("gather_swiglu: idx and w must be on x's device")
    k = idx.shape[1]
    if max(d, f) * 4 > _common.SMEM_LIMIT:
        raise ValueError(f"gather_swiglu: a row of d={d} / f={f} fp32 values "
                         f"does not fit in shared memory")
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if T == 0 or k == 0:
        return out.zero_()
    idx32 = idx.to(torch.int32).contiguous()
    w32 = w.to(torch.float32).contiguous()
    h = torch.empty((T * k, f), dtype=x.dtype, device=x.device)
    y = torch.empty((T * k, d), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = _fn()(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                     idx32.data_ptr(), w32.data_ptr(), h.data_ptr(),
                     y.data_ptr(), out.data_ptr(), T, E, d, f, k,
                     _common.DTYPE_CODES[x.dtype],
                     torch.cuda.current_stream().cuda_stream)
    _common.check_launch("gather_swiglu", code)
    LAUNCHES += 1
    return out

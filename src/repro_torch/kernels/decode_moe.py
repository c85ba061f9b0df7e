"""``gather_swiglu`` and ``gather_swiglu_q`` for Hopper: the decode-mode MoE.

Replace the TPU kernels ``repro/kernels/decode_moe.py :: gather_swiglu``
(``_kernel``) and ``:: gather_swiglu_q`` (``_kernel_q``). Row t of the result
is ``sum_j w[t, j] * SwiGLU_{idx[t, j]}(x[t])`` over the token's k routed
experts; the int8 form reads tables quantized per (expert, output channel).

What bounds them on this card: bytes. T is the number of serving slots, so
each (token, j) pair streams one expert's three tables, ``3 * d * f``
elements, for ``2 * 3 * d * f`` flops: about one flop per byte in bf16 (two
in int8), far below the card's ~295. The least time is (distinct experts hit)
x (bytes of one expert) over the memory rate; int8 halves the bytes (plus
``4 * (2f + d)`` bytes of scales per expert).

What the design does about it (``csrc/gather_swiglu.cu``,
``csrc/gather_swiglu_q.cu``, ``moe_swiglu.cuh``): no sort, no padding, no
scatter, no atomics. The gate/up pass runs over all T*k pairs at once (grid =
pairs x column slices, so the whole card streams weights), then the down
pass likewise. Each thread owns adjacent output columns, so weight loads
coalesce, and walks its reduction axis in index order: a pair's result is
bitwise the row the grouped kernel computes for it, which is what keeps
gather == ragged and fused-K == step-at-a-time exact on the card. The bf16
form adds the k rounded rows of a token in fp32 in slot order in a third
pass. The int8 form dequantizes each weight with one fp32 multiply by its
output column's scale, keeps ``h`` fp32, and emits the per-pair rows
``[T, k, d]``; as in the TPU kernel, the combine runs outside the kernel
(:func:`repro_torch.kernels.ref.combine_in_order`, the slot-order sum of the
ragged path). The TPU kernels' ``(T, k)`` sequential grid is not carried
over. Pairs that hit the same expert still stream it once each (the L2
absorbs part of that); sharing the stream across them is later work.
"""
from __future__ import annotations


import torch

from repro_torch.kernels import _common, ref

GATHER = _common.Kernel("gather_swiglu", ref.gather_swiglu)
GATHER_Q = _common.Kernel("gather_swiglu_q", ref.gather_swiglu_q)

def _check_ids(name, x, idx, w, T):
    if idx.dim() != 2 or idx.shape[0] != T or (w is not None
                                                and w.shape != idx.shape):
        raise ValueError(f"{name}: idx {tuple(idx.shape)} / w "
                         f"{None if w is None else tuple(w.shape)} do not fit "
                         f"T={T}")
    if idx.device != x.device or (w is not None and w.device != x.device):
        raise ValueError(f"{name}: idx and w must be on x's device")


def _check_smem(name, d, f):
    if max(d, f) * 4 > _common.SMEM_LIMIT:
        raise ValueError(f"{name}: a row of d={d} / f={f} fp32 values "
                         f"does not fit in shared memory")


def gather_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                  wd: torch.Tensor, idx: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. x: [T, d]; wg/wu: [E, d, f]; wd: [E, f, d];
    idx: [T, k] integer expert ids (clipped to [0, E) in the kernel); w:
    [T, k] combine weights. Returns [T, d] in ``x.dtype``. Everything must be
    contiguous and on one CUDA device; raises otherwise."""
    if not x.is_cuda:
        raise ValueError("gather_swiglu kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    T, d, E, f = _common.check_tables("gather_swiglu", x, wg, wu, wd)
    _check_ids("gather_swiglu", x, idx, w, T)
    _check_smem("gather_swiglu", d, f)
    k = idx.shape[1]
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if T == 0 or k == 0:
        return out.zero_()
    idx32 = idx.to(torch.int32).contiguous()
    w32 = w.to(torch.float32).contiguous()
    h = torch.empty((T * k, f), dtype=x.dtype, device=x.device)
    y = torch.empty((T * k, d), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = _common.launcher("gather_swiglu_launch", 9, 6)(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            idx32.data_ptr(), w32.data_ptr(), h.data_ptr(), y.data_ptr(),
            out.data_ptr(), T, E, d, f, k, _common.DTYPE_CODES[x.dtype],
            _common.stream_of(x))
    _common.check_launch("gather_swiglu", code)
    GATHER.count()
    return out


def gather_swiglu_q_rows(x: torch.Tensor, qt, idx: torch.Tensor
                         ) -> torch.Tensor:
    """Launch the int8 CUDA kernel. x: [T, d]; qt: ``QuantizedExpertTables``
    (int8 tables, fp32 keepdim scales); idx: [T, k] integer expert ids
    (clipped to [0, E) in the kernel). Returns the per-pair rows [T, k, d] in
    ``x.dtype``. Everything must be contiguous and on one CUDA device;
    raises otherwise."""
    if not x.is_cuda:
        raise ValueError("gather_swiglu_q kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    T, d, E, f = _common.check_qtables("gather_swiglu_q", x, qt)
    _check_ids("gather_swiglu_q", x, idx, None, T)
    _check_smem("gather_swiglu_q", d, f)
    k = idx.shape[1]
    y = torch.empty((T, k, d), dtype=x.dtype, device=x.device)
    if T == 0 or k == 0:
        return y
    idx32 = idx.to(torch.int32).contiguous()
    h = torch.empty((T * k, f), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _common.launcher("gather_swiglu_q_launch", 10, 6)(
            x.data_ptr(), qt.wg.data_ptr(), qt.wu.data_ptr(), qt.wd.data_ptr(),
            qt.wg_scale.data_ptr(), qt.wu_scale.data_ptr(),
            qt.wd_scale.data_ptr(), idx32.data_ptr(), h.data_ptr(),
            y.data_ptr(), T, E, d, f, k, _common.DTYPE_CODES[x.dtype],
            _common.stream_of(x))
    _common.check_launch("gather_swiglu_q", code)
    GATHER_Q.count()
    return y


def gather_swiglu_q(x: torch.Tensor, qt, idx: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's per-pair rows, then the fp32 combine in slot order
    outside the kernel. Returns [T, d] in ``x.dtype``."""
    if w.shape != idx.shape or w.device != x.device:
        raise ValueError(f"gather_swiglu_q: w {tuple(w.shape)} on {w.device} "
                         f"does not fit idx {tuple(idx.shape)} on {x.device}")
    y = gather_swiglu_q_rows(x, qt, idx)
    return ref.combine_in_order(y, w).to(x.dtype)

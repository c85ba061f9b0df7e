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

What the design does about it. No sort, no padding, no scatter, no atomics:
an up pass, a down pass, and a third pass that adds the k rounded rows of a
token in fp32 in slot order. Each form takes two routes, counted per route:
plain tables by :func:`repro_torch.kernels.moe_tc.route`, int8 tables by
:func:`repro_torch.kernels.moe_tc.route_q`.

* ``tensor_core`` (bf16 x, d and f multiples of 8 for plain tables and of 16
  for int8 ones; ``csrc/gather_swiglu.cu`` / ``csrc/gather_swiglu_q.cu`` over
  ``csrc/moe_tc_sm90.cuh``): an expert-major grid. Block (column tile, e)
  reads the T*k ids, collects the pairs whose clipped id is e in ascending
  pair order, 64 a tile, and exits at once if there are none; the expert's
  tables stream through a ``cp.async`` ring into ``wgmma`` (fp32
  accumulate), once per column tile for all of its pairs, so a decode step
  streams the ~49 tables its 64 pairs hit, not 64. Int8 tables arrive at half
  the bytes and are widened to bf16 in shared memory; their scales are
  applied after the sums and h crosses the passes as a bf16 hi + lo pair
  (``moe_tc_sm90.cuh``'s int8 contract). The tile plan
  (:func:`repro_torch.kernels.moe_tc.plan` / ``plan_q``) and the tile code
  are the grouped kernels', so a pair's row is bitwise the grouped kernel's
  of its form.
* ``cuda_core`` (fp32, other widths; ``csrc/moe_swiglu.cuh``): one block per
  pair, each thread owning adjacent output columns and walking its reduction
  axis in index order with ``fmaf``, bitwise the grouped kernel's CUDA-core
  row; int8 weights dequantized with one fp32 multiply by their output
  column's scale, ``h`` kept fp32.

Either way gather == ragged and fused-K == step-at-a-time hold exactly on
the card. The int8 form emits the per-pair rows ``[T, k, d]``
(:func:`gather_swiglu_q_rows`) as the TPU kernel does; its combine is the
slot-order sum of the ragged path (:func:`repro_torch.kernels.ref.
combine_in_order`), run on the card by the kernel's combine pass on either
route. The TPU kernels' ``(T, k)`` sequential grid is not carried over.
"""
from __future__ import annotations


import torch

from repro_torch.kernels import _common, moe_tc, ref

GATHER = _common.Kernel("gather_swiglu", ref.gather_swiglu,
                        routes=moe_tc.ROUTES)
GATHER_Q = _common.Kernel("gather_swiglu_q", ref.gather_swiglu_q,
                          routes=moe_tc.ROUTES)
#: the C entry point of each route
ENTRY = {"tensor_core": "gather_swiglu_tc_launch",
         "cuda_core": "gather_swiglu_launch"}
ENTRY_Q = {"tensor_core": "gather_swiglu_q_tc_launch",
           "cuda_core": "gather_swiglu_q_launch"}

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
    """Launch the kernels of the route of ``(x.dtype, d, f)``
    (:func:`repro_torch.kernels.moe_tc.route`). x: [T, d]; wg/wu: [E, d, f];
    wd: [E, f, d]; idx: [T, k] integer expert ids (clipped to [0, E) in the
    kernel); w: [T, k] combine weights. Returns [T, d] in ``x.dtype``.
    Everything must be contiguous and on one CUDA device; raises
    otherwise."""
    if not x.is_cuda:
        raise ValueError("gather_swiglu kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    T, d, E, f = _common.check_tables("gather_swiglu", x, wg, wu, wd)
    _check_ids("gather_swiglu", x, idx, w, T)
    path = moe_tc.route(x.dtype, d, f)
    if path == "cuda_core":
        _check_smem("gather_swiglu", d, f)
    k = idx.shape[1]
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if T == 0 or k == 0:
        return out.zero_()
    idx32 = idx.to(torch.int32).contiguous()
    w32 = w.to(torch.float32).contiguous()
    h = torch.empty((T * k, f), dtype=x.dtype, device=x.device)
    y = torch.empty((T * k, d), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            idx32.data_ptr(), w32.data_ptr(), h.data_ptr(), y.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(x.device):
        if path == "tensor_core":
            p = moe_tc.plan(d, f, _common.n_sms(x.device))
            code = _common.launcher(ENTRY[path], 9, 10,
                                    source="gather_swiglu")(
                *ptrs, T, E, d, f, k, *p.args(), _common.stream_of(x))
        else:
            code = _common.launcher(ENTRY[path], 9, 6)(
                *ptrs, T, E, d, f, k, _common.DTYPE_CODES[x.dtype],
                _common.stream_of(x))
    _common.check_launch("gather_swiglu", code)
    GATHER.count(path)
    return out


def _gather_q(x: torch.Tensor, qt, idx: torch.Tensor, w):
    """Launch the int8 kernel of the route of ``(x.dtype, d, f)``
    (:func:`repro_torch.kernels.moe_tc.route_q`). Returns the per-pair rows
    ``[T, k, d]`` and, with ``w``, the combined ``[T, d]`` (the kernel's
    combine pass, on either route)."""
    if not x.is_cuda:
        raise ValueError("gather_swiglu_q kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    T, d, E, f = _common.check_qtables("gather_swiglu_q", x, qt)
    _check_ids("gather_swiglu_q", x, idx, w, T)
    path = moe_tc.route_q(x.dtype, d, f)
    if path == "cuda_core":
        _check_smem("gather_swiglu_q", d, f)
    k = idx.shape[1]
    y = torch.empty((T, k, d), dtype=x.dtype, device=x.device)
    if T == 0 or k == 0:
        return y, (None if w is None else
                   torch.zeros((T, d), dtype=x.dtype, device=x.device))
    idx32 = idx.to(torch.int32).contiguous()
    ptrs = (x.data_ptr(), qt.wg.data_ptr(), qt.wu.data_ptr(), qt.wd.data_ptr(),
            qt.wg_scale.data_ptr(), qt.wu_scale.data_ptr(),
            qt.wd_scale.data_ptr(), idx32.data_ptr())
    w_ptr = out = out_ptr = None
    if w is not None:
        w32 = w.to(torch.float32).contiguous()
        out = torch.empty((T, d), dtype=x.dtype, device=x.device)
        w_ptr, out_ptr = w32.data_ptr(), out.data_ptr()
    with torch.cuda.device(x.device):
        if path == "tensor_core":
            hi = torch.empty((T * k, f), dtype=x.dtype, device=x.device)
            lo = torch.empty_like(hi)
            p = moe_tc.plan_q(d, f, _common.n_sms(x.device))
            code = _common.launcher(ENTRY_Q[path], 13, 10,
                                    source="gather_swiglu_q")(
                *ptrs, w_ptr, hi.data_ptr(), lo.data_ptr(), y.data_ptr(),
                out_ptr, T, E, d, f, k, *p.args(), _common.stream_of(x))
        else:
            h = torch.empty((T * k, f), dtype=torch.float32, device=x.device)
            code = _common.launcher(ENTRY_Q[path], 12, 6)(
                *ptrs, w_ptr, h.data_ptr(), y.data_ptr(), out_ptr, T, E, d, f,
                k, _common.DTYPE_CODES[x.dtype], _common.stream_of(x))
    _common.check_launch("gather_swiglu_q", code)
    GATHER_Q.count(path)
    return y, out


def gather_swiglu_q_rows(x: torch.Tensor, qt, idx: torch.Tensor
                         ) -> torch.Tensor:
    """Launch the int8 kernels of the route of ``(x.dtype, d, f)``
    (:func:`repro_torch.kernels.moe_tc.route_q`). x: [T, d]; qt:
    ``QuantizedExpertTables`` (int8 tables, fp32 keepdim scales); idx: [T, k]
    integer expert ids (clipped to [0, E) in the kernel). Returns the
    per-pair rows [T, k, d] in ``x.dtype``. Everything must be contiguous and
    on one CUDA device; raises otherwise."""
    return _gather_q(x, qt, idx, None)[0]


def gather_swiglu_q(x: torch.Tensor, qt, idx: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """The int8 kernels' per-pair rows combined in slot order in fp32 by the
    kernel's combine pass (``ref.combine_in_order``'s bits). w: [T, k]
    combine weights. Returns [T, d] in ``x.dtype``."""
    return _gather_q(x, qt, idx, w)[1]

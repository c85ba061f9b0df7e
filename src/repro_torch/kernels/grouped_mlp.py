"""``grouped_swiglu`` and ``grouped_swiglu_q`` for Hopper: the per-expert
SwiGLU over expert-sorted rows.

Replace the TPU kernels ``repro/kernels/grouped_mlp.py :: grouped_swiglu``
and ``:: grouped_swiglu_q`` (``_kernel``, ``_kernel_q``, ``_segment_layout``).
Rows arrive sorted by expert and ``group_sizes[e]`` counts the rows of expert
e; row r goes through the expert whose segment holds it. The int8 form reads
tables quantized per (expert, output channel).

What bounds them on this card: at admission sizes (T = bucket x top_k rows)
the weight stream of the experts that are hit, ``3 * d * f`` elements each
(one byte each in int8, plus scales); the ``2 * 3 * d * f`` flops per row
take less time than that on tensor cores in bf16 (qwen3-moe at 2048 rows:
19.3 GFLOP, 0.02 ms at the bf16 peak, against 0.366 ms of bytes), but more
in fp32 on the CUDA cores.

What the design does about it: two passes on the current stream (gate/up,
then down). A block holds rows of ONE expert and finds its segment by
walking ``group_sizes`` itself (expert e contributes ``ceil(size / R)``
blocks, so a zero-sized group contributes none and cannot be confused with a
neighbour). Each form takes two routes, counted per route: plain tables by
:func:`repro_torch.kernels.moe_tc.route`, int8 tables by
:func:`repro_torch.kernels.moe_tc.route_q`.

* ``tensor_core`` (bf16 x, d and f multiples of 8 for plain tables and of 16
  for int8 ones; ``csrc/grouped_swiglu.cu`` / ``csrc/grouped_swiglu_q.cu``
  over ``csrc/moe_tc_sm90.cuh``): R = 64 rows (one warpgroup) and one column
  tile a block on ``wgmma`` (fp32 accumulate), the expert's tables streamed
  through a ``cp.async`` ring once per column tile for the whole segment
  (about 16 rows at admission), pad rows zero-filled and never stored. Int8
  tables arrive at half the bytes and are widened to bf16 in shared memory;
  their scales are applied after the sums and h crosses the passes as a bf16
  hi + lo pair (``moe_tc_sm90.cuh``'s int8 contract). The tile plan
  (:func:`repro_torch.kernels.moe_tc.plan` / ``plan_q``) and the tile code
  are the gather kernels'.
* ``cuda_core`` (fp32, other widths; ``csrc/moe_swiglu.cuh``): up to 8 rows
  in shared memory, so every weight element a block loads (and, int8,
  dequantizes with one fp32 multiply) serves 8 rows; fp32 on the CUDA cores,
  int8 with ``h`` kept fp32 between the passes.

The TPU kernels' per-expert segment padding, their ``block_expert`` table,
the scatter into a padded buffer and the blocked f axis (which made the TPU
int8 kernel only allclose to its oracle) are not carried over. A row's
arithmetic is the gather kernel's of the same form and route, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common, moe_tc, ref

GROUPED = _common.Kernel("grouped_swiglu", ref.grouped_swiglu,
                         routes=moe_tc.ROUTES)
GROUPED_Q = _common.Kernel("grouped_swiglu_q", ref.grouped_swiglu_q,
                           routes=moe_tc.ROUTES)
#: the C entry point of each route
ENTRY = {"tensor_core": "grouped_swiglu_tc_launch",
         "cuda_core": "grouped_swiglu_launch"}
ENTRY_Q = {"tensor_core": "grouped_swiglu_q_tc_launch",
           "cuda_core": "grouped_swiglu_q_launch"}

def rows_per_block(d: int, f: int) -> int:
    """Largest supported row count whose fp32 rows fit in shared memory."""
    for rows in (8, 4, 1):
        if rows * max(d, f) * 4 <= _common.SMEM_LIMIT:
            return rows
    raise ValueError(f"grouped_swiglu: a row of d={d} / f={f} fp32 values "
                     f"does not fit in shared memory")


def _check_groups(name, x, group_sizes, E):
    if group_sizes.shape != (E,) or group_sizes.device != x.device:
        raise ValueError(f"{name}: group_sizes {tuple(group_sizes.shape)} on "
                         f"{group_sizes.device} does not fit E={E} on "
                         f"{x.device}")


def grouped_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Launch the kernels of the route of ``(x.dtype, d, f)``
    (:func:`repro_torch.kernels.moe_tc.route`). x: [T, d] rows sorted by
    expert; wg/wu: [E, d, f]; wd: [E, f, d]; group_sizes: [E] integers
    summing to T (zeros are routine). Returns [T, d] in ``x.dtype``; rows
    beyond ``sum(group_sizes)`` are left unwritten. Everything must be
    contiguous and on one CUDA device; raises otherwise."""
    if not x.is_cuda:
        raise ValueError("grouped_swiglu kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    T, d, E, f = _common.check_tables("grouped_swiglu", x, wg, wu, wd)
    _check_groups("grouped_swiglu", x, group_sizes, E)
    path = moe_tc.route(x.dtype, d, f)
    if path == "cuda_core":
        rows = rows_per_block(d, f)
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    gs32 = group_sizes.to(torch.int32).contiguous()
    h = torch.empty((T, f), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            gs32.data_ptr(), h.data_ptr(), out.data_ptr())
    with torch.cuda.device(x.device):
        if path == "tensor_core":
            p = moe_tc.plan(d, f, _common.n_sms(x.device))
            code = _common.launcher(ENTRY[path], 7, 9,
                                    source="grouped_swiglu")(
                *ptrs, T, E, d, f, *p.args(), _common.stream_of(x))
        else:
            code = _common.launcher(ENTRY[path], 7, 6)(
                *ptrs, T, E, d, f, rows, _common.DTYPE_CODES[x.dtype],
                _common.stream_of(x))
    _common.check_launch("grouped_swiglu", code)
    GROUPED.count(path)
    return out


def grouped_swiglu_q(x: torch.Tensor, qt,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """Launch the int8 kernels of the route of ``(x.dtype, d, f)``
    (:func:`repro_torch.kernels.moe_tc.route_q`). x: [T, d] rows sorted by
    expert; qt: ``QuantizedExpertTables`` (int8 tables, fp32 keepdim scales);
    group_sizes: [E] integers summing to T. Returns [T, d] in ``x.dtype``.
    Everything must be contiguous and on one CUDA device; raises
    otherwise."""
    if not x.is_cuda:
        raise ValueError("grouped_swiglu_q kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    T, d, E, f = _common.check_qtables("grouped_swiglu_q", x, qt)
    _check_groups("grouped_swiglu_q", x, group_sizes, E)
    path = moe_tc.route_q(x.dtype, d, f)
    if path == "cuda_core":
        rows = rows_per_block(d, f)
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    gs32 = group_sizes.to(torch.int32).contiguous()
    ptrs = (x.data_ptr(), qt.wg.data_ptr(), qt.wu.data_ptr(), qt.wd.data_ptr(),
            qt.wg_scale.data_ptr(), qt.wu_scale.data_ptr(),
            qt.wd_scale.data_ptr(), gs32.data_ptr())
    with torch.cuda.device(x.device):
        if path == "tensor_core":
            hi = torch.empty((T, f), dtype=x.dtype, device=x.device)
            lo = torch.empty_like(hi)
            p = moe_tc.plan_q(d, f, _common.n_sms(x.device))
            code = _common.launcher(ENTRY_Q[path], 11, 9,
                                    source="grouped_swiglu_q")(
                *ptrs, hi.data_ptr(), lo.data_ptr(), out.data_ptr(), T, E, d,
                f, *p.args(), _common.stream_of(x))
        else:
            h = torch.empty((T, f), dtype=torch.float32, device=x.device)
            code = _common.launcher(ENTRY_Q[path], 10, 6)(
                *ptrs, h.data_ptr(), out.data_ptr(), T, E, d, f, rows,
                _common.DTYPE_CODES[x.dtype], _common.stream_of(x))
    _common.check_launch("grouped_swiglu_q", code)
    GROUPED_Q.count(path)
    return out

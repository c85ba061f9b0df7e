"""``grouped_swiglu`` and ``grouped_swiglu_q`` for Hopper: the per-expert
SwiGLU over expert-sorted rows.

Replace the TPU kernels ``repro/kernels/grouped_mlp.py :: grouped_swiglu``
and ``:: grouped_swiglu_q`` (``_kernel``, ``_kernel_q``, ``_segment_layout``).
Rows arrive sorted by expert and ``group_sizes[e]`` counts the rows of expert
e; row r goes through the expert whose segment holds it. The int8 form reads
tables quantized per (expert, output channel).

What bounds them on this card: at admission sizes (T = bucket x top_k rows)
the weight stream of the experts that are hit, ``3 * d * f`` elements each
(one byte each in int8, plus scales), plus ``2 * 3 * d * f`` flops per row;
with thousands of rows the operations dominate. This first version computes
on the CUDA cores in fp32 (no tensor cores), so it sits well above that
bound.

What the design does about it (``csrc/grouped_swiglu.cu``,
``csrc/grouped_swiglu_q.cu``, ``moe_swiglu.cuh``): two passes on the current
stream (gate/up, then down). A block holds up to 8 rows of ONE expert in
shared memory, so every weight element it loads (and, int8, dequantizes with
one fp32 multiply) serves 8 rows; the block finds its expert by walking
``group_sizes`` itself (expert e contributes ``ceil(size / 8)`` blocks, so a
zero-sized group contributes none and cannot be confused with a neighbour).
The int8 form keeps ``h`` fp32 between the passes. The TPU kernels'
per-expert segment padding, their ``block_expert`` table, the scatter into a
padded buffer and the blocked f axis (which made the TPU int8 kernel only
allclose to its oracle) are not carried over. A row's arithmetic is the
gather kernel's of the same form, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common, ref

GROUPED = _common.Kernel("grouped_swiglu", ref.grouped_swiglu)
GROUPED_Q = _common.Kernel("grouped_swiglu_q", ref.grouped_swiglu_q)

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
    """Launch the CUDA kernel. x: [T, d] rows sorted by expert; wg/wu:
    [E, d, f]; wd: [E, f, d]; group_sizes: [E] integers summing to T (zeros
    are routine). Returns [T, d] in ``x.dtype``; rows beyond
    ``sum(group_sizes)`` are left unwritten. Everything must be contiguous
    and on one CUDA device; raises otherwise."""
    if not x.is_cuda:
        raise ValueError("grouped_swiglu kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    T, d, E, f = _common.check_tables("grouped_swiglu", x, wg, wu, wd)
    _check_groups("grouped_swiglu", x, group_sizes, E)
    rows = rows_per_block(d, f)
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    gs32 = group_sizes.to(torch.int32).contiguous()
    h = torch.empty((T, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = _common.launcher("grouped_swiglu_launch", 7, 6)(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            gs32.data_ptr(), h.data_ptr(), out.data_ptr(), T, E, d, f, rows,
            _common.DTYPE_CODES[x.dtype], _common.stream_of(x))
    _common.check_launch("grouped_swiglu", code)
    GROUPED.count()
    return out


def grouped_swiglu_q(x: torch.Tensor, qt,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """Launch the int8 CUDA kernel. x: [T, d] rows sorted by expert; qt:
    ``QuantizedExpertTables`` (int8 tables, fp32 keepdim scales);
    group_sizes: [E] integers summing to T. Returns [T, d] in ``x.dtype``.
    Everything must be contiguous and on one CUDA device; raises
    otherwise."""
    if not x.is_cuda:
        raise ValueError("grouped_swiglu_q kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    T, d, E, f = _common.check_qtables("grouped_swiglu_q", x, qt)
    _check_groups("grouped_swiglu_q", x, group_sizes, E)
    rows = rows_per_block(d, f)
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    gs32 = group_sizes.to(torch.int32).contiguous()
    h = torch.empty((T, f), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _common.launcher("grouped_swiglu_q_launch", 10, 6)(
            x.data_ptr(), qt.wg.data_ptr(), qt.wu.data_ptr(), qt.wd.data_ptr(),
            qt.wg_scale.data_ptr(), qt.wu_scale.data_ptr(),
            qt.wd_scale.data_ptr(), gs32.data_ptr(), h.data_ptr(),
            out.data_ptr(), T, E, d, f, rows, _common.DTYPE_CODES[x.dtype],
            _common.stream_of(x))
    _common.check_launch("grouped_swiglu_q", code)
    GROUPED_Q.count()
    return out

"""``grouped_swiglu`` for Hopper: the per-expert SwiGLU over expert-sorted rows.

Replaces the TPU kernel ``repro/kernels/grouped_mlp.py :: grouped_swiglu``
(``_kernel``, ``_segment_layout``). Rows arrive sorted by expert and
``group_sizes[e]`` counts the rows of expert e; row r goes through the expert
whose segment holds it.

What bounds it on this card: at admission sizes (T = batch x bucket x top_k
rows) the weight stream of the experts that are hit, ``3 * d * f`` elements
each, plus ``2 * 3 * d * f`` flops per row; with thousands of rows the
operations dominate. This first version computes on the CUDA cores in fp32
(no tensor cores), so it sits well above that bound.

What the design does about it (``csrc/grouped_swiglu.cu``, ``moe_swiglu.cuh``):
two passes on the current stream (gate/up, then down). A block holds up to 8
rows of ONE expert in shared memory, so every weight element it loads serves
8 rows; the block finds its expert by walking ``group_sizes`` itself (expert e
contributes ``ceil(size / 8)`` blocks, so a zero-sized group contributes none
and cannot be confused with a neighbour). The TPU kernel's per-expert segment
padding, its ``block_expert`` table and the scatter into a padded buffer are
not carried over. A row's arithmetic is the gather kernel's, bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _common, ref

#: times the wrapper launched the CUDA kernel (never counts the plain version)
LAUNCHES = 0

plain = ref.grouped_swiglu

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("grouped_swiglu").grouped_swiglu_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        _FN = fn
    return _FN


def rows_per_block(d: int, f: int) -> int:
    """Largest supported row count whose fp32 rows fit in shared memory."""
    for rows in (8, 4, 1):
        if rows * max(d, f) * 4 <= _common.SMEM_LIMIT:
            return rows
    raise ValueError(f"grouped_swiglu: a row of d={d} / f={f} fp32 values "
                     f"does not fit in shared memory")


def grouped_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. x: [T, d] rows sorted by expert; wg/wu:
    [E, d, f]; wd: [E, f, d]; group_sizes: [E] integers summing to T (zeros
    are routine). Returns [T, d] in ``x.dtype``; rows beyond
    ``sum(group_sizes)`` are left unwritten. Everything must be contiguous
    and on one CUDA device; raises otherwise."""
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError("grouped_swiglu kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    T, d, E, f = _common.check_tables("grouped_swiglu", x, wg, wu, wd)
    if group_sizes.shape != (E,) or group_sizes.device != x.device:
        raise ValueError(f"grouped_swiglu: group_sizes {tuple(group_sizes.shape)}"
                         f" on {group_sizes.device} does not fit E={E} on "
                         f"{x.device}")
    rows = rows_per_block(d, f)
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    gs32 = group_sizes.to(torch.int32).contiguous()
    h = torch.empty((T, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = _fn()(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                     gs32.data_ptr(), h.data_ptr(), out.data_ptr(), T, E, d, f,
                     rows, _common.DTYPE_CODES[x.dtype],
                     torch.cuda.current_stream().cuda_stream)
    _common.check_launch("grouped_swiglu", code)
    LAUNCHES += 1
    return out

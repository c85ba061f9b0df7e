"""``swiglu_mlp`` for Hopper: the dense SwiGLU MLP
``(silu(x @ wg) * (x @ wu)) @ wd`` of every dense-family layer and of the MoE
shared experts.

Replaces the TPU kernel ``repro/kernels/swiglu.py :: swiglu_mlp``
(``_kernel``). Its contract, the reference's oracle (``kernels/ref.py``):
g and u in fp32, ``h = silu(g) * u`` rounded to x's type, the down product
accumulated in fp32 over the whole f axis, one rounding of the output.

What bounds it on this card: at decode (T up to the slot count) the weight
stream, ``3 * d * f`` elements read once (granite-8b: 352 MB in bf16, 0.105
ms at 3.35 TB/s); at admission (T of a prompt bucket) the ``2 * 3 * T * d *
f`` operations (granite-8b at T 256: 90.2 GFLOP, 0.091 ms at the bf16 tensor
peak, 1.35 ms on fp32 CUDA cores).

What the design does (``csrc/swiglu_mlp.cu``): it is one expert of
``moe_swiglu.cuh``, so its arithmetic is the MoE kernels' and a row equals
``grouped_swiglu`` with one group bit for bit. A block holds up to 8 rows and
every weight element it loads serves all of them; a thread owns two adjacent
output columns and walks its reduction axis in index order with ``fmaf``, so
a row's result does not depend on T or on its neighbours (admission alone ==
in a group, fused decode == stepwise). The rows are staged in shared memory
1024 values of the reduction axis at a time, so any width fits. Two passes on
the current stream: gate/up writes ``h [T, f]`` to device memory, down reads
it back. The TPU kernel never lets ``h`` reach HBM; keeping it on chip (and
the products on tensor cores) is the known next step. This first version runs
its fp32 arithmetic on CUDA cores.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common, ref

SWIGLU = _common.Kernel("swiglu_mlp", ref.swiglu_mlp)


def _check(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor):
    """(T, d, f) of valid arguments; raises otherwise."""
    _common._check_x("swiglu_mlp", x)
    T, d = x.shape
    if wg.dim() != 2 or wg.shape[0] != d:
        raise ValueError(f"swiglu_mlp: wg {tuple(wg.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    f = wg.shape[1]
    tabs = (("wg", wg), ("wu", wu), ("wd", wd))
    for nm, t, shape in (("wg", wg, (d, f)), ("wu", wu, (d, f)),
                         ("wd", wd, (f, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"swiglu_mlp: {nm} is {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != x.dtype:
            raise TypeError(f"swiglu_mlp: {nm} is {t.dtype}, x is {x.dtype}")
    _common._check_same_place("swiglu_mlp", x, tabs)
    return T, d, f


def swiglu_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. x: [T, d]; wg/wu: [d, f]; wd: [f, d], all in
    one type (float32 or bfloat16), contiguous, 16-byte aligned and on one
    CUDA device; raises otherwise. Returns [T, d] in x's type."""
    if not x.is_cuda:
        raise ValueError("swiglu_mlp kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    T, d, f = _check(x, wg, wu, wd)
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    h = torch.empty((T, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = _common.launcher("swiglu_mlp_launch", 6, 4)(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            h.data_ptr(), out.data_ptr(), T, d, f,
            _common.DTYPE_CODES[x.dtype], _common.stream_of(x))
    _common.check_launch("swiglu_mlp", code)
    SWIGLU.LAUNCHES += 1
    return out


def mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
        wd: torch.Tensor) -> torch.Tensor:
    """:func:`swiglu_mlp` over ``x [..., d]`` as the model hands it over:
    the leading axes are flattened (a view where x is contiguous) and
    restored on the result."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return swiglu_mlp(x2, wg, wu, wd).reshape(x.shape)

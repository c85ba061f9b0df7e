"""``swiglu_mlp`` for Hopper: the dense SwiGLU MLP
``(silu(x @ wg) * (x @ wu)) @ wd`` of every dense-family layer and of the MoE
shared experts.

Replaces the TPU kernel ``repro/kernels/swiglu.py :: swiglu_mlp``
(``_kernel``). Its contract, the reference's oracle (``kernels/ref.py``):
g and u in fp32, ``h = silu(g) * u`` rounded to x's type, the down product
accumulated in fp32 over the whole f axis, one rounding of the output.

What bounds it on this card: at decode (T up to the slot count) the weight
stream, ``3 * d * f`` elements read once (granite-8b: 352 MB in bf16, 0.105
ms at 3.35 TB/s); at admission (T of a prompt bucket) about the same bytes
and ``2 * 3 * T * d * f`` operations (granite-8b at T 256: 90.2 GFLOP, 0.091
ms at the bf16 tensor peak).

Two routes, by dtype (:func:`route`), each a hand-written kernel pair with its
own C entry point in ``csrc/swiglu_mlp.cu`` and its own launch count:

* bf16 -> ``tensor_core``: gate and up fused in one pass of 128 x 128 tiles on
  ``wgmma.m64n128k16`` (bf16 in, fp32 accumulate), x and the weight tiles
  streamed through a ``cp.async`` ring of 128-byte-swizzled shared-memory
  stages (``csrc/tc_sm90.cuh``), h rounded to bf16 in device memory; the down
  pass cuts f into S slices whose fp32 partials a third kernel sums in slice
  order. The tile plan (:func:`plan`) comes from
  (d, f, SM count) only, never from T, so a row's bits do not depend on how
  many rows share the call. d and f must be multiples of 8.
* fp32 -> ``cuda_core``: on tensor cores fp32 would become TF32, so fp32 keeps
  the pair of ``moe_swiglu.cuh`` (a thread walks its reduction axis in index
  order with ``fmaf``), bit for bit ``grouped_swiglu`` with one group. Any
  width.

``round_gu=True`` selects the model's arithmetic instead of the kernel
contract: g and u rounded to the model type before ``silu(g) * u``, the
activation rounded too, as the reference's model (``models/layers.py ::
mlp_apply``) and the port's CPU path compute it. The model's MLP sets it
(:func:`repro_torch.models.layers.mlp_apply`); :mod:`kernels.ops` keeps the
contract. In fp32 it changes nothing (rounding to fp32 is the identity).

A bf16 CUDA tensor always takes the tensor-core pair or the call raises; the
plain version runs only on CPU tensors (``kernels.ops``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Tuple

import torch

from repro_torch.kernels import _common, ref

SWIGLU = _common.Kernel("swiglu_mlp", ref.swiglu_mlp,
                        routes=("tensor_core", "cuda_core"))

#: the route of each dtype and the C entry point it launches
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
ENTRY = {"tensor_core": "swiglu_mlp_tc_launch",
         "cuda_core": "swiglu_mlp_launch"}

#: the tensor-core kernels' compiled tile (csrc/swiglu_mlp.cu: kBN, kBK,
#: kMaxSlices) and the blocks of the down pass one SM holds (97 KB of
#: shared memory each)
N_TILE, K_TILE, MAX_SLICES = 128, 64, 16
DOWN_BLOCKS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class Plan:
    """The tensor-core route's tiles for one (d, f) (:func:`plan`): output
    columns in tiles of ``n_tile`` (gate / up over f, down over d), the
    reduction in steps of ``k_tile``, and the down pass's reduction axis f cut
    at ``bounds`` (S + 1 points, 0 first and f last, the inner ones multiples
    of ``k_tile``)."""
    n_tile: int
    k_tile: int
    bounds: Tuple[int, ...]

    @property
    def slices(self) -> int:
        return len(self.bounds) - 1

    def column_tiles(self, width: int) -> List[Tuple[int, int]]:
        """The [lo, hi) columns of each block of a pass over ``width``
        outputs (f for gate / up, d for down)."""
        return [(lo, min(lo + self.n_tile, width))
                for lo in range(0, width, self.n_tile)]


def plan(d: int, f: int, n_sms: int) -> Plan:
    """The tile plan of the tensor-core route: a pure function of the widths
    and the card's SM count. S is the most slices (at most ``MAX_SLICES``,
    at most one per k-tile) for which the down pass's d / n_tile column tiles
    times S blocks still fit on the card at once; the k-tiles of f are dealt
    to the slices as evenly as whole tiles allow."""
    k_tiles = -(-f // K_TILE)
    cols = -(-d // N_TILE)
    S = max(1, min(MAX_SLICES, k_tiles, DOWN_BLOCKS_PER_SM * n_sms // cols))
    per, extra = divmod(k_tiles, S)
    cuts = [0]
    for s in range(S):
        cuts.append(cuts[-1] + per + (s < extra))
    return Plan(n_tile=N_TILE, k_tile=K_TILE,
                bounds=tuple(min(c * K_TILE, f) for c in cuts))


def route(dtype: torch.dtype) -> str:
    """``tensor_core`` for bf16, ``cuda_core`` for fp32; raises otherwise."""
    if dtype not in ROUTES:
        raise TypeError(f"swiglu_mlp: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    return ROUTES[dtype]


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
    if route(x.dtype) == "tensor_core" and (d % 8 or f % 8):
        raise ValueError(f"swiglu_mlp: bf16 needs d and f multiples of 8, "
                         f"got d={d}, f={f}")
    return T, d, f


def swiglu_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, round_gu: bool = False) -> torch.Tensor:
    """Launch the kernel pair of x's dtype (:func:`route`). x: [T, d];
    wg/wu: [d, f]; wd: [f, d], all in one type (float32 or bfloat16),
    contiguous, 16-byte aligned and on one CUDA device; bf16 with d and f
    multiples of 8. Raises otherwise. ``round_gu``: g and u rounded to the
    model type before the activation (the model's arithmetic; the identity in
    fp32). Returns [T, d] in x's type."""
    _common.check_no_grad("swiglu_mlp", x, wg, wu, wd)
    if not x.is_cuda:
        raise ValueError("swiglu_mlp kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    T, d, f = _check(x, wg, wu, wd)
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    path = route(x.dtype)
    h = torch.empty((T, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        if path == "tensor_core":
            p = plan(d, f, _common.n_sms(x.device))
            part = (torch.empty((p.slices, T, d), dtype=torch.float32,
                                device=x.device) if p.slices > 1 else None)
            bounds = (ctypes.c_int * len(p.bounds))(*p.bounds)
            code = _common.launcher(ENTRY[path], 8, 7, source="swiglu_mlp")(
                x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                h.data_ptr(), None if part is None else part.data_ptr(),
                out.data_ptr(), ctypes.cast(bounds, ctypes.c_void_p), T, d, f,
                p.n_tile, p.k_tile, p.slices, int(round_gu),
                _common.stream_of(x))
        else:
            code = _common.launcher(ENTRY[path], 6, 4)(
                x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                h.data_ptr(), out.data_ptr(), T, d, f,
                _common.DTYPE_CODES[x.dtype], _common.stream_of(x))
    _common.check_launch("swiglu_mlp", code)
    SWIGLU.count(path)
    return out


def mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
        wd: torch.Tensor, round_gu: bool = False) -> torch.Tensor:
    """:func:`swiglu_mlp` over ``x [..., d]`` as the model hands it over:
    the leading axes are flattened (a view where x is contiguous) and
    restored on the result."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return swiglu_mlp(x2, wg, wu, wd, round_gu=round_gu).reshape(x.shape)

"""Int8 expert tables and int8 KV rows (the reference's ``core/quant.py``).

Expert tables: symmetric per-expert, per-OUTPUT-channel int8. For ``wg``/``wu``
``[..., E, d, f]`` the output channel is the column ``f``, for ``wd``
``[..., E, f, d]`` the column ``d``; each (expert, channel) gets one fp32 scale
``amax / 127`` reduced over the contraction axis (``-2``) and kept at 1
(``[..., E, 1, f]`` / ``[..., E, 1, d]``). Values are ``round(w * (1 / scale))``
(round half to even, multiplied by the reciprocal, as the reference does: a
division would round differently) clipped to ``[-127, 127]``; an all-zero
channel stores scale 0 and q 0. KV rows: the same format over the last axis
(``hd``), one scale per (row, head), scales ``[..., nkv]`` without the kept
axis.

The int8 values and the scales equal the reference's bit for bit. The int8
kernels dequantize with one fp32 multiply per weight (``q * scale``) and keep
the result fp32 through the whole SwiGLU.

In a model the six tables of a layer live in a :class:`QExp` child module
named ``qexp`` of its ``MoE`` module, in place of ``wg``/``wu``/``wd``, under
the reference's leaf names (``moe.qexp.wg`` ... ``moe.qexp.wd_scale``).
:func:`quantize_moe`, :func:`quantize_model_experts`, :func:`is_quantized` and
:func:`dequantize_moe` are the reference's tree surgery done on modules.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn as nn

F32 = torch.float32
I8_MAX = 127.0

#: the six tensors of one quantized expert-table set, in a fixed order
QEXP_KEYS = ("wg", "wu", "wd", "wg_scale", "wu_scale", "wd_scale")


class QuantizedExpertTables(NamedTuple):
    """wg/wu: int8 ``[E, d, f]``; wd: int8 ``[E, f, d]``; scales fp32
    ``[E, 1, f]`` / ``[E, 1, f]`` / ``[E, 1, d]``."""
    wg: torch.Tensor
    wu: torch.Tensor
    wd: torch.Tensor
    wg_scale: torch.Tensor
    wu_scale: torch.Tensor
    wd_scale: torch.Tensor

    @property
    def n_experts(self) -> int:
        return self.wg.shape[-3]

    def dequant(self, dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(wg, wu, wd) materialized at ``dtype``."""
        return (dequantize(self.wg, self.wg_scale, dtype),
                dequantize(self.wu, self.wu_scale, dtype),
                dequantize(self.wd, self.wd_scale, dtype))


class QExp(nn.Module):
    """The six tensors of a quantized layer, as frozen parameters (so that
    ``model.parameters()`` counts them)."""

    def __init__(self, qt: QuantizedExpertTables):
        super().__init__()
        for key in QEXP_KEYS:
            setattr(self, key, nn.Parameter(getattr(qt, key),
                                            requires_grad=False))

    def tables(self) -> QuantizedExpertTables:
        return QuantizedExpertTables(*[getattr(self, k) for k in QEXP_KEYS])


def _symmetric(amax: torch.Tensor):
    """(scale, 1 / scale or 0) of symmetric int8 over channels of ``amax``.
    Both are tensor-by-tensor true divisions: on CUDA, PyTorch divides by a
    Python scalar by multiplying with its reciprocal, which rounds otherwise
    than the reference's division (and the CPU's)."""
    one = torch.ones_like(amax)
    scale = amax / torch.full_like(amax, I8_MAX)
    pos = scale > 0
    inv = torch.where(pos, one / torch.where(pos, scale, one),
                      torch.zeros_like(scale))
    return scale, inv


def quantize_channelwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over ``axis=-2``: ``(q int8, scale fp32 keepdim)``."""
    w32 = w.to(F32)
    scale, inv = _symmetric(w32.abs().amax(dim=-2, keepdim=True))
    q = torch.clamp(torch.round(w32 * inv), -I8_MAX, I8_MAX).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """``q * scale`` at fp32, cast to ``dtype``."""
    return (q.to(F32) * scale).to(dtype)


def quantize_expert_tables(wg: torch.Tensor, wu: torch.Tensor,
                           wd: torch.Tensor) -> QuantizedExpertTables:
    qg, sg = quantize_channelwise(wg)
    qu, su = quantize_channelwise(wu)
    qd, sd = quantize_channelwise(wd)
    return QuantizedExpertTables(qg, qu, qd, sg, su, sd)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis: x ``[..., nkv, hd]`` ->
    (q int8 ``[..., nkv, hd]``, scale fp32 ``[..., nkv]``)."""
    x32 = x.to(F32)
    scale, inv = _symmetric(x32.abs().amax(dim=-1))
    q = torch.clamp(torch.round(x32 * inv[..., None]),
                    -I8_MAX, I8_MAX).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """``q * scale`` at fp32 with the per-head scale broadcast over ``hd``,
    cast to ``dtype``."""
    return (q.to(F32) * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# module surgery
# ---------------------------------------------------------------------------

def is_quantized(moe: nn.Module) -> bool:
    return hasattr(moe, "qexp")


@torch.no_grad()
def quantize_moe(moe: nn.Module) -> nn.Module:
    """Replace ``wg/wu/wd`` of one MoE module by a ``qexp`` set, IN PLACE
    (the bf16 tables are freed). Router, remap, live and shared experts are
    untouched. A quantized module is returned as it is."""
    if is_quantized(moe):
        return moe
    qt = quantize_expert_tables(moe.wg, moe.wu, moe.wd)
    for key in ("wg", "wu", "wd"):
        delattr(moe, key)
    moe.qexp = QExp(qt)
    return moe


def quantize_model_experts(model: nn.Module) -> nn.Module:
    """Quantize every routed-expert table of a model (the prefix ``stack``
    and the merged suffix ``stack_c``), IN PLACE, one layer at a time."""
    for stack in model.stacks():
        for block in stack:
            if hasattr(block, "moe"):
                quantize_moe(block.moe)
    return model


@torch.no_grad()
def dequantize_moe(moe: nn.Module, dtype) -> nn.Module:
    """Inverse surgery, IN PLACE: plain ``wg/wu/wd`` at ``dtype`` from the
    ``qexp`` set. Not a stand-in for serving the int8 tables (those keep the
    dequantized weights fp32 inside the kernels)."""
    if not is_quantized(moe):
        return moe
    wg, wu, wd = moe.qexp.tables().dequant(dtype)
    del moe.qexp
    for key, t in (("wg", wg), ("wu", wu), ("wd", wd)):
        setattr(moe, key, nn.Parameter(t, requires_grad=False))
    return moe

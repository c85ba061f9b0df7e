"""The single dispatch point of the kernels.

A CUDA tensor launches the hand-written kernel or raises; a CPU tensor takes
the plain PyTorch version (:mod:`repro_torch.kernels.ref`). There is no flag
and no fallback that reroutes a CUDA tensor to the plain version. The model's
full-sequence attention (``layers._attend``) calls the flash kernel's
``attend`` itself, on the unexpanded heads: on the CPU it runs the
reference's model arithmetic (``_sdpa``), which the reference's model runs
too, rather than the flash oracle. Likewise the model's MLP
(``layers.mlp_apply``) calls the ``swiglu_mlp`` kernel's ``mlp`` on a CUDA
tensor and the reference's model arithmetic on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_moe, grouped_mlp, paged_attention as PA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels import swiglu as SW

#: every hand-written kernel by public name (``_common.Kernel``: ``name``,
#: ``plain`` and the launch count ``LAUNCHES``)
KERNELS = {k.name: k for k in (decode_moe.GATHER, grouped_mlp.GROUPED,
                               decode_moe.GATHER_Q, grouped_mlp.GROUPED_Q,
                               PA.PAGED, PA.PAGED_Q, FA.FLASH,
                               SW.SWIGLU)}


def swiglu_mlp(x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """The dense SwiGLU MLP, x: ``[T, d]``."""
    if x.is_cuda:
        return SW.swiglu_mlp(x, wg, wu, wd)
    return ref.swiglu_mlp(x, wg, wu, wd)


def gather_swiglu(x: torch.Tensor, wg, wu, wd, idx, w) -> torch.Tensor:
    """Decode-mode MoE: row t = ``sum_j w[t, j] * SwiGLU_{idx[t, j]}(x[t])``."""
    if x.is_cuda:
        return decode_moe.gather_swiglu(x, wg, wu, wd, idx, w)
    return ref.gather_swiglu(x, wg, wu, wd, idx, w)


def grouped_swiglu(x: torch.Tensor, wg, wu, wd, group_sizes) -> torch.Tensor:
    """Per-expert SwiGLU over rows sorted by expert."""
    if x.is_cuda:
        return grouped_mlp.grouped_swiglu(x, wg, wu, wd, group_sizes)
    return ref.grouped_swiglu(x, wg, wu, wd, group_sizes)


def gather_swiglu_q(x: torch.Tensor, qt, idx, w) -> torch.Tensor:
    """:func:`gather_swiglu` over int8 tables (``QuantizedExpertTables``)."""
    if x.is_cuda:
        return decode_moe.gather_swiglu_q(x, qt, idx, w)
    return ref.gather_swiglu_q(x, qt, idx, w)


def grouped_swiglu_q(x: torch.Tensor, qt, group_sizes) -> torch.Tensor:
    """:func:`grouped_swiglu` over int8 tables (``QuantizedExpertTables``)."""
    if x.is_cuda:
        return grouped_mlp.grouped_swiglu_q(x, qt, group_sizes)
    return ref.grouped_swiglu_q(x, qt, group_sizes)


def paged_attention(q: torch.Tensor, kp, vp, tab, lens) -> torch.Tensor:
    """Decode attention over a paged KV pool."""
    if q.is_cuda:
        return PA.paged_attention(q, kp, vp, tab, lens)
    return ref.paged_attention(q, kp, vp, tab, lens)


def paged_attention_q(q: torch.Tensor, kp, vp, ks, vs, tab,
                      lens) -> torch.Tensor:
    """Decode attention over an int8 paged KV pool with per-(row, head)
    fp32 scales."""
    if q.is_cuda:
        return PA.paged_attention_q(q, kp, vp, ks, vs, tab, lens)
    return ref.paged_attention_q(q, kp, vp, ks, vs, tab, lens)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence attention. q / k / v: ``[B, H, S, hd]`` (GQA expanded
    by the caller)."""
    if q.is_cuda:
        return FA.flash_attention(q, k, v, causal=causal)
    return ref.flash_attention(q, k, v, causal=causal)


def launch_counts() -> dict:
    return {name: k.LAUNCHES for name, k in KERNELS.items()}


def route_launch_counts() -> dict:
    """Launches by kernel and route (``cuda_core`` / ``tensor_core``)."""
    return {name: dict(k.ROUTE_LAUNCHES) for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.reset()

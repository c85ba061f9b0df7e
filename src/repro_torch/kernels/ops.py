"""The single dispatch point of the kernels.

A CUDA tensor launches the hand-written kernel or raises; a CPU tensor takes
the plain PyTorch version (:mod:`repro_torch.kernels.ref`). There is no flag
and no fallback that reroutes a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_moe, grouped_mlp, ref

#: the kernel modules by public name, each with ``LAUNCHES``, ``plain`` and
#: the wrapper of the same name
KERNELS = {"gather_swiglu": decode_moe, "grouped_swiglu": grouped_mlp}


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


def launch_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.LAUNCHES = 0

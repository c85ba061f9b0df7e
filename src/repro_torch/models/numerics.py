"""Precision policy of the port.

Parameters live in ``cfg.dtype`` (bf16 by default); projections accumulate in
fp32 and return the operands' type (:func:`ein`); attention logits, router
logits and LM-head logits are fp32 (:func:`ein32`, :func:`mm32`); norms and
softmax run in fp32.

On a CPU tensor the operands are upcast to fp32 first (the CPU has no fast
bf16 product and the tests compare with a reference that does the same). On
a CUDA tensor a bf16 product already accumulates in fp32 inside the library,
so :func:`ein` passes the operands through; :func:`mm32` asks the product for
an fp32 result without ever materialising an fp32 copy of the weight.
"""
from __future__ import annotations

import functools

import torch

F32 = torch.float32


def ein(eq: str, *args: torch.Tensor) -> torch.Tensor:
    """Projection einsum: fp32 accumulate, result in the operands' type."""
    out_dtype = functools.reduce(torch.promote_types, [a.dtype for a in args])
    if args[0].is_cuda:
        return torch.einsum(eq, *[a.to(out_dtype) for a in args])
    return torch.einsum(eq, *[a.to(F32) for a in args]).to(out_dtype)


def ein32(eq: str, *args: torch.Tensor) -> torch.Tensor:
    """einsum with an fp32 result, for small precision-critical products
    (attention logits, router logits): the operands are upcast."""
    return torch.einsum(eq, *[a.to(F32) for a in args])


@functools.lru_cache(maxsize=None)
def mm_out_dtype_available() -> bool:
    """Whether this PyTorch's CUDA ``torch.mm`` takes ``out_dtype`` (bf16
    operands, fp32 result, no fp32 copy of either operand)."""
    a = torch.zeros((8, 8), dtype=torch.bfloat16, device="cuda")
    try:
        return torch.mm(a, a, out_dtype=F32).dtype == F32
    except (TypeError, RuntimeError, NotImplementedError):
        return False


def mm32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., d] @ w [d, v]`` with an fp32 result: the LM head.

    CPU, or fp32 operands: upcast and multiply. CUDA with low-precision
    operands: ``torch.mm(..., out_dtype=float32)`` where this PyTorch has it,
    so the ``[d, vocab]`` weight is never copied to fp32; otherwise the
    product is rounded to the operands' type and then widened (greedy argmax
    then sees bf16 logits, and :func:`mm_out_dtype_available` says so)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not x.is_cuda or (x.dtype == F32 and w.dtype == F32):
        out = x2.to(F32) @ w.to(F32)
    elif mm_out_dtype_available():
        out = torch.mm(x2, w.to(x2.dtype), out_dtype=F32)
    else:
        out = (x2 @ w.to(x2.dtype)).to(F32)
    return out.reshape(*lead, w.shape[-1])

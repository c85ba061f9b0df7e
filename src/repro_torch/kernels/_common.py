"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

#: dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: bytes of shared memory one block may ask for on sm_90
SMEM_LIMIT = 227 * 1024


def check_tables(name: str, x: torch.Tensor, wg: torch.Tensor,
                 wu: torch.Tensor, wd: torch.Tensor):
    """Validate activations and expert tables; returns (T, d, E, f)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    if x.dim() != 2 or wg.dim() != 3 or wu.dim() != 3 or wd.dim() != 3:
        raise ValueError(f"{name}: expected x [T, d], wg/wu [E, d, f], "
                         f"wd [E, f, d]")
    T, d = x.shape
    E, d2, f = wg.shape
    if d2 != d or wu.shape != (E, d, f) or wd.shape != (E, f, d):
        raise ValueError(
            f"{name}: table shapes {tuple(wg.shape)}, {tuple(wu.shape)}, "
            f"{tuple(wd.shape)} do not fit x {tuple(x.shape)}")
    if E < 1:
        raise ValueError(f"{name}: empty expert table")
    for nm, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {nm} is {t.dtype}, x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: {nm} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {nm} must be 16-byte aligned")
    return T, d, E, f


def check_launch(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch refused, "
                           f"cudaGetLastError() = {code}")

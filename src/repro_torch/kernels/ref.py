"""Plain PyTorch versions of the two MoE kernels of the serving path.

Device-agnostic, the same arithmetic and rounding points as the reference's
jnp oracles: gate and up products in fp32, ``silu(g) * u`` rounded to the
model type, the down product in fp32 rounded to the model type, and (for the
gather form) an fp32 weighted sum over the k slots rounded once. The CPU path
of :mod:`repro_torch.kernels.ops` runs these; on the card they are only what
the hand-written kernels are held against.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32

#: rows whose gathered fp32 tables are held at once (bounds the plain
#: version's memory: chunk * 3 * d * f * 4 bytes)
_CHUNK_BYTES = 1 << 30


def _rows_swiglu(x: torch.Tensor, eid: torch.Tensor, wg: torch.Tensor,
                 wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Row r of ``x`` through expert ``eid[r]``; result in ``x.dtype``.
    One batched product per row, so a row's arithmetic does not depend on
    which other rows share the call."""
    n, d = x.shape
    f = wg.shape[-1]
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    chunk = max(1, _CHUNK_BYTES // (3 * d * f * 4))
    for lo in range(0, n, chunk):
        e = eid[lo:lo + chunk]
        xr = x[lo:lo + chunk].to(F32).unsqueeze(1)               # [c, 1, d]
        g = torch.bmm(xr, wg[e].to(F32))                         # [c, 1, f]
        u = torch.bmm(xr, wu[e].to(F32))
        h = (F.silu(g) * u).to(x.dtype)
        y = torch.bmm(h.to(F32), wd[e].to(F32))                  # [c, 1, d]
        out[lo:lo + chunk] = y.squeeze(1).to(x.dtype)
    return out


def combine_in_order(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_j w[t, j] * y[t, j]`` in fp32, j ascending, the product and the
    sum rounded separately, starting from zero. y: [T, k, d]; w: [T, k].
    Returns fp32 [T, d]. Written as a loop so that the order is the same on
    every device and equals the gather kernel's."""
    T, k, d = y.shape
    acc = torch.zeros((T, d), dtype=F32, device=y.device)
    wf = w.to(F32)
    for j in range(k):
        acc = acc + y[:, j].to(F32) * wf[:, j, None]
    return acc


def rows_to_experts(group_sizes: torch.Tensor, T: int) -> torch.Tensor:
    """Expert id of each of the T expert-sorted rows. ``repeat_interleave``
    emits each id exactly ``size`` times, so zero-sized groups cannot be
    mistaken for a neighbour (a ``searchsorted`` over the segment starts
    would have to special-case their duplicate entries)."""
    E = group_sizes.shape[0]
    return torch.repeat_interleave(
        torch.arange(E, device=group_sizes.device),
        group_sizes.to(torch.long), output_size=T)


def grouped_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x: [T, d] rows sorted by expert; wg/wu: [E, d, f]; wd: [E, f, d];
    group_sizes: [E] integers summing to T. Returns [T, d]."""
    T = x.shape[0]
    if T == 0:
        return torch.zeros_like(x)
    return _rows_swiglu(x, rows_to_experts(group_sizes, T), wg, wu, wd)


def gather_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                  wd: torch.Tensor, idx: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """x: [T, d]; idx: [T, k] expert ids (clipped to [0, E)); w: [T, k]
    combine weights. Row t = ``sum_j w[t, j] * SwiGLU_{idx[t, j]}(x[t])``."""
    T, d = x.shape
    k = idx.shape[-1]
    E = wg.shape[0]
    if T == 0:
        return torch.zeros((0, d), dtype=x.dtype, device=x.device)
    eid = idx.reshape(-1).to(torch.long).clamp(0, E - 1)
    y = _rows_swiglu(x.repeat_interleave(k, dim=0), eid, wg, wu, wd)
    return combine_in_order(y.reshape(T, k, d), w).to(x.dtype)

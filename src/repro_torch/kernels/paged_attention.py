"""``paged_attention`` and ``paged_attention_q`` for Hopper: decode attention
over the paged KV pool.

Replace the TPU kernels ``repro/kernels/paged_attention.py ::
paged_attention`` and ``:: paged_attention_q`` (``_kernel``, ``_kernel_q``,
``_update``). q ``[B, nq, hd]`` is the current token's query (its K/V row is
already in the pool); the pools ``[n_blocks, bs, nkv, hd]`` hold rows in
blocks, slot b's blocks listed in ``tab[b]`` (entries ``>= n_blocks`` are
sentinels: clipped, then masked), and ``lens[b]`` rows are valid. The int8
form reads int8 pools with per-(row, head) fp32 scales ``[n_blocks, bs, nkv]``.

What bounds them on this card: bytes. Each valid row is read once per kv
head, ``2 * lens * nkv * hd`` elements per slot (one byte each in int8, plus
the scales), for about two flops per byte: some microseconds at the serve
shape, so the launch itself dominates.

What the design does about it (``csrc/paged_attention.cuh``, one source per
pool type): one block per (slot, kv head), its ``n_rep`` query heads one warp
each, so every K/V row is loaded once for all of them (GQA); the block walks
the slot's table entries in order, stages one pool block's valid rows in
shared memory as fp32 (int8: one fp32 multiply by the row's scale) and
carries the online-softmax state (running max, normaliser, fp32 accumulator)
in registers from entry to entry, where the TPU kernel carried it in VMEM
across its sequential grid. Rows past ``lens`` are never loaded, so a
clipped sentinel or a stale block contributes exactly nothing. At the serve
shape B x nkv = 32 blocks leave most of the 132 SMs idle; splitting the table
walk across blocks with a second combine pass is the known fix, later work.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _common, ref

PAGED = _common.Kernel("paged_attention", ref.paged_attention)
PAGED_Q = _common.Kernel("paged_attention_q", ref.paged_attention_q)

def _check(name, q, kp, vp, tab, lens, pool_dtype):
    if q.dtype not in _common.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if q.dim() != 3 or kp.dim() != 4 or vp.shape != kp.shape:
        raise ValueError(f"{name}: expected q [B, nq, hd] and pools "
                         f"[n_blocks, bs, nkv, hd]")
    B, nq, hd = q.shape
    nb, bs, nkv, hd2 = kp.shape
    if hd2 != hd or nkv < 1 or nq % nkv or nq // nkv > 32 or hd > 256:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(kp.shape)} (nq a multiple of nkv, at most "
                         f"32 query heads per kv head, hd <= 256)")
    if nb < 1 or bs < 1:
        raise ValueError(f"{name}: empty pool {tuple(kp.shape)}")
    if tab.dim() != 2 or tab.shape[0] != B or tuple(lens.shape) != (B,):
        raise ValueError(f"{name}: tab {tuple(tab.shape)} / lens "
                         f"{tuple(lens.shape)} do not fit B={B}")
    for nm, t in (("kp", kp), ("vp", vp)):
        if t.dtype != pool_dtype:
            raise TypeError(f"{name}: {nm} is {t.dtype}, expected {pool_dtype}")
    for nm, t in (("q", q), ("kp", kp), ("vp", vp), ("tab", tab),
                  ("lens", lens)):
        if t.device != q.device:
            raise ValueError(f"{name}: {nm} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    mb = tab.shape[1]
    smem = (nq // nkv * hd + bs * (hd + 1) + bs * hd) * 4
    if smem > _common.SMEM_LIMIT:
        raise ValueError(f"{name}: a pool block of bs={bs} rows does not fit "
                         f"in shared memory")
    return B, nq, hd, nb, bs, nkv, mb


def _launch(kernel, symbol, ptrs, q, dims):
    B, nq, hd, nb, bs, nkv, mb = dims
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(q.device):
        code = _common.launcher(symbol, len(ptrs) + 1, 7,
                                tail=(ctypes.c_float, ctypes.c_int))(
            *ptrs, out.data_ptr(), B, nb, bs, nkv, hd, mb, nq // nkv,
            math.sqrt(hd), _common.DTYPE_CODES[q.dtype], _common.stream_of(q))
    _common.check_launch(kernel.name, code)
    kernel.count()
    return out


def paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    tab: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. q: [B, nq, hd]; kp/vp: [n_blocks, bs, nkv,
    hd] in ``q.dtype``; tab: [B, mb] integer block ids; lens: [B] valid
    rows. Returns [B, nq, hd] in ``q.dtype``. Everything must be contiguous
    and on one CUDA device; raises otherwise."""
    if not q.is_cuda:
        raise ValueError("paged_attention kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    tab = tab.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    dims = _check("paged_attention", q, kp, vp, tab, lens, q.dtype)
    return _launch(PAGED, "paged_attention_launch",
                   (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tab.data_ptr(),
                    lens.data_ptr()), q, dims)


def paged_attention_q(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                      ks: torch.Tensor, vs: torch.Tensor, tab: torch.Tensor,
                      lens: torch.Tensor) -> torch.Tensor:
    """Launch the int8 CUDA kernel. kp/vp: int8 [n_blocks, bs, nkv, hd];
    ks/vs: fp32 [n_blocks, bs, nkv]; the rest as :func:`paged_attention`."""
    if not q.is_cuda:
        raise ValueError("paged_attention_q kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    tab = tab.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    dims = _check("paged_attention_q", q, kp, vp, tab, lens, torch.int8)
    for nm, t in (("ks", ks), ("vs", vs)):
        if tuple(t.shape) != tuple(kp.shape[:3]) or t.dtype != torch.float32:
            raise ValueError(f"paged_attention_q: {nm} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {tuple(kp.shape[:3])} "
                             f"float32")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attention_q: {nm} must be contiguous on "
                             f"{q.device}")
    return _launch(PAGED_Q, "paged_attention_q_launch",
                   (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
                    vs.data_ptr(), tab.data_ptr(), lens.data_ptr()), q, dims)

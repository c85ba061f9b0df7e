"""``flash_attention`` for Hopper: full-sequence attention with an online
softmax, never materialising the ``[Sq, Sk]`` logits.

Replaces the TPU kernel ``repro/kernels/flash_attention.py ::
flash_attention`` (``_kernel``). q ``[B, H, Sq, hd]``, k / v ``[B, H, Sk,
hd]`` -> ``[B, H, Sq, hd]`` in q's type; ``causal`` masks with the plain
version's bottom-right alignment (query row i sees the keys up to
``i + Sk - Sq``). The TPU kernel masks and skips blocks top-left
(``rows >= cols``): the two agree only when ``Sq == Sk``, and this port
follows the plain version (ROADMAP R4). A row that sees no key (causal,
``Sq > Sk``) weighs every key equally, as the plain version's fully masked
softmax does.

Two routes, by dtype (:func:`route`), each with its own C entry point in
``csrc/flash_attention.cu`` and its own launch count:

* bf16 -> ``tensor_core``, FlashAttention-2 style: a block owns 64 query rows
  of one head, a warp 16 of them; ``S = Q K^T`` and ``O += P V`` run on
  ``mma.m16n8k16`` (bf16 in, fp32 accumulate) with K/V tiles of 64 keys
  double-buffered by ``cp.async`` (``csrc/tc_sm90.cuh``); the running max and
  sum of a row stay in registers. hd a multiple of 16 up to 256; strides
  multiples of 8 elements and bases 16-byte aligned (one copy moves 8
  values).
* fp32 -> ``cuda_core``: on tensor cores fp32 would become TF32, so fp32 keeps
  the CUDA-core kernel: one block per 64 query rows of a head, K/V tiles of
  64 keys staged in shared memory as fp32, each row's state carried across
  tiles in 32-key chunks.

What bounds it on this card: at the port's shapes (hd 128, S up to 512) the
work is small, so neither bytes nor operations: latency, one short wave of
blocks of four warps; and on the host, the wrapper's Python call, which takes
longer than the kernel.

Both keep a row's result a function of its position and the keys it sees
only: key tiles aligned at absolute key positions and walked in order, a key
the row does not see contributing exactly 0 (batch and tile invariant: a
prompt's rows equal the same rows of a longer prefill or of a
prefix-sharing admission, bitwise). ``p`` is rounded to v's type before the
value product, one division by ``l`` at the end with ``l == 0 -> 1``.

Two extensions of the C entry point serve the model path without copies
(:func:`attend`): unexpanded K/V ``[B, nkv, Sk, hd]`` with head h reading kv
head ``h // n_rep`` (GQA), tensors addressed through their strides (the
model's ``[B, S, H, hd]`` activations read in place), and per-row query
offsets ``qoff [B]`` for the causal mask (row i of batch row b sees the keys
up to ``qoff[b] + i``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _common, ref

FLASH = _common.Kernel("flash_attention", ref.flash_attention,
                       routes=("tensor_core", "cuda_core"))

#: the route of each dtype and the C entry point it launches
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
ENTRY = {"tensor_core": "flash_attention_tc_launch",
         "cuda_core": "flash_attention_launch"}


def route(dtype: torch.dtype) -> str:
    """``tensor_core`` for bf16, ``cuda_core`` for fp32; raises otherwise."""
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    return ROUTES[dtype]


def _smem(hd: int) -> int:
    """Bytes of fp32 shared memory one block of the CUDA-core kernel takes
    (csrc/flash_attention.cu): K [64, hd + 1], V [64, hd], q and accumulators
    [64, hd] each, m, l [64]."""
    return (64 * (hd + 1) + 64 * hd + 2 * 64 * hd + 2 * 64) * 4


def _check_tc(hd: int, tensors) -> None:
    """What the tensor-core kernel needs beyond the shared checks: hd a
    multiple of 16 up to 256, every stride a multiple of 8 elements and
    every base 16-byte aligned (its copies move 16 bytes)."""
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"flash_attention: bf16 needs hd a multiple of 16 "
                         f"up to 256, got {hd}")
    for nm, t in tensors:
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(f"flash_attention: bf16 needs {nm} 16-byte "
                             f"aligned with strides multiples of 8, got "
                             f"strides {t.stride()}")


def _strides(t: torch.Tensor, name: str):
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous last "
                         f"axis, got strides {t.stride()}")
    return t.stride(0), t.stride(1), t.stride(2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           qoff: Optional[torch.Tensor], out: Optional[torch.Tensor]) -> str:
    """The route of valid arguments (see :func:`attend`); raises otherwise,
    before anything is launched."""
    path = route(q.dtype)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: expected q [B, H, Sq, hd] and "
                         f"k / v [B, nkv, Sk, hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Bk, nkv, Sk, hd2 = k.shape
    if Bk != B or hd2 != hd or nkv < 1 or H % nkv or hd > 256:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)} (H a multiple of nkv, hd <= 256)")
    for nm, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {nm} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {nm} on {t.device}, q on "
                             f"{q.device}")
    if path == "cuda_core" and _smem(hd) > _common.SMEM_LIMIT:
        raise ValueError(f"flash_attention: hd={hd} does not fit in shared "
                         f"memory")
    if qoff is not None and (tuple(qoff.shape) != (B,)
                             or qoff.device != q.device):
        raise ValueError(f"flash_attention: qoff must be [B={B}] on "
                         f"{q.device}, got {tuple(qoff.shape)}")
    if out is not None and (tuple(out.shape) != (B, H, Sq, hd)
                            or out.dtype != q.dtype
                            or out.device != q.device):
        raise ValueError(f"flash_attention: out {tuple(out.shape)} "
                         f"{out.dtype} does not fit q")
    if path == "tensor_core":
        _check_tc(hd, [("q", q), ("k", k), ("v", v)]
                  + ([] if out is None else [("out", out)]))
    return path


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           qoff: Optional[torch.Tensor] = None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel of q's dtype (:func:`route`). q: ``[B, H, Sq,
    hd]``; k / v: ``[B, nkv, Sk, hd]`` with ``H`` a multiple of ``nkv`` (head
    h reads kv head ``h // (H // nkv)``); any strides with a contiguous last
    axis (bf16: strides multiples of 8, bases 16-byte aligned, hd a multiple
    of 16). qoff: optional ``[B]`` integer query offsets of the causal mask
    (default ``Sk - Sq``). out: optional ``[B, H, Sq, hd]`` destination in
    ``q.dtype`` (any strides with a contiguous last axis), else a new
    contiguous tensor. Returns it. Everything on one CUDA device; raises
    otherwise."""
    if not q.is_cuda:
        raise ValueError("flash_attention kernel needs CUDA tensors "
                         "(kernels.ops routes CPU tensors to the plain version)")
    path = _check(q, k, v, qoff, out)
    B, H, Sq, hd = q.shape
    Sk, nkv = k.shape[2], k.shape[1]
    if qoff is not None:
        qoff = qoff.to(torch.int32).contiguous()
    if out is None:
        out = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    if B == 0 or H == 0 or Sq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"),
        *_strides(out, "out"))
    with torch.cuda.device(q.device):
        fn = _common.launcher(ENTRY[path], 6, 7,
                              tail=(ctypes.c_float, ctypes.c_int),
                              source="flash_attention")
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if qoff is None else qoff.data_ptr(),
                  ctypes.cast(strides, ctypes.c_void_p), B, H, Sq, Sk, hd,
                  H // nkv, int(causal), 1.0 / math.sqrt(hd),
                  _common.DTYPE_CODES[q.dtype], _common.stream_of(q))
    _common.check_launch(FLASH.name, code)
    FLASH.count(path)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The reference's signature: q / k / v ``[B, H, S, hd]`` (GQA expanded
    by the caller) -> ``[B, H, Sq, hd]``."""
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"flash_attention: q has {q.shape[1]} heads, k "
                         f"{k.shape[1]} (expand GQA first, or call attend)")
    return attend(q, k, v, causal)

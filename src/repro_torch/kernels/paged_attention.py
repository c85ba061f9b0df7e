"""``paged_attention`` and ``paged_attention_q`` for Hopper: decode attention
over the paged KV pool.

Replace the TPU kernels ``repro/kernels/paged_attention.py ::
paged_attention`` and ``:: paged_attention_q`` (``_kernel``, ``_kernel_q``,
``_update``). q ``[B, nq, hd]`` is the current token's query (its K/V row is
already in the pool); the pools ``[n_blocks, bs, nkv, hd]`` hold rows in
blocks, slot b's blocks listed in ``tab[b]`` (entries ``>= n_blocks`` are
sentinels: clipped, then masked), and ``lens[b]`` rows are valid. The int8
form reads int8 pools with per-(row, head) fp32 scales ``[n_blocks, bs, nkv]``.

What bounds them on this card: bytes, then latency. Each valid row is read
once per kv head, ``2 * lens * nkv * hd`` elements per slot (one byte each in
int8, plus the scales), for n_rep flops a byte (about 2 n_rep in int8): below
the fp32 CUDA-core ridge of about 20, so the kernels stay fp32 on CUDA cores
in both pool types (rows, logits, softmax and accumulator in fp32, rounded
once at the output). At the serve shape the bytes take under a microsecond
(0.71 us for qwen3-moe), so the latency of the loads and the two launches set
the time.

What the design does about it (``csrc/paged_attention.cuh``, one source per
pool type): the table walk is split. A split is ``split_rows(bs)`` rows
(``SPLIT_ROWS`` at the served bs of 16, a whole number of table entries), a
slot has ``n_splits(mb, bs)`` of them, and the split pass runs one block per
(split, kv head, slot): its ``n_rep`` query heads share every K/V row (GQA),
the rows stream through a ring of ``STAGES`` stages of ``CHUNK_ROWS`` rows by
16-byte ``cp.async`` in the pool's type, the logits use eight lanes a row and
a shuffle tree, and the online softmax runs over the split's rows in
ascending order. Each block writes its partial (unnormalised accumulator, running max,
normaliser) to an fp32 workspace; the combine pass merges a slot's partials
in ascending split order and rounds once. The plan reads (mb, bs) and nothing
else (not B, the pool size or the SM count), and the wrapper never reads
``lens`` on the host, so a slot gives the same bits alone or among others, in
a dense cache's contiguous table or in the pool's, and the call can be
captured in a CUDA graph. Rows past ``lens`` are never loaded, so a clipped
sentinel or a stale block contributes exactly nothing.

Measured on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``'s kernels
phase, calls replayed from a CUDA graph) at qwen3-moe's serve shape (8 slots,
32 / 4 heads, hd 128, bs 16, lens 51 to 239): 0.011 ms for the bf16 pool and
0.012 ms for the int8 pool, against 0.067 and 0.069 ms for the single-pass
kernel (one block per slot and kv head) this design replaced; the bytes
would take 0.71 and 0.38 us, so the two launches and the latency of a
block's loads set the time. The wrapper's own host work (checks, the
workspace, the call) is about 0.03 ms.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _common, ref

PAGED = _common.Kernel("paged_attention", ref.paged_attention)
PAGED_Q = _common.Kernel("paged_attention_q", ref.paged_attention_q)

#: the split plan's constants, as ``csrc/paged_attention.cuh`` has them:
#: rows a split at bs <= 32 (``kSplitRows``), rows a ring stage
#: (``kChunkRows``), the ring's stages (``kStages``)
SPLIT_ROWS = 32
CHUNK_ROWS = 16
STAGES = 2


def split_rows(bs: int) -> int:
    """Rows of one split: a whole number of table entries, the largest that
    fits in ``SPLIT_ROWS`` (one entry when bs is larger)."""
    return max(1, SPLIT_ROWS // bs) * bs


def n_splits(mb: int, bs: int) -> int:
    """Splits of a slot's table: the split pass's grid extent and the
    workspace's split axis. A function of the table's shape only."""
    return -(-mb * bs // split_rows(bs))


def smem_bytes(n_rep: int, hd: int, elt: int, q_elt: int, int8: bool) -> int:
    """Dynamic shared memory of the split pass (``paged::smem_bytes``): K and
    V ring stages in the pool's type (``elt`` bytes), q in its own type
    (``q_elt``), (int8) the rows' scales, the logits, the softmax state and
    the split's table entries."""
    return (2 * STAGES * CHUNK_ROWS * hd * elt + n_rep * hd * q_elt
            + (2 * STAGES * CHUNK_ROWS * 4 if int8 else 0)
            + n_rep * CHUNK_ROWS * 4 + 3 * n_rep * 4 + SPLIT_ROWS * 4)


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
    elt = kp.element_size()
    if hd * elt % 16 or any(t.data_ptr() % 16 for t in (q, kp, vp)):
        raise ValueError(f"{name}: pool rows of hd={hd} x {elt} bytes must be "
                         f"a multiple of 16 bytes and q and the pools 16-byte "
                         f"aligned (rows arrive by 16-byte copies)")
    mb = tab.shape[1]
    smem = smem_bytes(nq // nkv, hd, elt, q.element_size(),
                      pool_dtype == torch.int8)
    if smem > _common.SMEM_LIMIT:
        raise ValueError(f"{name}: the split pass needs {smem} bytes of shared "
                         f"memory, more than {_common.SMEM_LIMIT}")
    return B, nq, hd, nb, bs, nkv, mb


def _launch(kernel, symbol, ptrs, q, dims):
    """Both passes: the split pass into a fresh fp32 workspace of B * nq *
    n_splits(mb, bs) partials of hd + 2 numbers, then the combine pass into
    the output. One launch on the kernel's count per call."""
    B, nq, hd, nb, bs, nkv, mb = dims
    out = torch.empty_like(q)
    if B == 0:
        return out
    ws = torch.empty(B * nq * n_splits(mb, bs) * (hd + 2), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        code = _common.launcher(symbol, len(ptrs) + 2, 7,
                                tail=(ctypes.c_float, ctypes.c_int))(
            *ptrs, ws.data_ptr(), out.data_ptr(), B, nb, bs, nkv, hd, mb,
            nq // nkv, math.sqrt(hd), _common.DTYPE_CODES[q.dtype],
            _common.stream_of(q))
    _common.check_launch(kernel.name, code)
    kernel.count()
    return out


def paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    tab: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. q: [B, nq, hd]; kp/vp: [n_blocks, bs, nkv,
    hd] in ``q.dtype``; tab: [B, mb] integer block ids; lens: [B] valid
    rows. Returns [B, nq, hd] in ``q.dtype``. Everything must be contiguous
    and on one CUDA device; raises otherwise."""
    _common.check_no_grad("paged_attention", q, kp, vp)
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
    _common.check_no_grad("paged_attention_q", q)
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

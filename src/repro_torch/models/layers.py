"""Core layers of the serving path: RMSNorm, RoPE, GQA attention (prefill,
per-slot decode, and decode / verify-shaped admission over the paged KV pool),
SwiGLU MLP, embedding and LM head.

``nn.Module``s own the parameters (``requires_grad=False``); the arithmetic is
in plain functions on tensors that take the module as ``p``, mirroring the
reference's ``*_apply(p, x)`` functions one for one. Precision policy as in
:mod:`repro_torch.models.numerics`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.core import quant as Q
from repro_torch.models.config import ModelConfig
from repro_torch.models.numerics import ein, ein32, mm32

F32 = torch.float32


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def dense_init(shape, dtype, device, generator: torch.Generator,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, scale^2) weights (scale defaults to 1/sqrt(fan_in)), drawn
    directly in ``dtype`` on ``device``: no fp32 copy of a large leaf."""
    if scale is None:
        fan_in = shape[-2] if len(shape) > 1 else shape[0]
        scale = 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=dtype, device=device)
    w.normal_(0.0, 1.0, generator=generator)
    return w.mul_(scale)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = _param(torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=F32, device=device) ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Split-half rotation in fp32. x: [..., S, H, hd]; positions:
    broadcastable to [..., S]."""
    angles = positions[..., :, None].to(F32) * inv_freq       # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        dt = cfg.param_dtype
        self.wq = _param(dense_init((d, nq * hd), dt, device, generator))
        self.wk = _param(dense_init((d, nkv * hd), dt, device, generator))
        self.wv = _param(dense_init((d, nkv * hd), dt, device, generator))
        self.wo = _param(dense_init((nq * hd, d), dt, device, generator))
        if cfg.qkv_bias:
            self.bq = _param(torch.zeros((nq * hd,), dtype=dt, device=device))
            self.bk = _param(torch.zeros((nkv * hd,), dtype=dt, device=device))
            self.bv = _param(torch.zeros((nkv * hd,), dtype=dt, device=device))


def _qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor):
    B, S, _ = x.shape
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = ein("bsd,dh->bsh", x, p.wq)
    k = ein("bsd,dh->bsh", x, p.wk)
    v = ein("bsd,dh->bsh", x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq.to(q.dtype)
        k = k + p.bk.to(k.dtype)
        v = v + p.bv.to(v.dtype)
    q = q.to(x.dtype).reshape(B, S, nq, hd)
    k = k.to(x.dtype).reshape(B, S, nkv, hd)
    v = v.to(x.dtype).reshape(B, S, nkv, hd)
    return q, k, v


def _sdpa(q, k, v, mask, n_rep: int):
    """q: [B,Sq,nq,hd]; k, v: [B,Skv,nkv,hd]; mask broadcastable to
    [B,nq,Sq,Skv] (True = attend) or None. GQA by repeating each kv head
    ``n_rep`` times in place (head h reads kv head h // n_rep). fp32 logits,
    masked entries filled with the most negative finite fp32 (a fully masked
    row stays finite), fp32 softmax cast to ``v.dtype`` before the value
    product. Plain PyTorch on purpose: the reference leaves this to its
    compiler and so does this slice."""
    hd = q.shape[-1]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    logits = ein32("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(F32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return ein("bhqk,bkhd->bqhd", probs, v).to(v.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_rep: int,
            causal: bool = True,
            qoff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention of the model path. q: ``[B, Sq, nq, hd]``;
    k / v: ``[B, Sk, nkv, hd]`` (head h reads kv head ``h // n_rep``);
    causal: query row i of batch row b sees the keys up to ``qoff[b] + i``
    (``qoff`` None: up to ``i + Sk - Sq``). Returns ``[B, Sq, nq, hd]``.

    The choice is by device, never a fallback. On a CUDA tensor the
    hand-written ``flash_attention`` kernel runs, on the unexpanded K/V and
    the activations in place (``kernels.flash_attention.attend``); a kernel
    failure raises. On a CPU tensor the reference's own model arithmetic,
    :func:`_sdpa`, runs, so that the CPU path stays token and logit equal
    to the reference's model (which never calls its flash kernel)."""
    B, Sq, nq, hd = q.shape
    Sk = k.shape[1]
    if q.is_cuda:
        from repro_torch.kernels import flash_attention as FA
        out = torch.empty((B, Sq, nq, hd), dtype=q.dtype, device=q.device)
        FA.attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal, qoff=qoff, out=out.transpose(1, 2))
        return out
    mask = None
    if causal and qoff is None:
        mask = torch.tril(torch.ones((Sq, Sk), dtype=torch.bool,
                                     device=q.device),
                          diagonal=Sk - Sq)[None, None, :, :]
    elif causal:
        last = qoff.to(q.device)[:, None] + torch.arange(Sq, device=q.device)
        mask = (torch.arange(Sk, device=q.device)[None, None, :]
                <= last[:, :, None])[:, None, :, :]          # [B, 1, Sq, Sk]
    return _sdpa(q, k, v, mask, n_rep)


def attn_apply(cfg: ModelConfig, p: Attention, x: torch.Tensor, *, inv_freq,
               positions=None, causal: bool = True,
               kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence self-attention (forward / capture / loss). Returns
    ``[B, S, d]``. Cross-attention (``kv``, the whisper decoder) is not
    ported."""
    if kv is not None:
        raise NotImplementedError(
            "cross-attention (kv=...) belongs to the encoder-decoder family, "
            "which is not ported yet")
    B, S, _ = x.shape
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qkv(cfg, p, x)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    out = _attend(q, k, v, n_rep, causal=causal)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd)
    return ein("bsh,hd->bsd", out, p.wo).to(x.dtype)


def attn_prefill(cfg: ModelConfig, p: Attention, x: torch.Tensor, *, inv_freq):
    """Causal full-sequence attention that also returns the (k, v) to seed a
    decode cache. Returns (out [B,S,d], k [B,S,nkv,hd], v [B,S,nkv,hd])."""
    B, S, _ = x.shape
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qkv(cfg, p, x)
    positions = torch.arange(S, device=x.device)[None, :]
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    out = _attend(q, k, v, n_rep)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd)
    out = ein("bsh,hd->bsd", out, p.wo).to(x.dtype)
    return out, k, v


class DecodeView(NamedTuple):
    """What dense decode needs besides the cache, the same in every layer of
    one step (built once per step by :func:`decode_view`): the slot index
    ``b_iota`` and the row each slot writes (``row``, clamped; ``in_range``
    false for a frozen slot), and the cache seen as a pool of
    ``block_size``-row blocks: the contiguous table ``tab`` (int32) and the
    visible rows ``lens``."""
    b_iota: torch.Tensor
    row: torch.Tensor
    in_range: torch.Tensor
    tab: torch.Tensor
    lens: torch.Tensor
    block_size: int


def decode_view(pos: torch.Tensor, rows: int, s_max: Optional[int] = None,
                block_size: Optional[int] = None) -> DecodeView:
    """The :class:`DecodeView` of a dense cache of ``rows`` rows per slot at
    positions ``pos`` [B]: ``s_max`` (default ``rows``) is the slot capacity,
    ``block_size`` (default ``rows``) divides ``rows``; ``tab[b, j] = b *
    rows / block_size + j`` and ``lens = min(pos + 1, s_max)``."""
    s_max = rows if s_max is None else s_max
    bs = rows if block_size is None else block_size
    if rows % bs or not 0 < s_max <= rows:
        raise ValueError(f"a cache of {rows} rows does not fit s_max={s_max} "
                         f"in blocks of {bs} rows")
    B, dev = pos.shape[0], pos.device
    b_iota = torch.arange(B, device=dev)
    mb = rows // bs
    tab = (b_iota[:, None] * mb
           + torch.arange(mb, device=dev)[None, :]).to(torch.int32)
    return DecodeView(b_iota=b_iota,
                      row=pos.clamp(max=s_max - 1).to(torch.long),
                      in_range=(pos < s_max)[:, None, None], tab=tab,
                      lens=torch.clamp(pos + 1, max=s_max), block_size=bs)


def attn_decode_slots(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      pos: torch.Tensor, *, inv_freq,
                      view: Optional[DecodeView] = None):
    """Single-token decode with PER-SLOT positions (continuous batching).

    x: [B, 1, d]; cache_k/v: [B, rows, nkv, hd], UPDATED IN PLACE (the
    reference returns new arrays); pos: [B] integer, the row slot b's new
    token is written to. ``view``: the step's :func:`decode_view` (default:
    ``s_max = rows`` in one block). The slot capacity ``s_max`` may be less
    than ``rows`` (the cache rounded up to a multiple of the block size):
    the rows past it are never visible. Rows past ``pos[b]`` may hold stale
    KV from an evicted request: they are masked here and rewritten the step
    they become current.

    The attention runs through ``ops.paged_attention`` over the cache viewed
    as a pool of ``block_size``-row blocks (no copy) with the contiguous
    table ``tab[b, j] = b * rows / block_size + j`` and ``lens = min(pos + 1,
    s_max)``: the paged layout's own kernel on the card, so dense and paged
    decode are one computation over the same rows in the same order; on the
    CPU its plain version, the dense ``_sdpa`` arithmetic on the decode mask.

    A slot with ``pos[b] >= s_max`` is a frozen slot whose request filled its
    cache exactly (``prompt + max_new == s_max + 1``). The reference's
    scatter silently drops that out-of-range write; an out-of-range
    ``index_put_`` on CUDA is a device-side assert, so the write is masked
    here: the slot's row index is clamped and its old contents written back.
    All its ``s_max`` rows stay visible, as under the reference's mask
    ``arange(s_max) <= pos``. Returns (out [B,1,d], cache_k, cache_v)."""
    from repro_torch.kernels import ops
    B, rows = x.shape[0], cache_k.shape[1]
    if view is None:
        view = decode_view(pos, rows)
    q, k, v = _qkv(cfg, p, x)
    positions = pos[:, None]                               # [B, 1]
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    b_iota, row, in_range = view.b_iota, view.row, view.in_range
    cache_k[b_iota, row] = torch.where(in_range, k[:, 0].to(cache_k.dtype),
                                       cache_k[b_iota, row])
    cache_v[b_iota, row] = torch.where(in_range, v[:, 0].to(cache_v.dtype),
                                       cache_v[b_iota, row])
    pool = (B * rows // view.block_size, view.block_size) + tuple(
        cache_k.shape[2:])
    out = ops.paged_attention(q[:, 0], cache_k.view(pool), cache_v.view(pool),
                              view.tab, view.lens)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd)
    out = ein("bsh,hd->bsd", out, p.wo).to(x.dtype)
    return out, cache_k, cache_v


def _paged_write(pool: torch.Tensor, scales: Optional[torch.Tensor],
                 blk: torch.Tensor, r: torch.Tensor, val: torch.Tensor) -> None:
    """Write KV rows into the block pool, IN PLACE.

    pool: ``[n_blocks + 1, bs, nkv, hd]`` (model type, or int8 when
    ``scales`` ``[n_blocks + 1, bs, nkv]`` is given); blk / r: ``[...]``
    block ids and in-block rows; val: ``[..., nkv, hd]``. Sentinel ids
    (``== n_blocks``: frozen slots past their reservation, rows past
    ``s_max``, released slots) land in the pool's last block, a write-only
    sink that no table entry owns. The reference lets its scatter drop them;
    an out-of-range ``index_put_`` on CUDA is a device-side assert, and
    selecting the real rows on the host would cost a device read per layer
    and step, since which rows are real depends on ``pos`` on the device.
    Real writes never collide: a slot's writable blocks are its own."""
    blk = blk.to(torch.long)
    r = r.to(torch.long)
    if scales is None:
        pool[blk, r] = val.to(pool.dtype)
        return
    q, s = Q.quantize_kv(val)
    pool[blk, r] = q
    scales[blk, r] = s


def _paged_rows(tab: torch.Tensor, positions: torch.Tensor, n_blocks: int,
                bs: int):
    """(block id, in-block row) of absolute ``positions`` ``[B, ...]``
    through the slots' table rows ``[B, mb]``; positions at or past
    ``s_max = mb * bs`` map to the sentinel ``n_blocks``."""
    B, mb = tab.shape
    j = torch.clamp(positions // bs, max=mb - 1).to(torch.long)
    b_iota = torch.arange(B, device=tab.device).reshape(
        (B,) + (1,) * (positions.dim() - 1))
    blk = torch.where(positions < mb * bs, tab[b_iota, j].to(torch.long),
                      n_blocks)
    return blk, positions % bs


def attn_decode_paged(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                      kp: torch.Tensor, vp: torch.Tensor,
                      ks: Optional[torch.Tensor], vs: Optional[torch.Tensor],
                      tab: torch.Tensor, pos: torch.Tensor, *, inv_freq):
    """Single-token decode over the paged KV pool (pools updated IN PLACE).

    The paged sibling of :func:`attn_decode_slots`: the new row is written
    through the slot's block table, then the attention runs through
    ``ops.paged_attention`` / ``ops.paged_attention_q`` (the hand-written
    kernels on the card, the plain versions on the CPU). x: ``[B, 1, d]``;
    kp/vp: ``[n_blocks + 1, bs, nkv, hd]`` (int8 with ks/vs
    ``[n_blocks + 1, bs, nkv]`` fp32 scales, else ks = vs = None); tab:
    ``[B, mb]`` (sentinel ``n_blocks``); pos: ``[B]``. Returns out
    ``[B, 1, d]``."""
    from repro_torch.kernels import ops
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x)
    positions = pos[:, None]
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    nb, bs = kp.shape[0] - 1, kp.shape[1]
    blk, r = _paged_rows(tab, pos, nb, bs)
    _paged_write(kp, ks, blk, r, k[:, 0])
    _paged_write(vp, vs, blk, r, v[:, 0])
    lens = pos + 1
    q1 = q[:, 0].contiguous()
    if ks is None:
        out = ops.paged_attention(q1, kp, vp, tab, lens)
    else:
        out = ops.paged_attention_q(q1, kp, vp, ks, vs, tab, lens)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd)
    return ein("bsh,hd->bsd", out, p.wo).to(x.dtype)


def attn_verify_paged(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                      kp: torch.Tensor, vp: torch.Tensor,
                      ks: Optional[torch.Tensor], vs: Optional[torch.Tensor],
                      tab: torch.Tensor, pos: torch.Tensor, *, inv_freq):
    """T-token attention over the paged KV pool: the paged admission forward
    (pools updated IN PLACE).

    Slot b's T tokens sit at absolute positions ``pos[b] .. pos[b] + T - 1``
    (``pos`` = the shared-prefix rows it adopted); their K/V rows are written
    through the table, then the slot's whole ``s_max`` view is gathered
    (dequantized to the model type with ``dequantize_kv`` when the pool is
    int8) and attended through :func:`_attend` with ``qoff = pos``, query i
    seeing rows ``<= pos[b] + i`` (the flash kernel on the card, the dense
    path's ``_sdpa`` on the CPU). Sentinel entries clip into
    range and their rows are masked. x: ``[B, T, d]``; pools / tab as :func:`attn_decode_paged`.
    Returns out ``[B, T, d]``."""
    B, T, _ = x.shape
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qkv(cfg, p, x)
    positions = pos[:, None] + torch.arange(T, device=x.device)[None, :]
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    nb, bs = kp.shape[0] - 1, kp.shape[1]
    mb = tab.shape[1]
    s_max = mb * bs
    blk, r = _paged_rows(tab, positions, nb, bs)
    _paged_write(kp, ks, blk, r, k)
    _paged_write(vp, vs, blk, r, v)
    tabc = tab.to(torch.long).clamp(0, nb - 1)
    kc = kp[tabc].reshape(B, s_max, cfg.n_kv_heads, cfg.hd)
    vc = vp[tabc].reshape(B, s_max, cfg.n_kv_heads, cfg.hd)
    if ks is not None:
        kc = Q.dequantize_kv(kc, ks[tabc].reshape(B, s_max, cfg.n_kv_heads),
                             x.dtype)
        vc = Q.dequantize_kv(vc, vs[tabc].reshape(B, s_max, cfg.n_kv_heads),
                             x.dtype)
    out = _attend(q, kc, vc, n_rep, qoff=pos)
    out = out.reshape(B, T, cfg.n_heads * cfg.hd)
    return ein("bsh,hd->bsd", out, p.wo).to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, device,
                 generator: torch.Generator):
        super().__init__()
        self.wg = _param(dense_init((d_model, d_ff), dtype, device, generator))
        self.wu = _param(dense_init((d_model, d_ff), dtype, device, generator))
        self.wd = _param(dense_init((d_ff, d_model), dtype, device, generator))


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP of ``x [..., d]``: the reference's model arithmetic on
    both devices, which rounds g and u to the model type (``ein``) before
    ``silu(g) * u``, so the MLP stays logit equal to the reference's model at
    bf16 too. The choice of code is by device, never a fallback (as
    :func:`_attend`): on a CUDA tensor the hand-written ``swiglu_mlp`` kernel
    with its ``round_gu`` epilogue, on a CPU tensor the products below."""
    if x.is_cuda:
        from repro_torch.kernels import swiglu as SW
        return SW.mlp(x, p.wg, p.wu, p.wd, round_gu=True)
    g = ein("...d,df->...f", x, p.wg)
    u = ein("...d,df->...f", x, p.wu)
    h = (F.silu(g) * u).to(x.dtype)
    return ein("...f,fd->...d", h, p.wd).to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator):
        super().__init__()
        dt = cfg.param_dtype
        self.tok = _param(dense_init((cfg.vocab_size, cfg.d_model), dt, device,
                                     generator, scale=0.02))
        if not cfg.tie_embeddings:
            self.head = _param(dense_init((cfg.d_model, cfg.vocab_size), dt,
                                          device, generator))


def embed_apply(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.to(torch.long), p.tok)


def lm_head(cfg: ModelConfig, p: Embed, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits [..., vocab]."""
    if cfg.tie_embeddings:
        logits = mm32(x, p.tok.t())
    else:
        logits = mm32(x, p.head)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits

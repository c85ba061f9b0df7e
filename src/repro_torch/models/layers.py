"""Core layers of the serving path: RMSNorm, RoPE, GQA attention (prefill and
per-slot decode), SwiGLU MLP, embedding and LM head.

``nn.Module``s own the parameters (``requires_grad=False``); the arithmetic is
in plain functions on tensors that take the module as ``p``, mirroring the
reference's ``*_apply(p, x)`` functions one for one. Precision policy as in
:mod:`repro_torch.models.numerics`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

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
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                 device=x.device))[None, None, :, :]
    out = _sdpa(q, k, v, mask, n_rep)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd)
    out = ein("bsh,hd->bsd", out, p.wo).to(x.dtype)
    return out, k, v


def attn_decode_slots(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      pos: torch.Tensor, *, inv_freq):
    """Single-token decode with PER-SLOT positions (continuous batching).

    x: [B, 1, d]; cache_k/v: [B, S_max, nkv, hd], UPDATED IN PLACE (the
    reference returns new arrays); pos: [B] integer, the row slot b's new
    token is written to. Rows past ``pos[b]`` may hold stale KV from an
    evicted request: they are masked here and rewritten the step they become
    current.

    A slot with ``pos[b] >= S_max`` is a frozen slot whose request filled its
    cache exactly (``prompt + max_new == s_max + 1``). The reference's
    scatter silently drops that out-of-range write; an out-of-range
    ``index_put_`` on CUDA is a device-side assert, so the write is masked
    here: the slot's row index is clamped and its old contents written back.
    Returns (out [B,1,d], cache_k, cache_v)."""
    B = x.shape[0]
    S_max = cache_k.shape[1]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qkv(cfg, p, x)
    positions = pos[:, None]                               # [B, 1]
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    b_iota = torch.arange(B, device=x.device)
    in_range = (pos < S_max)[:, None, None]
    row = pos.clamp(max=S_max - 1).to(torch.long)
    cache_k[b_iota, row] = torch.where(in_range, k[:, 0].to(cache_k.dtype),
                                       cache_k[b_iota, row])
    cache_v[b_iota, row] = torch.where(in_range, v[:, 0].to(cache_v.dtype),
                                       cache_v[b_iota, row])
    valid = (torch.arange(S_max, device=x.device)[None, :]
             <= pos[:, None])[:, None, None, :]
    out = _sdpa(q, cache_k, cache_v, valid, n_rep)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd)
    out = ein("bsh,hd->bsd", out, p.wo).to(x.dtype)
    return out, cache_k, cache_v


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

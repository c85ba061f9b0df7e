"""Decoder-only layer stacks of the serving path (dense MLP or MoE blocks).

The reference scans stacked ``[L, ...]`` parameters; here a stack is a Python
sequence of :class:`Block` modules and the scan is a loop.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.config import ModelConfig


class Block(nn.Module):
    """ln1 -> attention -> residual -> ln2 -> MoE or MLP -> residual."""

    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator,
                 n_real: Optional[int] = None, live: Optional[int] = None):
        super().__init__()
        dt = cfg.param_dtype
        self.ln1 = L.RMSNorm(cfg.d_model, dt, device)
        self.attn = L.Attention(cfg, device, generator)
        self.ln2 = L.RMSNorm(cfg.d_model, dt, device)
        if cfg.moe is not None:
            self.moe = M.MoE(cfg, device, generator, n_real=n_real, live=live)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dt, device, generator)


def _ffn(cfg: ModelConfig, p: Block, hn: torch.Tensor) -> torch.Tensor:
    if cfg.moe is not None:
        return M.moe_apply(cfg, p.moe, hn, need_aux=False).y
    return L.mlp_apply(p.mlp, hn)


def stack_prefill(cfg: ModelConfig, blocks: Sequence[Block], x: torch.Tensor,
                  *, inv_freq):
    """Full-sequence forward that also emits per-layer (k, v) decode caches.
    Returns (y, cache_k [L,B,S,nkv,hd], cache_v)."""
    ks, vs = [], []
    h = x
    for p in blocks:
        hn = L.rmsnorm(p.ln1, h, cfg.norm_eps)
        a, k, v = L.attn_prefill(cfg, p.attn, hn, inv_freq=inv_freq)
        h = h + a
        h = h + _ffn(cfg, p, L.rmsnorm(p.ln2, h, cfg.norm_eps))
        ks.append(k)
        vs.append(v)
    return h, torch.stack(ks, dim=0), torch.stack(vs, dim=0)


def stack_decode_slots(cfg: ModelConfig, blocks: Sequence[Block],
                       x: torch.Tensor, cache_k: torch.Tensor,
                       cache_v: torch.Tensor, pos: torch.Tensor, *, inv_freq):
    """One-token decode with per-slot positions (continuous batching).

    cache_k/v: [L, B, S_max, nkv, hd] with L == len(blocks), updated IN
    PLACE layer by layer; pos: [B] per-slot lengths. Under
    ``dispatch='ragged'`` every decode step runs the grouped kernel over the
    B slot tokens. Returns (y, cache_k, cache_v)."""
    h = x
    for i, p in enumerate(blocks):
        hn = L.rmsnorm(p.ln1, h, cfg.norm_eps)
        a, _, _ = L.attn_decode_slots(cfg, p.attn, hn, cache_k[i], cache_v[i],
                                      pos, inv_freq=inv_freq)
        h = h + a
        h = h + _ffn(cfg, p, L.rmsnorm(p.ln2, h, cfg.norm_eps))
    return h, cache_k, cache_v

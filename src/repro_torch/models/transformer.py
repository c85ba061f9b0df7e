"""Decoder-only layer stacks (dense MLP or MoE blocks): the full-sequence
forward with calibration capture, and the serving path.

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


def block_apply(cfg: ModelConfig, p: Block, x: torch.Tensor, *, inv_freq,
                positions=None, causal: bool = True, capture: bool = False):
    """Full-sequence block. Returns (y, aux_loss, capture) with capture
    ``(expert_inputs [B, S, d], usage_counts [N])`` of the MoE layer when
    ``capture`` (None otherwise and for dense MLP blocks)."""
    a = L.attn_apply(cfg, p.attn, L.rmsnorm(p.ln1, x, cfg.norm_eps),
                     inv_freq=inv_freq, positions=positions, causal=causal)
    h = x + a
    hn = L.rmsnorm(p.ln2, h, cfg.norm_eps)
    if cfg.moe is not None:
        out = M.moe_apply(cfg, p.moe, hn, capture=capture)
        cap = (out.expert_inputs, out.usage_counts) if capture else None
        return h + out.y, out.aux_loss, cap
    return (h + L.mlp_apply(p.mlp, hn),
            torch.zeros((), dtype=torch.float32, device=x.device), None)


def stack_apply(cfg: ModelConfig, blocks: Sequence[Block], x: torch.Tensor, *,
                inv_freq, capture: bool = False):
    """The stack's full-sequence forward, a loop over its blocks. Returns
    (y, total aux loss, captures): captures ``(expert_inputs [L, B, S, d],
    usage_counts [L, N])`` when ``capture`` on an MoE stack, else None."""
    h = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caps = []
    for p in blocks:
        h, a, cap = block_apply(cfg, p, h, inv_freq=inv_freq, capture=capture)
        aux = aux + a
        caps.append(cap)
    if capture and cfg.moe is not None:
        return h, aux, tuple(torch.stack(c, dim=0) for c in zip(*caps))
    return h, aux, None


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
                       cache_v: torch.Tensor, pos: torch.Tensor, *, inv_freq,
                       view: Optional[L.DecodeView] = None):
    """One-token decode with per-slot positions (continuous batching).

    cache_k/v: [L, B, rows, nkv, hd] with L == len(blocks), updated IN
    PLACE layer by layer; pos: [B] per-slot lengths; ``view``: the step's
    ``layers.decode_view``, the same for every layer (default: ``s_max`` =
    ``rows`` in one block). Under ``dispatch='ragged'`` every decode step
    runs the grouped kernel over the B slot tokens. Returns (y, cache_k,
    cache_v)."""
    if view is None:
        view = L.decode_view(pos, cache_k.shape[2])
    h = x
    for i, p in enumerate(blocks):
        hn = L.rmsnorm(p.ln1, h, cfg.norm_eps)
        a, _, _ = L.attn_decode_slots(cfg, p.attn, hn, cache_k[i], cache_v[i],
                                      pos, inv_freq=inv_freq, view=view)
        h = h + a
        h = h + _ffn(cfg, p, L.rmsnorm(p.ln2, h, cfg.norm_eps))
    return h, cache_k, cache_v


def _sl(a: Optional[torch.Tensor], i: int) -> Optional[torch.Tensor]:
    return None if a is None else a[i]


def _stack_paged(attn_fn, cfg: ModelConfig, blocks: Sequence[Block],
                 x: torch.Tensor, kp, vp, ks, vs, tab, pos, *, inv_freq):
    h = x
    for i, p in enumerate(blocks):
        hn = L.rmsnorm(p.ln1, h, cfg.norm_eps)
        h = h + attn_fn(cfg, p.attn, hn, kp[i], vp[i], _sl(ks, i), _sl(vs, i),
                        tab, pos, inv_freq=inv_freq)
        h = h + _ffn(cfg, p, L.rmsnorm(p.ln2, h, cfg.norm_eps))
    return h


def stack_decode_paged(cfg: ModelConfig, blocks: Sequence[Block],
                       x: torch.Tensor, kp, vp, ks, vs, tab, pos, *, inv_freq):
    """One-token decode over paged KV pools. kp/vp: ``[L, n_blocks + 1, bs,
    nkv, hd]`` with L == len(blocks); ks/vs: ``[L, n_blocks + 1, bs, nkv]``
    fp32 or None (pools in the model type); tab: ``[B, mb]`` (one allocator
    owns the block ids of every layer); pos: ``[B]``. Pools updated IN PLACE
    layer by layer. Returns y."""
    return _stack_paged(L.attn_decode_paged, cfg, blocks, x, kp, vp, ks, vs,
                        tab, pos, inv_freq=inv_freq)


def stack_verify_paged(cfg: ModelConfig, blocks: Sequence[Block],
                       x: torch.Tensor, kp, vp, ks, vs, tab, pos, *, inv_freq):
    """T-token forward over paged KV pools (the paged admission forward, see
    ``layers.attn_verify_paged``). x: ``[B, T, d]``. Returns y."""
    return _stack_paged(L.attn_verify_paged, cfg, blocks, x, kp, vp, ks, vs,
                        tab, pos, inv_freq=inv_freq)

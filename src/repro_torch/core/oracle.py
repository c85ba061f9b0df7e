"""The "w/o merging errors" oracle (paper Table 5).

Keeps ALL original experts and merges their OUTPUTS exactly: per token the
routing weight of original expert j becomes
    u_j = B_{j, c(j)} * sum of top-k weights landing in cluster c(j),
so the layer output equals  Y · B · A · mask_top_K(softmax(W_r X))ᵀ  with zero
T1/T2/T3 approximation error. Memory is NOT reduced: this is the upper bound
that isolates clustering error from merging error.

Implemented with dense all-expert evaluation (the port of the reference's
``repro/core/oracle.py``); use on reduced / eval models only.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.models.model import Model
from repro_torch.models.config import ModelConfig
from repro_torch.models.numerics import ein

F32 = torch.float32


def oracle_moe_apply(cfg: ModelConfig, p: MoE.MoE, x: torch.Tensor, assign,
                     bweights) -> torch.Tensor:
    """assign: [N] int cluster ids; bweights: [N] fp32 B entries."""
    m = cfg.moe
    w, idx, _ = MoE.route(cfg, p, x)                      # [.., k]
    assign_t = torch.as_tensor(np.asarray(assign), device=x.device).to(
        torch.long)
    cl = assign_t[idx.to(torch.long)]                     # cluster of picks
    M = int(np.max(np.asarray(assign))) + 1
    onehot = F.one_hot(cl, M).to(F32)                     # [.., k, M]
    s_c = torch.einsum("...km,...k->...m", onehot, w)     # [.., M]
    # per-original-expert weight u_j = B_j * s_{c(j)}
    u = s_c[..., assign_t] * torch.as_tensor(
        np.asarray(bweights), dtype=F32, device=x.device)
    # dense all-expert evaluation
    g = ein("bsd,edf->bsef", x, p.wg)
    uu = ein("bsd,edf->bsef", x, p.wu)
    h = (F.silu(g) * uu).to(x.dtype)
    ye = ein("bsef,efd->bsed", h, p.wd)
    y = torch.einsum("bsed,bse->bsd", ye.to(F32), u.to(F32)).to(x.dtype)
    if m.n_shared_experts:
        y = y + L.mlp_apply(p.shared, x)
    return y


@torch.inference_mode()
def oracle_forward(cfg: ModelConfig, model: Model, batch: dict,
                   assigns: Dict[int, np.ndarray],
                   bweights: Dict[int, np.ndarray]) -> torch.Tensor:
    """Full-model forward (uncompressed ``model``) where the layers in
    ``assigns`` use exact output merging. Returns fp32 logits."""
    tokens = batch["tokens"]
    inv_freq = L.rope_freqs(cfg.hd, cfg.rope_theta, device=tokens.device)
    x = L.embed_apply(model.embed, tokens)
    for i, lp in enumerate(model.stack):
        h = x + L.attn_apply(cfg, lp.attn, L.rmsnorm(lp.ln1, x, cfg.norm_eps),
                             inv_freq=inv_freq)
        hn = L.rmsnorm(lp.ln2, h, cfg.norm_eps)
        if i in assigns:
            y = oracle_moe_apply(cfg, lp.moe, hn, assigns[i], bweights[i])
        else:
            y = MoE.moe_apply(cfg, lp.moe, hn).y
        x = h + y
    x = L.rmsnorm(model.final_ln, x, cfg.norm_eps)
    return L.lm_head(cfg, model.embed, x)

"""Mamba2 (state space duality) block: chunked prefill and an O(1)-state
decode, the counterpart of the reference's ``models/mamba.py``.

The SSD formulation (arXiv:2405.21060): a quadratic, attention-like term
inside each chunk and a linear recurrence across chunks (a loop over the
chunks where the reference scans). Every exponential and every state
product runs in fp32, the projections in the model type. Plain PyTorch on
both devices: the reference has no Pallas kernel here.

Two choices keep the card's memory and bits in line with the reference:

* the three-operand products contract ``n`` first: ``C·Bᵀ`` per group
  ``[b, c, g, l, m]``, broadcast to the group's heads and then scaled by
  the decay ``L`` (the reference's ``einsum`` would let the compiler pick;
  a ``[b, c, l, m, h, n]`` intermediate would be gigabytes at zamba2's 80
  heads and chunk 512);
* ``_segsum`` is the reference's difference of cumulative sums masked to
  ``-inf``, as written: a "more stable" form gives other bits.

One repair (ROADMAP C11): the conv state a prefill hands to decode is the
last ``conv_width - 1`` raw rows, left-padded with zeros when the prompt is
shorter, the rows the full-sequence conv pads with. The reference keeps a
short state there and its decode then fails; a prompt of ``conv_width - 1``
rows or more gives the reference's state bitwise.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _param, dense_init
from repro_torch.models.numerics import ein

F32 = torch.float32


class SSMState(NamedTuple):
    ssm: torch.Tensor    # [B, H, hd, d_state] fp32
    conv: torch.Tensor   # [B, conv_width - 1, conv_channels], model type


def _widths(cfg: ModelConfig):
    s, d = cfg.ssm, cfg.d_model
    return s.d_inner(d), s.n_heads(d), s.n_groups * s.d_state


class Mamba(nn.Module):
    """One Mamba2 block's parameters under the reference's leaf names. The
    projections, the conv and the norm scale are in the model type;
    ``dt_bias``, ``A_log`` and ``D`` stay fp32 in any model, as in the
    reference."""

    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator):
        super().__init__()
        s, d = cfg.ssm, cfg.d_model
        di, nh, gn = _widths(cfg)
        conv_ch = di + 2 * gn
        dt = cfg.param_dtype
        self.in_proj = _param(dense_init((d, 2 * di + 2 * gn + nh), dt, device,
                                         generator))
        w = torch.empty((s.conv_width, conv_ch), dtype=F32, device=device)
        self.conv_w = _param(w.normal_(0.0, 1.0, generator=generator)
                             .mul_(0.1).to(dt))
        self.conv_b = _param(torch.zeros((conv_ch,), dtype=dt, device=device))
        # dt bias such that softplus(dt_bias) spans [1e-3, 1e-1]
        u = torch.rand((nh,), dtype=F32, device=device, generator=generator)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt_init = torch.exp(u * (hi - lo) + lo)
        self.dt_bias = _param(dt_init + torch.log(-torch.expm1(-dt_init)))
        self.A_log = _param(torch.log(torch.arange(1, nh + 1, dtype=F32,
                                                   device=device)))
        self.D = _param(torch.ones((nh,), dtype=F32, device=device))
        self.norm_scale = _param(torch.ones((di,), dtype=dt, device=device))
        self.out_proj = _param(dense_init((di, d), dt, device, generator))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d with zero left padding, then SiLU. xBC:
    ``[B, S, C]``; w: ``[W, C]``."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros(xBC.shape, dtype=F32, device=xBC.device)
    for i in range(W):
        out = out + pad[:, i:i + S, :].to(F32) * w[i].to(F32)
    return F.silu(out + b.to(F32)).to(xBC.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = sum_{j < m <= i} x[..., m]`` as the difference of
    cumulative sums, ``-inf`` above the diagonal."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, torch.full((), -math.inf, dtype=out.dtype,
                                             device=x.device))


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                 init_state: Optional[torch.Tensor] = None):
    """The SSD scan. x ``[b, s, h, p]``; dt ``[b, s, h]`` (after the
    softplus); A ``[h]`` (negative); Bm, Cm ``[b, s, g, n]`` (head h reads
    group ``h // (h / g)``); s a multiple of ``chunk``. Returns (y ``[b, s,
    h, p]`` fp32, final state ``[b, h, p, n]`` fp32)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).to(F32)
    dtc = dt.reshape(b, nc, chunk, h).to(F32)
    Bc = Bm.reshape(b, nc, chunk, g, n).to(F32)
    Cc = Cm.reshape(b, nc, chunk, g, n).to(F32)
    Bh = Bc.repeat_interleave(rep, dim=3)                  # [b,nc,l,h,n]
    Ch = Cc.repeat_interleave(rep, dim=3)

    dA = dtc * A                                           # [b,nc,l,h]
    dA_cum = torch.cumsum(dA, dim=2)

    # intra-chunk (quadratic) term: C·Bᵀ per group first, then the decay
    L = torch.exp(_segsum(dA.movedim(2, -1)))              # [b,nc,h,l,m]
    cb = torch.einsum("bclgn,bcmgn->bcglm", Cc, Bc)
    att = cb.repeat_interleave(rep, dim=2) * L             # [b,nc,h,l,m]
    xdt = xc * dtc[..., None]
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", att, xdt)
    del L, cb, att

    # per-chunk final states
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)        # [b,nc,l,h]
    states = torch.einsum("bclhn,bclhp->bchpn", Bh,
                          xc * (decay_to_end * dtc)[..., None])    # [b,nc,h,p,n]

    # inter-chunk recurrence, the state before each chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])                   # [b,nc,h]
    carry = (torch.zeros((b, h, p, n), dtype=F32, device=x.device)
             if init_state is None else init_state.to(F32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                         # [b,nc,h,p,n]

    # inter-chunk contribution: n contracted first, then the decay
    in_decay = torch.exp(dA_cum)                                   # [b,nc,l,h]
    y_inter = (torch.einsum("bclhn,bchpn->bclhp", Ch, prev_states)
               * in_decay[..., None])
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, carry


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, nh, gn = _widths(cfg)
    return torch.split(zxbcdt, [di, di, 2 * gn, nh], dim=-1)


def _gated_out(cfg: ModelConfig, p: Mamba, y: torch.Tensor, z: torch.Tensor,
               dtype) -> torch.Tensor:
    """Gated RMSNorm of ``y`` (fp32) by ``silu(z)``, then the out
    projection, in ``dtype``."""
    gated = y * F.silu(z.to(F32))
    var = torch.mean(gated * gated, dim=-1, keepdim=True)
    gated = gated * torch.rsqrt(var + cfg.norm_eps) * p.norm_scale.to(F32)
    return ein("bsk,kd->bsd", gated.to(dtype), p.out_proj).to(dtype)


def mamba_apply(cfg: ModelConfig, p: Mamba, x: torch.Tensor,
                init_state: Optional[SSMState] = None,
                return_state: bool = False):
    """Full-sequence forward. x ``[B, S, d]`` -> ``[B, S, d]``, and with
    ``return_state`` the :class:`SSMState` a decode continues from (the
    conv state zero-padded on the left when ``S < conv_width - 1``, C11)."""
    s = cfg.ssm
    di, nh, gn = _widths(cfg)
    B_, S, _ = x.shape
    W = s.conv_width

    zxbcdt = ein("bsd,dk->bsk", x, p.in_proj).to(x.dtype)
    z, xin, BC, dt_raw = _split_proj(cfg, zxbcdt)
    raw = torch.cat([xin, BC], dim=-1)
    if init_state is not None:
        full = torch.cat([init_state.conv.to(raw.dtype), raw], dim=1)
        xBC = _causal_conv(full, p.conv_w, p.conv_b)[:, W - 1:]
    else:
        full = raw
        xBC = _causal_conv(raw, p.conv_w, p.conv_b)
    xin, Bm, Cm = torch.split(xBC, [di, gn, gn], dim=-1)

    dt = _softplus(dt_raw.to(F32) + p.dt_bias)                     # [B,S,nh]
    A = -torch.exp(p.A_log)
    xh = xin.reshape(B_, S, nh, s.head_dim)
    Bm = Bm.reshape(B_, S, s.n_groups, s.d_state)
    Cm = Cm.reshape(B_, S, s.n_groups, s.d_state)

    # pad to a chunk multiple AFTER the softplus: dt = 0 on the pad rows, so
    # they carry no state
    pad = (-S) % s.chunk_size
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))

    y, fin = _ssd_chunked(xh, dt, A, Bm, Cm, s.chunk_size,
                          None if init_state is None else init_state.ssm)
    y = y[:, :S]
    y = y + xin.reshape(B_, S, nh, s.head_dim).to(F32) * p.D[:, None]
    y = y.reshape(B_, S, di).to(x.dtype)
    out = _gated_out(cfg, p, y.to(F32), z, x.dtype)
    if not return_state:
        return out
    tail = full[:, -(W - 1):]
    if tail.shape[1] < W - 1:                                      # C11
        tail = F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))
    return out, SSMState(ssm=fin, conv=tail)


def mamba_decode(cfg: ModelConfig, p: Mamba, x: torch.Tensor,
                 state: SSMState):
    """One token. x ``[B, 1, d]``; ``state`` the conv tail and the SSM state.
    Returns (out ``[B, 1, d]``, the new :class:`SSMState`, new tensors)."""
    s = cfg.ssm
    di, nh, gn = _widths(cfg)

    zxbcdt = ein("bsd,dk->bsk", x, p.in_proj).to(x.dtype)
    z, xin_raw, BC_raw, dt_raw = _split_proj(cfg, zxbcdt)
    raw = torch.cat([xin_raw, BC_raw], dim=-1)                     # [B,1,C]

    window = torch.cat([state.conv.to(raw.dtype), raw], dim=1)     # [B,W,C]
    conv = torch.einsum("bwc,wc->bc", window.to(F32), p.conv_w.to(F32))
    xBC = F.silu(conv + p.conv_b.to(F32)).to(x.dtype)[:, None, :]
    new_conv = window[:, 1:]

    xin, Bm, Cm = torch.split(xBC, [di, gn, gn], dim=-1)
    dt = _softplus(dt_raw[:, 0].to(F32) + p.dt_bias)               # [B,nh]
    A = -torch.exp(p.A_log)
    a = torch.exp(dt * A)

    rep = nh // s.n_groups
    xh = xin.reshape(-1, nh, s.head_dim).to(F32)                   # [B,nh,hd]
    Bh = Bm.reshape(-1, s.n_groups, s.d_state).repeat_interleave(
        rep, dim=1).to(F32)                                        # [B,nh,n]
    Ch = Cm.reshape(-1, s.n_groups, s.d_state).repeat_interleave(
        rep, dim=1).to(F32)

    new_ssm = (state.ssm * a[..., None, None]
               + (dt[..., None] * xh)[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, Ch) + xh * p.D[:, None]
    y = y.reshape(-1, 1, di)
    out = _gated_out(cfg, p, y, z, x.dtype)
    return out, SSMState(ssm=new_ssm, conv=new_conv)


def init_ssm_state(cfg: ModelConfig, batch: int, device) -> SSMState:
    """Zero states for ``batch`` rows: ssm fp32, conv in the model type."""
    s = cfg.ssm
    di, nh, gn = _widths(cfg)
    return SSMState(
        ssm=torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=F32,
                        device=device),
        conv=torch.zeros((batch, s.conv_width - 1, di + 2 * gn),
                         dtype=cfg.param_dtype, device=device))

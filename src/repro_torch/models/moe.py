"""Mixture-of-Experts layer.

Three dispatch paths:

* ``ragged`` : dropless; sort the (token, slot) pairs by expert, run the
  grouped kernel over the sorted rows, bring the rows back to token order and
  add each token's k rows in slot order.
* ``gather`` : ragged that sends decode-SHAPED calls (one token per sequence
  and at most ``gather_max_tokens`` of them) to the per-token gather kernel;
  prefill buckets keep the grouped kernel.
* ``dense``  : the reference's default, GShard-style capacity dispatch in
  groups of ``group_size`` tokens (tokens past an expert's capacity are
  dropped), plain PyTorch on both devices as the reference leaves it to its
  compiler. The compression pipeline calibrates through it: capacity drops
  change the next layers' inputs.

Compressed (merged) models keep the ORIGINAL router ``[d, N]`` and add an
integer ``remap`` table ``[N] -> [M]``; the expert tables then hold M merged
experts. ``live`` counts the routable rows of the tables: heterogeneous plans
pad every suffix layer's tables to the plan's largest M, and the router
logits of any original expert whose remap lands on a pad row are masked, so
the padding is unreachable even under a corrupted remap.

Int8 tables (:mod:`repro_torch.core.quant`): a quantized layer holds a
``qexp`` set of six tensors instead of ``wg``/``wu``/``wd``; ragged and
gather dispatch to the ``_q`` kernels, dense dequantizes up front. The int8
gather kernel emits the per-pair rows and the combine runs outside it, in the
same slot order as the ragged path's, so int8 gather == int8 ragged bitwise
at any k too.

Training / capture routing (``route``: full softmax, top-k, renormalised) and
the load-balance loss run when ``need_aux`` or ``capture`` is set;
``capture=True`` also returns the expert inputs, the usage counts over the
ORIGINAL experts and the top-k ids. Expert parallelism belongs to a later
slice and raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.core import quant as Q
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import combine_in_order
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, _param, dense_init, mlp_apply
from repro_torch.models.numerics import ein, ein32

F32 = torch.float32


class MoEOutput(NamedTuple):
    y: torch.Tensor                    # [B, S, d]
    aux_loss: torch.Tensor             # scalar (zero on the inference path)
    # capture (None when capture=False)
    expert_inputs: Optional[torch.Tensor] = None   # [B, S, d]
    usage_counts: Optional[torch.Tensor] = None    # [N] fp32, ORIGINAL experts
    topk_idx: Optional[torch.Tensor] = None        # [B, S, k] original ids


class MoE(nn.Module):
    """Router, expert tables, ``remap`` and ``live`` of one layer.

    ``n_real``: number of physically stored experts (M after compression);
    the router and ``remap`` always span the ORIGINAL ``n_experts``."""

    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator,
                 n_real: Optional[int] = None, live: Optional[int] = None):
        super().__init__()
        m = cfg.moe
        d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
        R = n_real or E
        live = R if live is None else live
        dt = cfg.param_dtype
        self.router = _param(dense_init((d, E), F32, device, generator))
        self.wg = _param(dense_init((R, d, f), dt, device, generator))
        self.wu = _param(dense_init((R, d, f), dt, device, generator))
        self.wd = _param(dense_init((R, f, d), dt, device, generator))
        self.register_buffer(
            "remap", (torch.arange(E, device=device) % live).to(torch.int32))
        self.register_buffer(
            "live", torch.tensor(live, dtype=torch.int32, device=device))
        if m.n_shared_experts:
            self.shared = MLP(d, m.n_shared_experts * f, dt, device, generator)


def n_real_experts(p: MoE) -> int:
    """Number of physically stored experts (M after compression, else N)."""
    if Q.is_quantized(p):
        return p.qexp.wg.shape[0]
    return p.wg.shape[0]


def _quant_tables(p: MoE):
    """The layer's ``QuantizedExpertTables``, or None for plain tables."""
    return p.qexp.tables() if Q.is_quantized(p) else None


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _topk_iterative(scores: torch.Tensor, k: int):
    """k passes of max / argmax / mask with ``-inf``. Ties go to the lowest
    index in every pass (``torch.topk`` promises no such order), which is
    what makes routing reproducible against the reference."""
    ws, ids = [], []
    cur = scores
    iota = torch.arange(scores.shape[-1], device=scores.device)
    for _ in range(k):
        w, i = torch.max(cur, dim=-1)
        # torch.max returns SOME maximal index on ties; take the first
        # (clamped: a NaN row matches nowhere and must still index in range)
        i = torch.where(cur == w[..., None], iota, scores.shape[-1]).min(
            dim=-1).values.clamp(max=scores.shape[-1] - 1)
        ws.append(w)
        ids.append(i.to(torch.int32))
        cur = torch.where(iota == i[..., None], float("-inf"), cur)
    return torch.stack(ws, dim=-1), torch.stack(ids, dim=-1)


def route_infer(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """Inference routing: (topk_weights [.., k] fp32, topk_idx [.., k] int32
    in ORIGINAL expert space). Top-k on the live-masked router LOGITS, combine
    weights as a softmax over just the k kept logits."""
    m = cfg.moe
    logits = ein32("...d,de->...e", x, p.router)
    # fail-closed pad-row mask: an original expert whose remap target is a
    # pad row (>= live) can never win top-k, whatever the remap holds
    logits = torch.where(p.remap >= p.live, float("-inf"), logits)
    lw, idx = _topk_iterative(logits, m.top_k)
    return torch.softmax(lw, dim=-1), idx


def route(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """Training / capture routing: (topk_weights [.., k] fp32 renormalised
    among the k, topk_idx [.., k] int32 in ORIGINAL expert space, probs
    [.., N] fp32). Top-k on the full softmax of the live-masked router
    logits."""
    m = cfg.moe
    logits = ein32("...d,de->...e", x.to(F32), p.router)
    logits = torch.where(p.remap >= p.live, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    w, idx = _topk_iterative(probs, m.top_k)
    w = w / torch.sum(w, dim=-1, keepdim=True)       # renormalise among top-k
    return w, idx, probs


def balance_loss(cfg: ModelConfig, probs: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss over ORIGINAL experts."""
    E = cfg.moe.n_experts
    me = torch.mean(probs.reshape(-1, E), dim=0)                 # mean prob
    sel = F.one_hot(idx.reshape(-1, cfg.moe.top_k).to(torch.long),
                    E).to(F32)
    ce = torch.mean(torch.sum(sel, dim=1), dim=0)                # tokens/expert
    return E * torch.sum(me * ce) / cfg.moe.top_k


# ---------------------------------------------------------------------------
# dense (capacity) dispatch: GShard style, group-local
# ---------------------------------------------------------------------------

def _capacity(m, G: int, E: int) -> int:
    c = int(m.top_k * G * m.capacity_factor / E)
    return max(4, -(-c // 4) * 4)                    # up to a multiple of 4


def capacity_experts(cfg: ModelConfig, p: MoE) -> int:
    """Expert count that SIZES the dense dispatch's capacity: the smallest
    live count for a heterogeneous compressed suffix (identified by its
    table width ``moe_merged``), else the stored experts. Sizing by the
    padded width would drop tokens the unpadded layer keeps."""
    E = n_real_experts(p)
    if cfg.moe_merged_layers is not None and E == cfg.moe_merged:
        return min(cfg.moe_merged_layers)
    return E


def _dispatch_tensors(cfg: ModelConfig, w: torch.Tensor, idx: torch.Tensor,
                      E: int, C: int):
    """combine ``[n, G, E, C]`` fp32 and dispatch ``[n, G, E, C]`` bool per
    group. w, idx: ``[n, G, k]``. A token's j-th pick takes the next free
    position of its expert (earlier picks of all tokens first, then tokens
    in order); positions at or past C are dropped."""
    m = cfg.moe
    n, G = w.shape[:2]
    counts = torch.zeros((n, E), dtype=torch.int64, device=w.device)
    combine = torch.zeros((n, G, E, C), dtype=F32, device=w.device)
    for j in range(m.top_k):
        mj = F.one_hot(idx[..., j].to(torch.long), E)            # [n, G, E]
        loc = torch.cumsum(mj, dim=1) - mj + counts[:, None, :]   # position
        counts = counts + mj.sum(dim=1)
        keep = (loc < C) & (mj > 0)
        slot = F.one_hot(torch.where(keep, loc, C), C + 1)[..., :C].to(F32)
        combine = combine + (w[..., j, None, None] * mj[..., None].to(F32)
                             * slot)
    return combine, combine > 0.0


def _moe_dense_groups(cfg: ModelConfig, p: MoE, x2: torch.Tensor,
                      w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x2: ``[n, G, d]``; w / idx: ``[n, G, k]`` (idx in REAL expert space).
    Returns ``[n, G, d]``. The reference's einsums and rounding points:
    dispatch, expert products and combine in the model type with fp32
    accumulation (the combine weights rounded to it too)."""
    E = n_real_experts(p)
    G = x2.shape[1]
    C = _capacity(cfg.moe, G, capacity_experts(cfg, p))
    combine, dispatch = _dispatch_tensors(cfg, w, idx, E, C)
    dt = x2.dtype
    qt = _quant_tables(p)
    if qt is not None:
        wg, wu, wd = qt.dequant(dt)
    else:
        wg, wu, wd = p.wg, p.wu, p.wd
    xe = ein("gtec,gtd->gecd", dispatch.to(dt), x2).to(dt)       # [n, E, C, d]
    h_g = ein("gecd,edf->gecf", xe, wg)
    h_u = ein("gecd,edf->gecf", xe, wu)
    h = (F.silu(h_g) * h_u).to(dt)
    ye = ein("gecf,efd->gecd", h, wd).to(dt)
    return ein("gtec,gecd->gtd", combine.to(dt), ye).to(dt)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _moe_ragged(cfg: ModelConfig, p: MoE, xf: torch.Tensor, w: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """xf: [T, d]; w/idx: [T, k] (idx in REAL expert space). Dropless.

    The sort is STABLE (``torch.argsort`` is not unless asked). The combine
    does not scatter-add: ``index_add_`` on CUDA is atomics, whose order
    changes from run to run. Instead the sorted rows are brought back to
    (token, slot) order and each token's k rows are added in fp32 in slot
    order, which is the gather kernel's order, so gather == ragged holds
    bitwise at any k. (The reference adds in expert-sorted order; that equals
    slot order only up to fp32 commutativity at k = 2, and differs before the
    final rounding at k = 8.)"""
    E = n_real_experts(p)
    T, d = xf.shape
    k = idx.shape[-1]
    flat_idx = idx.reshape(-1).to(torch.long).clamp(0, E - 1)     # [T*k]
    order = torch.argsort(flat_idx, stable=True)
    tok_of = order // k                               # source token per row
    xs = xf.index_select(0, tok_of)                   # [T*k, d] sorted
    # counts by comparison, not bincount (which reads its size back to the
    # host) and not scatter_add (atomics)
    group_sizes = (flat_idx[:, None] == torch.arange(
        E, device=xf.device)[None, :]).sum(dim=0).to(torch.int32)
    qt = _quant_tables(p)
    if qt is not None:
        ys = kops.grouped_swiglu_q(xs, qt, group_sizes)
    else:
        ys = kops.grouped_swiglu(xs, p.wg, p.wu, p.wd, group_sizes)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=xf.device)
    y = ys.index_select(0, inv).reshape(T, k, d)
    return combine_in_order(y, w).to(xf.dtype)


def _moe_gather(cfg: ModelConfig, p: MoE, xf: torch.Tensor, w: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """xf: [T, d]; w/idx: [T, k] (idx in REAL expert space). Dropless:
    the decode-mode kernel, no sort and no scatter."""
    qt = _quant_tables(p)
    if qt is not None:
        y = kops.gather_swiglu_q(xf, qt, idx, w.to(F32))
    else:
        y = kops.gather_swiglu(xf, p.wg, p.wu, p.wd, idx, w.to(F32))
    return y.to(xf.dtype)


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor,
              capture: bool = False, need_aux: bool = True) -> MoEOutput:
    """x: [B, S, d] (or [B, 1, d] for decode).

    ``need_aux=False`` and ``capture=False`` (serving): :func:`route_infer`,
    ``aux_loss`` a constant zero. Otherwise :func:`route` and
    :func:`balance_loss`; ``capture=True`` adds the expert inputs ``x``, the
    usage counts over the ORIGINAL experts and the top-k ids."""
    m = cfg.moe
    if m.ep_axis is not None or m.ep_degree > 1:
        raise NotImplementedError(
            "expert-parallel dispatch (ep_axis / ep_degree) is not ported yet: "
            "it comes with the mesh slice")
    if m.dispatch not in ("gather", "ragged", "dense"):
        raise ValueError(f"unknown MoE dispatch {m.dispatch!r}")
    B, S, d = x.shape
    if capture or need_aux:
        w, idx, probs = route(cfg, p, x)
        aux = balance_loss(cfg, probs, idx)
    else:
        w, idx = route_infer(cfg, p, x)
        aux = torch.zeros((), dtype=F32, device=x.device)
    ridx = p.remap[idx.to(torch.long)]               # original -> real experts

    T = B * S
    xf = x.reshape(T, d)
    wf = w.reshape(T, m.top_k)
    rf = ridx.reshape(T, m.top_k)
    # gather only for decode-SHAPED calls: one token per sequence and at most
    # gather_max_tokens of them; prefill buckets keep the grouped kernel
    if m.dispatch == "gather" and S == 1 and T <= m.gather_max_tokens:
        y = _moe_gather(cfg, p, xf, wf, rf)
    elif m.dispatch in ("gather", "ragged"):
        y = _moe_ragged(cfg, p, xf, wf, rf)
    else:
        G = min(m.group_size, T)
        n_groups = -(-T // G)
        pad = n_groups * G - T
        if pad:
            xf = F.pad(xf, (0, 0, 0, pad))
            wf = F.pad(wf, (0, 0, 0, pad))
            rf = F.pad(rf, (0, 0, 0, pad))
        y = _moe_dense_groups(cfg, p, xf.reshape(n_groups, G, d),
                              wf.reshape(n_groups, G, m.top_k),
                              rf.reshape(n_groups, G, m.top_k))
        y = y.reshape(n_groups * G, d)[:T]
    y = y.reshape(B, S, d)
    if m.n_shared_experts:
        y = y + mlp_apply(p.shared, x)
    if capture:
        counts = F.one_hot(idx.reshape(-1, m.top_k).to(torch.long),
                           m.n_experts).to(F32).sum(dim=(0, 1))
        return MoEOutput(y, aux, x, counts, idx)
    return MoEOutput(y, aux)

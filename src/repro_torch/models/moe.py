"""Mixture-of-Experts layer, inference side.

Two dispatch paths, both dropless:

* ``ragged`` : sort the (token, slot) pairs by expert, run the grouped
  kernel over the sorted rows, bring the rows back to token order and add each
  token's k rows in slot order.
* ``gather`` : ragged that sends decode-SHAPED calls (one token per sequence
  and at most ``gather_max_tokens`` of them) to the per-token gather kernel;
  prefill buckets keep the grouped kernel.

Compressed (merged) models keep the ORIGINAL router ``[d, N]`` and add an
integer ``remap`` table ``[N] -> [M]``; the expert tables then hold M merged
experts. ``live`` counts the routable rows of the tables: heterogeneous plans
pad every suffix layer's tables to the plan's largest M, and the router
logits of any original expert whose remap lands on a pad row are masked, so
the padding is unreachable even under a corrupted remap.

``dispatch="dense"`` (capacity dispatch), ``route`` / ``balance_loss``
(training), ``capture=True`` (calibration), int8 ``qexp`` tables and expert
parallelism belong to later slices of the port and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import combine_in_order
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, _param, dense_init, mlp_apply
from repro_torch.models.numerics import ein32

F32 = torch.float32


class MoEOutput(NamedTuple):
    y: torch.Tensor                    # [B, S, d]
    aux_loss: torch.Tensor             # scalar zero on the inference path


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
    if hasattr(p, "qexp"):
        raise NotImplementedError(
            "int8 expert tables (qexp) are not ported yet: they come with the "
            "gather_swiglu_q / grouped_swiglu_q kernels")
    return p.wg.shape[0]


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
    raise NotImplementedError(
        "route (full softmax for training / capture) is not ported yet: it "
        "comes with the training and compression slices")


def balance_loss(cfg: ModelConfig, probs, idx):
    raise NotImplementedError(
        "balance_loss is not ported yet: it comes with the training slice")


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
    ys = kops.grouped_swiglu(xs, p.wg, p.wu, p.wd, group_sizes)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=xf.device)
    y = ys.index_select(0, inv).reshape(T, k, d)
    return combine_in_order(y, w).to(xf.dtype)


def _moe_gather(cfg: ModelConfig, p: MoE, xf: torch.Tensor, w: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """xf: [T, d]; w/idx: [T, k] (idx in REAL expert space). Dropless:
    the decode-mode kernel, no sort and no scatter."""
    n_real_experts(p)
    y = kops.gather_swiglu(xf, p.wg, p.wu, p.wd, idx, w.to(F32))
    return y.to(xf.dtype)


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor,
              capture: bool = False, need_aux: bool = True) -> MoEOutput:
    """x: [B, S, d] (or [B, 1, d] for decode). Only the inference form
    (``need_aux=False``, ``capture=False``) is ported."""
    m = cfg.moe
    if capture or need_aux:
        raise NotImplementedError(
            "moe_apply(capture=True / need_aux=True) needs route() and "
            "balance_loss(): not ported yet (training and compression slices)")
    if m.ep_axis is not None or m.ep_degree > 1:
        raise NotImplementedError(
            "expert-parallel dispatch (ep_axis / ep_degree) is not ported yet: "
            "it comes with the mesh slice")
    if m.dispatch not in ("gather", "ragged"):
        raise NotImplementedError(
            f"dispatch={m.dispatch!r} is not ported yet (capacity dispatch "
            f"comes with the training slice); use 'gather' or 'ragged'")
    B, S, d = x.shape
    w, idx = route_infer(cfg, p, x)
    ridx = p.remap[idx.to(torch.long)]               # original -> real experts

    T = B * S
    xf = x.reshape(T, d)
    wf = w.reshape(T, m.top_k)
    rf = ridx.reshape(T, m.top_k)
    # gather only for decode-SHAPED calls: one token per sequence and at most
    # gather_max_tokens of them; prefill buckets keep the grouped kernel
    if m.dispatch == "gather" and S == 1 and T <= m.gather_max_tokens:
        y = _moe_gather(cfg, p, xf, wf, rf)
    else:
        y = _moe_ragged(cfg, p, xf, wf, rf)
    y = y.reshape(B, S, d)
    if m.n_shared_experts:
        y = y + mlp_apply(p.shared, x)
    return MoEOutput(y, torch.zeros((), dtype=F32, device=x.device))

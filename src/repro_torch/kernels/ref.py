"""Plain PyTorch versions of the kernels of the serving path.

Device-agnostic, the same arithmetic and rounding points as the reference's
jnp oracles (``repro/kernels/ref.py``). MoE, plain tables: gate and up
products in fp32, ``silu(g) * u`` rounded to the model type, the down product
in fp32 rounded to the model type, and (for the gather form) an fp32 weighted
sum over the k slots rounded once. MoE, int8 tables: the same with the tables
dequantized to fp32 (``q * scale``) and ``h`` kept fp32: one rounding, at the
output. Paged attention: the pool gathered through the block table into a
contiguous view (sentinel entries clipped into range), then the dense path's
``_sdpa`` arithmetic with rows past ``lens`` masked; int8 pools dequantized to
the query's type first. Flash attention: logits through ``ein`` (rounded to
the inputs' type) times ``1/sqrt(hd)``, the bottom-right causal mask filled
with the most negative fp32, softmax cast to v's type, the value product. The
dense MLP: g and u in fp32 (or, with ``round_gu``, rounded to the model type
as the model's arithmetic does), ``h`` rounded to the model type, the down
product in fp32 rounded once. The CPU path of :mod:`repro_torch.kernels.ops` runs
these; on the card they are only what the hand-written kernels are held
against.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant as Q
from repro_torch.models.layers import _sdpa
from repro_torch.models.numerics import ein

F32 = torch.float32

#: rows whose gathered fp32 tables are held at once (bounds the plain
#: version's memory: chunk * 3 * d * f * 4 bytes)
_CHUNK_BYTES = 1 << 30


def swiglu_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, round_gu: bool = False) -> torch.Tensor:
    """The dense MLP's kernel contract. x: [T, d]; wg/wu: [d, f]; wd:
    [f, d]. g and u in fp32, ``silu(g) * u`` rounded to x's type, the down
    product in fp32 rounded once. ``round_gu``: the model's arithmetic
    (``layers.mlp_apply``, as the reference's model computes it) instead, g
    and u rounded to x's type before the activation, which rounds too; the
    same at fp32."""
    xf = x.to(F32)
    g = xf @ wg.to(F32)
    u = xf @ wu.to(F32)
    if round_gu:
        g, u = g.to(x.dtype), u.to(x.dtype)
    h = (F.silu(g) * u).to(x.dtype)
    return (h.to(F32) @ wd.to(F32)).to(x.dtype)


def _w32(w: torch.Tensor, e: torch.Tensor, scale) -> torch.Tensor:
    """The fp32 tables of experts ``e``: widened, or ``q * scale``."""
    if scale is None:
        return w[e].to(F32)
    return w[e].to(F32) * scale[e]


def _rows_swiglu(x: torch.Tensor, eid: torch.Tensor, wg: torch.Tensor,
                 wu: torch.Tensor, wd: torch.Tensor,
                 scales=None) -> torch.Tensor:
    """Row r of ``x`` through expert ``eid[r]``; result in ``x.dtype``.
    One batched product per row, so a row's arithmetic does not depend on
    which other rows share the call. ``scales``: the int8 tables' (sg, su,
    sd); then ``h`` stays fp32."""
    n, d = x.shape
    f = wg.shape[-1]
    sg, su, sd = scales if scales is not None else (None, None, None)
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    chunk = max(1, _CHUNK_BYTES // (3 * d * f * 4))
    for lo in range(0, n, chunk):
        e = eid[lo:lo + chunk]
        xr = x[lo:lo + chunk].to(F32).unsqueeze(1)               # [c, 1, d]
        g = torch.bmm(xr, _w32(wg, e, sg))                       # [c, 1, f]
        u = torch.bmm(xr, _w32(wu, e, su))
        h = F.silu(g) * u
        if scales is None:
            h = h.to(x.dtype).to(F32)
        y = torch.bmm(h, _w32(wd, e, sd))                        # [c, 1, d]
        out[lo:lo + chunk] = y.squeeze(1).to(x.dtype)
    return out


def combine_in_order(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_j w[t, j] * y[t, j]`` in fp32, j ascending, the product and the
    sum rounded separately, starting from zero. y: [T, k, d]; w: [T, k].
    Returns fp32 [T, d]. Written as a loop so that the order is the same on
    every device and equals the gather kernel's."""
    T, k, d = y.shape
    acc = torch.zeros((T, d), dtype=F32, device=y.device)
    wf = w.to(F32)
    for j in range(k):
        acc = acc + y[:, j].to(F32) * wf[:, j, None]
    return acc


def rows_to_experts(group_sizes: torch.Tensor, T: int) -> torch.Tensor:
    """Expert id of each of the T expert-sorted rows. ``repeat_interleave``
    emits each id exactly ``size`` times, so zero-sized groups cannot be
    mistaken for a neighbour (a ``searchsorted`` over the segment starts
    would have to special-case their duplicate entries)."""
    E = group_sizes.shape[0]
    return torch.repeat_interleave(
        torch.arange(E, device=group_sizes.device),
        group_sizes.to(torch.long), output_size=T)


def grouped_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x: [T, d] rows sorted by expert; wg/wu: [E, d, f]; wd: [E, f, d];
    group_sizes: [E] integers summing to T. Returns [T, d]."""
    T = x.shape[0]
    if T == 0:
        return torch.zeros_like(x)
    return _rows_swiglu(x, rows_to_experts(group_sizes, T), wg, wu, wd)


def gather_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                  wd: torch.Tensor, idx: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """x: [T, d]; idx: [T, k] expert ids (clipped to [0, E)); w: [T, k]
    combine weights. Row t = ``sum_j w[t, j] * SwiGLU_{idx[t, j]}(x[t])``."""
    T, d = x.shape
    k = idx.shape[-1]
    E = wg.shape[0]
    if T == 0:
        return torch.zeros((0, d), dtype=x.dtype, device=x.device)
    eid = idx.reshape(-1).to(torch.long).clamp(0, E - 1)
    y = _rows_swiglu(x.repeat_interleave(k, dim=0), eid, wg, wu, wd)
    return combine_in_order(y.reshape(T, k, d), w).to(x.dtype)


# ---------------------------------------------------------------------------
# int8 expert tables
# ---------------------------------------------------------------------------

def _q_args(qt):
    return (qt.wg, qt.wu, qt.wd), (qt.wg_scale, qt.wu_scale, qt.wd_scale)


def grouped_swiglu_q(x: torch.Tensor, qt, group_sizes: torch.Tensor
                     ) -> torch.Tensor:
    """:func:`grouped_swiglu` over :class:`repro_torch.core.quant.
    QuantizedExpertTables`: fp32 end to end, one downcast at the output."""
    T = x.shape[0]
    if T == 0:
        return torch.zeros_like(x)
    tabs, scales = _q_args(qt)
    return _rows_swiglu(x, rows_to_experts(group_sizes, T), *tabs,
                        scales=scales)


def gather_swiglu_q_rows(x: torch.Tensor, qt, idx: torch.Tensor
                         ) -> torch.Tensor:
    """Per-pair rows of the int8 gather kernel: ``[T, k, d]`` at
    ``x.dtype``, row (t, j) = ``SwiGLU_{idx[t, j]}(x[t])`` (ids clipped to
    ``[0, E)``), before any combine."""
    T, d = x.shape
    k = idx.shape[-1]
    if T == 0:
        return torch.zeros((0, k, d), dtype=x.dtype, device=x.device)
    E = qt.wg.shape[0]
    eid = idx.reshape(-1).to(torch.long).clamp(0, E - 1)
    tabs, scales = _q_args(qt)
    y = _rows_swiglu(x.repeat_interleave(k, dim=0), eid, *tabs, scales=scales)
    return y.reshape(T, k, d)


def gather_swiglu_q(x: torch.Tensor, qt, idx: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Int8 decode-mode MoE: the per-pair rows, then the fp32 combine in slot
    order, rounded once."""
    return combine_in_order(gather_swiglu_q_rows(x, qt, idx), w).to(x.dtype)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _gather_pool(pool: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """``[n_blocks, bs, ...]`` pool + ``[B, mb]`` table -> ``[B, mb*bs, ...]``.
    Entries ``>= n_blocks`` (sentinels) clip to the last block; their rows
    are masked downstream."""
    nb, bs = pool.shape[0], pool.shape[1]
    g = pool[tab.to(torch.long).clamp(0, nb - 1)]               # [B, mb, bs, ..]
    return g.reshape((g.shape[0], g.shape[1] * bs) + tuple(g.shape[3:]))


def _paged_sdpa(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                lens: torch.Tensor) -> torch.Tensor:
    """Decode attention over a gathered view: the dense path's ``_sdpa``
    (``models/layers.py``) with rows ``>= lens`` masked. q: ``[B, nq, hd]``;
    kc/vc: ``[B, S, nkv, hd]``. Returns ``[B, nq, hd]``."""
    S = kc.shape[1]
    n_rep = q.shape[1] // kc.shape[2]
    mask = (torch.arange(S, device=q.device)[None, :]
            < lens.to(q.device)[:, None])[:, None, None, :]
    return _sdpa(q[:, None], kc, vc, mask, n_rep)[:, 0]


def paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    tab: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """q: ``[B, nq, hd]``; kp/vp: ``[n_blocks, bs, nkv, hd]``; tab:
    ``[B, mb]`` block ids (sentinel = n_blocks); lens: ``[B]`` valid rows.
    Returns ``[B, nq, hd]``."""
    return _paged_sdpa(q, _gather_pool(kp, tab), _gather_pool(vp, tab), lens)


def paged_attention_q(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                      ks: torch.Tensor, vs: torch.Tensor, tab: torch.Tensor,
                      lens: torch.Tensor) -> torch.Tensor:
    """Int8 pools (kp/vp int8, ks/vs fp32 ``[n_blocks, bs, nkv]``): the
    gathered view is dequantized to ``q.dtype`` with ``dequantize_kv``, the
    helper the paged admission forward uses too."""
    kc = Q.dequantize_kv(_gather_pool(kp, tab), _gather_pool(ks, tab), q.dtype)
    vc = Q.dequantize_kv(_gather_pool(vp, tab), _gather_pool(vs, tab), q.dtype)
    return _paged_sdpa(q, kc, vc, lens)


# ---------------------------------------------------------------------------
# full-sequence attention
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale=None) -> torch.Tensor:
    """Attention oracle. q / k / v: ``[B, H, S, hd]`` (same H: GQA is
    expanded by the caller). Causal rows are aligned bottom-right: query row
    i sees the keys up to ``i + Sk - Sq``; a row that sees none gets the
    softmax of equal logits (every key weighed alike)."""
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    logits = ein("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        S_q, S_k = q.shape[2], k.shape[2]
        mask = torch.tril(torch.ones((S_q, S_k), dtype=torch.bool,
                                     device=q.device), diagonal=S_k - S_q)
        # the fill is an fp32 number, so the masked logits are fp32
        logits = torch.where(mask[None, None], logits.to(F32),
                             torch.finfo(F32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return ein("bhqk,bhkd->bhqd", probs, v)

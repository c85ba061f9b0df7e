"""The model and its slot API for continuous batching (dense / moe families).

  Model(cfg, device, generator)                        -> module with random weights
  init_slot_cache(cfg, n_slots, s_max, device)         -> cache dict
  prefill_slots(cfg, model, tokens, lengths)           -> (logits, k, v)
  insert_slots(cache, slots, k_new, v_new, lengths)    -> cache (in place)
  decode_step_slots(cfg, model, cache, token, active)  -> (logits, cache)

The KV cache is updated IN PLACE (the reference returns new arrays): the
dict handed in is the dict handed back. All forwards run under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


class Model(nn.Module):
    """Embedding, the layer stack(s) and the final norm.

    An uncompressed model has one stack, ``stack``. A compressed one
    (``cfg.moe_merged > 0``) has ``stack`` (layers below ``cfg.moe_split``,
    absent at split 0) and ``stack_c`` whose expert tables hold
    ``cfg.moe_merged`` rows; with heterogeneous per-layer budgets
    (``cfg.moe_merged_layers``) the tables stay padded to the largest and each
    layer's ``live`` / ``remap`` keep the pad rows unreachable.

    Weights are drawn layer by layer from ``generator`` (a ``torch.Generator``
    on ``device``), directly in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"only the token-only families (dense / moe) are ported, "
                f"not {cfg.family}")
        self.cfg = cfg
        self.embed = L.Embed(cfg, device, generator)
        if cfg.moe is not None and cfg.moe_merged:
            if cfg.moe_split > 0:
                self.stack = nn.ModuleList(
                    T.Block(cfg, device, generator)
                    for _ in range(cfg.moe_split))
            lives = cfg.live_experts_per_suffix_layer()
            self.stack_c = nn.ModuleList(
                T.Block(cfg, device, generator, n_real=cfg.moe_merged,
                        live=lives[i])
                for i in range(cfg.n_layers - cfg.moe_split))
        else:
            self.stack = nn.ModuleList(
                T.Block(cfg, device, generator) for _ in range(cfg.n_layers))
        self.final_ln = L.RMSNorm(cfg.d_model, cfg.param_dtype, device)
        self.requires_grad_(False)

    def stacks(self) -> List[nn.ModuleList]:
        """The stacks in forward order (``stack`` then ``stack_c``)."""
        return [getattr(self, key) for key in ("stack", "stack_c")
                if hasattr(self, key)]

    @property
    def device(self) -> torch.device:
        return self.final_ln.scale.device


def init(cfg: ModelConfig, device, seed: int = 0) -> Model:
    """A model with random weights from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Model(cfg, device, gen)


def _inv_freq(cfg: ModelConfig, device):
    return L.rope_freqs(cfg.hd, cfg.rope_theta, device=device)


def init_slot_cache(cfg: ModelConfig, n_slots: int, s_max: int,
                    device) -> Dict[str, torch.Tensor]:
    """Persistent KV cache of the continuous-batching engine: one row per
    serving slot, ``pos`` a PER-SLOT length vector."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"slotted serving is token-only (dense/moe), not {cfg.family}")
    dt = cfg.param_dtype
    shape = (cfg.n_layers, n_slots, s_max, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device)}


@torch.inference_mode()
def prefill_slots(cfg: ModelConfig, model: Model, tokens: torch.Tensor,
                  lengths: torch.Tensor):
    """Prefill right-padded prompts for slot insertion.

    tokens: [B, S_bucket] integer prompts padded to a shared bucket length;
    lengths: [B] true prompt lengths. Returns (logits [B, V] fp32 at each
    row's LAST REAL position, k [L, B, S_bucket, nkv, hd], v). Padding rows
    beyond ``lengths[b]`` produce garbage KV, which is harmless: causality
    keeps them out of every real position's context, and the decode mask
    hides them until they are overwritten in place."""
    inv_freq = _inv_freq(cfg, tokens.device)
    x = L.embed_apply(model.embed, tokens)
    ks_l, vs_l = [], []
    for blocks in model.stacks():
        x, ks, vs = T.stack_prefill(cfg, blocks, x, inv_freq=inv_freq)
        ks_l.append(ks)
        vs_l.append(vs)
    ks = torch.cat(ks_l, dim=0) if len(ks_l) > 1 else ks_l[0]
    vs = torch.cat(vs_l, dim=0) if len(vs_l) > 1 else vs_l[0]
    x = L.rmsnorm(model.final_ln, x, cfg.norm_eps)
    last = x[torch.arange(x.shape[0], device=x.device),
             lengths.to(torch.long) - 1]                     # [B, d]
    logits = L.lm_head(cfg, model.embed, last[:, None])[:, 0]
    return logits, ks, vs


@torch.inference_mode()
def insert_slots(cache: Dict[str, torch.Tensor], slots, k_new: torch.Tensor,
                 v_new: torch.Tensor, lengths: torch.Tensor):
    """Write a whole admission group into the cache, IN PLACE.

    k_new/v_new: [L, B, S_bucket, nkv, hd] from one batched
    :func:`prefill_slots`; slots: [B] target slots (distinct where real);
    lengths: [B]. Admission pads its groups to a power of two, and a pad row
    carries a slot id outside ``[0, n_slots)``. The reference relies on its
    scatter dropping such rows; an out-of-range ``index_put_`` on CUDA is a
    device-side assert, so the real rows are selected first and only they
    are written. ``slots`` is read on the host for that (hand it over as a
    host array or CPU tensor to avoid a device read)."""
    n_slots = cache["pos"].shape[0]
    dev = cache["k"].device
    slots_h = torch.as_tensor(slots).to("cpu", torch.long)
    rows_h = torch.nonzero((slots_h >= 0) & (slots_h < n_slots)).reshape(-1)
    if rows_h.numel() == 0:
        return cache
    rows = rows_h.to(dev)
    dst = slots_h[rows_h].to(dev)
    Sb = k_new.shape[2]
    cache["k"][:, dst, :Sb] = k_new.index_select(1, rows).to(cache["k"].dtype)
    cache["v"][:, dst, :Sb] = v_new.index_select(1, rows).to(cache["v"].dtype)
    cache["pos"][dst] = lengths.to(dev).index_select(0, rows).to(
        cache["pos"].dtype)
    return cache


@torch.inference_mode()
def decode_step_slots(cfg: ModelConfig, model: Model,
                      cache: Dict[str, torch.Tensor], token: torch.Tensor,
                      active: torch.Tensor):
    """One decode step across all serving slots; the cache is updated IN
    PLACE.

    token: [B] integer (last sampled token per slot, anything for idle
    slots); active: [B] bool. Idle slots compute alongside but their ``pos``
    does not advance, so they never corrupt state another request will read.
    Returns (logits [B, V] fp32, cache)."""
    inv_freq = _inv_freq(cfg, token.device)
    x = L.embed_apply(model.embed, token[:, None])
    pos = cache["pos"]
    lo = 0
    for blocks in model.stacks():
        hi = lo + len(blocks)
        x, _, _ = T.stack_decode_slots(cfg, blocks, x, cache["k"][lo:hi],
                                       cache["v"][lo:hi], pos,
                                       inv_freq=inv_freq)
        lo = hi
    cache["pos"] = torch.where(active, pos + 1, pos)
    x = L.rmsnorm(model.final_ln, x, cfg.norm_eps)
    logits = L.lm_head(cfg, model.embed, x)[:, 0]
    return logits, cache

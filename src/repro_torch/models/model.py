"""The model: the full-sequence forward and loss, and the slot API for
continuous batching (dense / moe families).

  Model(cfg, device, generator)                        -> module with random weights
  forward(cfg, model, batch, capture)                  -> (logits, aux, captures)
  loss(cfg, model, batch)                              -> (scalar, metrics)
  init_slot_cache(cfg, n_slots, s_max, device)         -> cache dict
  prefill_slots(cfg, model, tokens, lengths)           -> (logits, k, v)
  insert_slots(cache, slots, k_new, v_new, lengths)    -> cache (in place)
  init_paged_cache(cfg, n_slots, s_max, device, ...)   -> paged cache dict
  admit_slots_paged(cfg, model, cache, tokens, lengths, slots, pos0)
                                                       -> (logits, cache)
  decode_step_slots(cfg, model, cache, token, active)  -> (logits, cache)

``decode_step_slots`` serves both layouts: a cache with ``"kp"`` is the paged
pool.

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


@torch.inference_mode()
def forward(cfg: ModelConfig, model: Model, batch: Dict[str, torch.Tensor],
            capture: bool = False):
    """Full-sequence forward. batch: ``{"tokens": [B, S]}``. Returns (logits
    ``[B, S, V]`` fp32, aux loss (summed over the layers), captures or None).
    Captures: ``(expert_inputs [L, B, S, d], usage_counts [L, N])`` of every
    MoE layer, ``stack`` then ``stack_c``."""
    inv_freq = _inv_freq(cfg, batch["tokens"].device)
    x = L.embed_apply(model.embed, batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caps_list = []
    for blocks in model.stacks():
        x, a, caps = T.stack_apply(cfg, blocks, x, inv_freq=inv_freq,
                                   capture=capture)
        aux = aux + a
        caps_list.append(caps)
    caps = None
    if capture and cfg.moe is not None:
        caps = tuple(torch.cat(parts, dim=0) for parts in zip(*caps_list))
    x = L.rmsnorm(model.final_ln, x, cfg.norm_eps)
    return L.lm_head(cfg, model.embed, x), aux, caps


def loss(cfg: ModelConfig, model: Model, batch: Dict[str, torch.Tensor]):
    """Next-token cross-entropy (+ the MoE aux loss times its coefficient).
    Returns (total, {"ce": ce, "aux": aux}), all fp32 scalars."""
    logits, aux, _ = forward(cfg, model, batch)
    tokens = batch["tokens"]
    targets = tokens[:, 1:].to(torch.long)
    lg = logits[:, :-1].to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, targets[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None or tuple(mask.shape) != tuple(targets.shape):
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=lg.device)
    mask = mask.to(torch.float32)
    ce = torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask),
                                                        min=1.0)
    aux_coef = cfg.moe.aux_loss_coef if cfg.moe is not None else 0.0
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}


def init_slot_cache(cfg: ModelConfig, n_slots: int, s_max: int,
                    device, block_size: int = 16) -> Dict[str, torch.Tensor]:
    """Persistent KV cache of the continuous-batching engine: one row per
    serving slot, ``pos`` a PER-SLOT length vector.

    ``k`` / ``v``: ``[L, n_slots, rows, nkv, hd]`` with ``rows`` = ``s_max``
    rounded up to a multiple of ``block_size``: decode attends the cache as a
    pool of ``block_size``-row blocks through the paged kernel
    (``layers.attn_decode_slots``), the paged layout's block size keeping
    dense and paged decode one computation. Rows past ``s_max`` are never
    visible. ``s_max`` and ``kv_block`` ride along as 0-d int tensors on the
    host (read without a device sync)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"slotted serving is token-only (dense/moe), not {cfg.family}")
    dt = cfg.param_dtype
    rows = -(-s_max // block_size) * block_size
    shape = (cfg.n_layers, n_slots, rows, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
            "s_max": torch.tensor(s_max), "kv_block": torch.tensor(block_size)}


def init_paged_cache(cfg: ModelConfig, n_slots: int, s_max: int, device, *,
                     n_blocks: int, block_size: int,
                     kv_dtype: str = "bf16") -> Dict[str, torch.Tensor]:
    """Paged KV pool of the continuous-batching engine.

    ``kp``/``vp``: ``[L, n_blocks + 1, block_size, nkv, hd]`` in the model
    type, or int8 with ``ks``/``vs`` ``[L, n_blocks + 1, block_size, nkv]``
    fp32 scales when ``kv_dtype == "int8"``. Blocks ``0 .. n_blocks - 1`` are
    the allocator's; the last one is a write-only sink for writes through a
    sentinel id (see ``layers._paged_write``), one block per layer more than
    the reference allocates. ``tab``: ``[n_slots + 1, s_max // block_size]``
    int32 block ids, ``n_blocks`` (the sentinel) for unallocated entries and
    the whole last row (the reference's row for admission pads, which the
    allocator's host table keeps and ships whole; no step of the port reads
    it). ``pos``: ``[n_slots]`` int32. Zeros everywhere, so a
    never-written row is finite. Block ownership lives on the host
    (``serving.paging.PagedAllocator``)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"paged serving is token-only (dense/moe), not {cfg.family}")
    if s_max % block_size:
        raise ValueError(f"s_max={s_max} not a multiple of "
                         f"block_size={block_size}")
    mb = s_max // block_size
    pshape = (cfg.n_layers, n_blocks + 1, block_size, cfg.n_kv_heads, cfg.hd)
    cache = {"pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
             "tab": torch.full((n_slots + 1, mb), n_blocks, dtype=torch.int32,
                               device=device)}
    if kv_dtype == "int8":
        cache.update(
            kp=torch.zeros(pshape, dtype=torch.int8, device=device),
            vp=torch.zeros(pshape, dtype=torch.int8, device=device),
            ks=torch.zeros(pshape[:-1], dtype=torch.float32, device=device),
            vs=torch.zeros(pshape[:-1], dtype=torch.float32, device=device))
    elif kv_dtype == "bf16":
        dt = cfg.param_dtype
        cache.update(kp=torch.zeros(pshape, dtype=dt, device=device),
                     vp=torch.zeros(pshape, dtype=dt, device=device))
    else:
        raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got "
                         f"{kv_dtype!r}")
    return cache


def _paged_forward(cfg: ModelConfig, model: Model,
                   cache: Dict[str, torch.Tensor], x: torch.Tensor, stack_fn,
                   tab: torch.Tensor, pos: torch.Tensor,
                   inv_freq) -> torch.Tensor:
    """Run a paged stack function over the model's stacks, each on its
    slice of the pools' layer axis (``stack`` below ``cfg.moe_split``,
    ``stack_c`` above). The pools are updated in place; ``pos`` / ``tab``
    are the caller's business."""
    quant = "ks" in cache
    lo = 0
    for blocks in model.stacks():
        hi = lo + len(blocks)
        x = stack_fn(cfg, blocks, x, cache["kp"][lo:hi], cache["vp"][lo:hi],
                     cache["ks"][lo:hi] if quant else None,
                     cache["vs"][lo:hi] if quant else None, tab, pos,
                     inv_freq=inv_freq)
        lo = hi
    return x


@torch.inference_mode()
def admit_slots_paged(cfg: ModelConfig, model: Model,
                      cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                      lengths: torch.Tensor, slots, pos0: torch.Tensor):
    """Admit right-padded prompt SUFFIXES into the paged cache, IN PLACE.

    tokens: ``[B, S_bucket]`` (each prompt minus the shared-prefix rows it
    adopted); lengths: ``[B]`` true suffix lengths (>= 1); slots: ``[B]``
    distinct real target slots, a host array (the engine never pads an
    admission group, unlike the reference); pos0: ``[B]`` shared-prefix row
    counts. A verify-shaped forward at absolute positions ``pos0[b] +
    arange(S_bucket)``: the suffix attends the adopted prefix rows through
    the slot's table, so with ``pos0 = 0`` it is the dense admission over a
    paged layout. ``pos`` is set to ``pos0 + lengths``. Returns (logits
    ``[B, V]`` fp32 at each row's last real suffix position, cache)."""
    dev = tokens.device
    slots_d = torch.as_tensor(slots).to(dev, torch.long)
    inv_freq = _inv_freq(cfg, dev)
    x = L.embed_apply(model.embed, tokens)
    pos0 = pos0.to(dev, torch.int32)
    x = _paged_forward(cfg, model, cache, x, T.stack_verify_paged,
                       cache["tab"][slots_d], pos0, inv_freq)
    cache["pos"][slots_d] = pos0 + lengths.to(dev, torch.int32)
    x = L.rmsnorm(model.final_ln, x, cfg.norm_eps)
    last = x[torch.arange(x.shape[0], device=dev),
             lengths.to(dev, torch.long) - 1]
    logits = L.lm_head(cfg, model.embed, last[:, None])[:, 0]
    return logits, cache


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

    k_new/v_new: [L, B, S_bucket, nkv, hd] from :func:`prefill_slots`;
    slots: [B] target slots (distinct where real); lengths: [B]. A row whose
    slot id lies outside ``[0, n_slots)`` is padding. The reference relies on
    its scatter dropping such rows; an out-of-range ``index_put_`` on CUDA is
    a device-side assert, so the real rows are selected first and only they
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
    if "kp" in cache:                                  # the paged pool
        x = _paged_forward(cfg, model, cache, x, T.stack_decode_paged,
                           cache["tab"][:pos.shape[0]], pos, inv_freq)
        cache["pos"] = torch.where(active, pos + 1, pos)
        x = L.rmsnorm(model.final_ln, x, cfg.norm_eps)
        return L.lm_head(cfg, model.embed, x)[:, 0], cache
    view = L.decode_view(pos, cache["k"].shape[2], int(cache["s_max"]),
                         int(cache["kv_block"]))     # one for every layer
    lo = 0
    for blocks in model.stacks():
        hi = lo + len(blocks)
        x, _, _ = T.stack_decode_slots(cfg, blocks, x, cache["k"][lo:hi],
                                       cache["v"][lo:hi], pos,
                                       inv_freq=inv_freq, view=view)
        lo = hi
    cache["pos"] = torch.where(active, pos + 1, pos)
    x = L.rmsnorm(model.final_ln, x, cfg.norm_eps)
    logits = L.lm_head(cfg, model.embed, x)[:, 0]
    return logits, cache

"""The model over every family: the full-sequence forward and loss, the
non-slot serving API (one position for the whole batch, the fixed-batch
server's) and the slot API for continuous batching (dense / moe families).

  Model(cfg, device, generator)                        -> module with random weights
  forward(cfg, model, batch, capture, train)           -> (logits, aux, captures)
  loss(cfg, model, batch, train)                       -> (scalar, metrics)
  trainable(model, on)                                 -> model (requires_grad)
  leaf_groups(model)                                   -> {reference leaf: tensors}
  shape_tree(model)                                    -> reference-layout stand-ins
  init_cache(cfg, batch_size, s_max, device)           -> cache dict
  prefill(cfg, model, batch, s_max)                    -> (logits, cache)
  decode_step(cfg, model, cache, token)                -> (logits, cache)
  init_slot_cache(cfg, n_slots, s_max, device)         -> cache dict
  slot_consts(cfg, cache)                              -> SlotConsts
  prefill_slots(cfg, model, tokens, lengths)           -> (logits, k, v)
  insert_slots(cache, slots, k_new, v_new, lengths)    -> cache (in place)
  insert_slot(cache, slot, k_new, v_new, lengths)      -> cache (in place)
  init_paged_cache(cfg, n_slots, s_max, device, ...)   -> paged cache dict
  admit_slots_paged(cfg, model, cache, tokens, lengths, slots, pos0)
                                                       -> (logits, cache)
  decode_step_slots(cfg, model, cache, token, active)  -> (logits, cache)
  verify_step_slots(cfg, model, cache, tokens)         -> (logits, cache)

Batch keys by family: ``tokens [B, S]`` for all; ``vlm`` may add ``patches
[B, P, d_model]`` (prepended to the text, their positions dropped from the
logits), ``audio`` needs ``frames [B, n_audio_ctx, d_model]`` (the
encoder's input). ``decode_step_slots`` and ``verify_step_slots`` serve both
layouts: a cache with ``"kp"`` is the paged pool.

The KV cache is updated IN PLACE (the reference returns new arrays): the
dict handed in is the dict handed back, and every tensor in it keeps its
storage from step to step (``pos`` too is written in place, a ``[B]``
vector in a slot cache, a 0-d tensor in the non-slot one), so a CUDA graph
captured over a step replays against the same cache. Given its
``SlotConsts`` (``inv_freq=`` / ``consts=``) and a device slot index, a
step reads no tensor on the host and builds no tensor from host data. The
serving forwards run under ``torch.inference_mode()``, and so do
``forward`` / ``loss`` unless ``train=True``: then they build the autograd
graph through the reference's training arithmetic on both devices (no
hand-written kernel, each block under ``cfg.remat``), for the train step
(``launch/steps.py :: make_train_step``), every family. The parameters are
frozen until :func:`trainable` turns ``requires_grad`` on for the floating
ones.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.models import layers as L
from repro_torch.models import mamba as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


#: the families a Model takes; the engine serves the first two only
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


class Model(nn.Module):
    """Embedding, the layers of ``cfg.family`` and the final norm, the
    reference's parameter tree one module per leaf group:

    * ``dense`` / ``moe`` / ``vlm``: the decoder stack ``stack``. A
      compressed one (``cfg.moe_merged > 0``) has ``stack`` (layers below
      ``cfg.moe_split``, absent at split 0) and ``stack_c`` whose expert
      tables hold ``cfg.moe_merged`` rows; with heterogeneous per-layer
      budgets (``cfg.moe_merged_layers``) the tables stay padded to the
      largest and each layer's ``live`` / ``remap`` keep the pad rows
      unreachable;
    * ``ssm``: ``ssm_ln`` and ``ssm``, one norm and one Mamba2 block a layer;
    * ``hybrid``: ``hybrid`` (``transformer.HybridStack``);
    * ``audio``: ``encdec`` (``transformer.EncDec``).

    Weights are drawn layer by layer from ``generator`` (a ``torch.Generator``
    on ``device``), directly in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family}")
        self.cfg = cfg
        self.embed = L.Embed(cfg, device, generator)
        dt = cfg.param_dtype
        if cfg.family == "ssm":
            self.ssm_ln = nn.ModuleList(L.RMSNorm(cfg.d_model, dt, device)
                                        for _ in range(cfg.n_layers))
            self.ssm = nn.ModuleList(S.Mamba(cfg, device, generator)
                                     for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            self.hybrid = T.HybridStack(cfg, device, generator)
        elif cfg.family == "audio":
            self.encdec = T.EncDec(cfg, device, generator)
        elif cfg.moe is not None and cfg.moe_merged:
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
        self.final_ln = L.RMSNorm(cfg.d_model, dt, device)
        self.requires_grad_(False)

    def stacks(self) -> List[nn.ModuleList]:
        """The decoder stacks in forward order (``stack`` then ``stack_c``;
        none in the ssm, hybrid and audio families)."""
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


def trainable(model: Model, on: bool = True) -> Model:
    """Turn ``requires_grad`` on (or off) for the model's floating
    parameters; the integer ``remap`` / ``live`` are buffers and stay out of
    autograd."""
    for p in model.parameters():
        p.requires_grad_(on and p.is_floating_point())
    return model


def split_name(name: str) -> Tuple[str, Optional[int]]:
    """A module path's reference leaf name and layer: the first integer
    component is the layer index of a stack the reference stacks along a
    leading ``[L, ...]`` axis (``"stack.3.attn.wq"`` -> ``("stack.attn.wq",
    3)``, ``"hybrid.mamba.5.A_log"`` -> ``("hybrid.mamba.A_log", 5)``);
    ``(name, None)`` for a leaf outside any stack."""
    parts = name.split(".")
    for i, part in enumerate(parts):
        if part.isdigit():
            return ".".join(parts[:i] + parts[i + 1:]), int(part)
    return name, None


def leaf_groups(model: Model) -> Dict[str, Tuple[List[torch.Tensor], bool]]:
    """Every leaf of the reference's parameter tree by its dotted name
    (``"stack.attn.wq"``, ``"embed.tok"``, ``"hybrid.shared_attn.wq"``), in
    the model's own tensors: ``(the layers' tensors in order, True)`` for a
    layer stack's leaf (:func:`split_name`), ``([tensor], False)`` for a
    leaf outside the stacks."""
    named = dict(model.named_parameters())
    named.update(dict(model.named_buffers()))
    out: Dict[str, Tuple[List[torch.Tensor], bool]] = {}
    for name, t in named.items():
        ref, layer = split_name(name)
        if layer is None:
            out[name] = ([t], False)
        else:
            out.setdefault(ref, ([], True))[0].append(t)
    return out


def nest(flat: Dict[str, object]) -> dict:
    """Dotted names -> nested dicts (the reference's tree)."""
    tree: dict = {}
    for name, val in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


def shape_tree(model: Model) -> dict:
    """The reference's parameter tree of ``model`` as stand-ins that take
    no memory: zero-stride tensors of each leaf's shape (stacked leaves
    ``[L, ...]``), dtype and device, for ``Optimizer.init``."""
    def stand_in(tensors, stacked):
        t = tensors[0]
        shape = ((len(tensors),) if stacked else ()) + tuple(t.shape)
        return torch.zeros((), dtype=t.dtype, device=t.device).expand(shape)
    return nest({name: stand_in(*g) for name, g in leaf_groups(model).items()})


def _inv_freq(cfg: ModelConfig, device):
    """RoPE's inverse frequencies, None for an attention-free family."""
    if cfg.is_attention_free:
        return None
    return L.rope_freqs(cfg.hd, cfg.rope_theta, device=device)


class SlotConsts(NamedTuple):
    """What a slot step reads besides the model, the cache and its inputs,
    built once per cache (per engine) by :func:`slot_consts`: the RoPE
    inverse frequencies on the cache's device (``layers.rope_freqs`` builds
    them from a host scalar) and the dense cache's capacity and block size
    as host ints (None for the paged pool, whose table carries both)."""
    inv_freq: torch.Tensor
    s_max: Optional[int]
    kv_block: Optional[int]


def slot_consts(cfg: ModelConfig, cache: Dict[str, torch.Tensor]) -> SlotConsts:
    """The :class:`SlotConsts` of ``cache`` (dense or paged, or the non-slot
    cache of :func:`init_cache`), the same ops as a step that builds them
    itself, so the bits are the same. A cache without K/V rows (the ssm
    family's) has no capacity or block size: None."""
    inv_freq = _inv_freq(cfg, cache["pos"].device)
    if "kp" in cache or "s_max" not in cache:
        return SlotConsts(inv_freq, None, None)
    return SlotConsts(inv_freq, int(cache["s_max"]), int(cache["kv_block"]))


def _ssm_stack(cfg: ModelConfig, model: Model, x: torch.Tensor,
               return_states: bool = False, train: bool = False):
    """The ssm family's layers over a full sequence. Returns y, and with
    ``return_states`` the per-layer :class:`mamba.SSMState` list. ``train``:
    each layer (its norm, block and residual) under ``cfg.remat``, the
    reference's ``_maybe_remat`` around its scan body."""
    states = []
    for ln, mp in zip(model.ssm_ln, model.ssm):
        if train:
            x = T._remat(cfg, functools.partial(T.mamba_layer, cfg, ln, mp),
                         x)
        elif return_states:
            out, st = S.mamba_apply(cfg, mp, L.rmsnorm(ln, x, cfg.norm_eps),
                                    return_state=True)
            states.append(st)
            x = x + out
        else:
            x = T.mamba_layer(cfg, ln, mp, x)
    return (x, states) if return_states else x


def _with_patches(cfg: ModelConfig, x: torch.Tensor, batch) -> torch.Tensor:
    """The vlm family's ``patches`` prepended to the text embeddings."""
    if cfg.family == "vlm" and "patches" in batch:
        return torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def forward(cfg: ModelConfig, model: Model, batch: Dict[str, torch.Tensor],
            capture: bool = False, train: bool = False):
    """Full-sequence forward. batch: ``{"tokens": [B, S]}`` (and ``patches``
    / ``frames``, module docstring). Returns (logits ``[B, S, V]`` fp32, aux
    loss (summed over the layers), captures or None). Captures:
    ``(expert_inputs [L, B, S, d], usage_counts [L, N])`` of every MoE
    layer, ``stack`` then ``stack_c``. ``train``: outside inference mode,
    the training arithmetic, differentiable (module docstring)."""
    with contextlib.nullcontext() if train else torch.inference_mode():
        dev = batch["tokens"].device
        inv_freq = _inv_freq(cfg, dev)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        caps = None
        x = L.embed_apply(model.embed, batch["tokens"])
        if cfg.family == "audio":
            enc_out = T.encode(cfg, model.encdec, batch["frames"],
                               train=train)
            x = T.decode_stack_apply(cfg, model.encdec, x, enc_out,
                                     inv_freq=inv_freq, train=train)
        elif cfg.family == "ssm":
            x = _ssm_stack(cfg, model, x, train=train)
        elif cfg.family == "hybrid":
            x = T.hybrid_apply(cfg, model.hybrid, x, inv_freq=inv_freq,
                               train=train)
        else:
            x = _with_patches(cfg, x, batch)
            caps_list = []
            for blocks in model.stacks():
                x, a, c = T.stack_apply(cfg, blocks, x, inv_freq=inv_freq,
                                        capture=capture, train=train)
                aux = aux + a
                caps_list.append(c)
            if capture and cfg.moe is not None:
                caps = tuple(torch.cat(parts, dim=0)
                             for parts in zip(*caps_list))
            if cfg.family == "vlm" and "patches" in batch:
                x = x[:, batch["patches"].shape[1]:]   # text positions only
        x = L.rmsnorm(model.final_ln, x, cfg.norm_eps)
        return L.lm_head(cfg, model.embed, x, train=train), aux, caps


def loss(cfg: ModelConfig, model: Model, batch: Dict[str, torch.Tensor],
         train: bool = False):
    """Next-token cross-entropy (+ the MoE aux loss times its coefficient).
    Returns (total, {"ce": ce, "aux": aux}), all fp32 scalars. ``train``:
    :func:`forward`'s."""
    logits, aux, _ = forward(cfg, model, batch, train=train)
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


# ---------------------------------------------------------------------------
# the non-slot API: one position for the whole batch (the fixed-batch server)
# ---------------------------------------------------------------------------

#: rows per block of the non-slot cache seen as a pool (the engine's default
#: ``kv_block``)
KV_BLOCK = 16


def init_cache(cfg: ModelConfig, batch_size: int, s_max: int,
               device) -> Dict[str, object]:
    """The decode cache of :func:`prefill` / :func:`decode_step`, zeros,
    ``pos`` a 0-d int32 tensor on ``device``.

    * dense / moe / vlm / audio: ``k`` / ``v`` ``[L, B, rows, nkv, hd]``
      (audio: the decoder's self-attention), ``rows`` = ``s_max`` rounded
      up to a multiple of :data:`KV_BLOCK` (decode reads the cache through the
      paged kernel over a contiguous table, ``layers.attn_decode``; the rows
      past ``pos`` are masked, the rows past ``s_max`` never visible), with
      ``s_max`` and ``kv_block`` as 0-d int tensors on the host; audio adds
      ``enc`` ``[B, n_audio_ctx, d]``, the encoder's output;
    * ssm: ``ssm``, a :class:`mamba.SSMState` of the layers' states stacked
      ``[L, ...]``;
    * hybrid: ``ssm`` as ssm, and ``k`` / ``v`` ``[nseg, B, rows, nkv, hd]``,
      one entry per segment of the shared attention block.

    The reference allocates the prompt's rows and pads them to ``s_max``
    after the prefill; here the rows are allocated up front."""
    cache: Dict[str, object] = {
        "pos": torch.zeros((), dtype=torch.int32, device=device)}
    rows = -(-s_max // KV_BLOCK) * KV_BLOCK
    kv_layers = (0 if cfg.family == "ssm" else T.n_segments(cfg)
                 if cfg.family == "hybrid" else cfg.n_layers)
    if cfg.family in ("ssm", "hybrid"):
        st = S.init_ssm_state(cfg, batch_size, device)
        cache["ssm"] = S.SSMState(
            *(torch.zeros((cfg.n_layers,) + tuple(a.shape), dtype=a.dtype,
                          device=device) for a in st))
    if kv_layers:
        shape = (kv_layers, batch_size, rows, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=cfg.param_dtype, device=device)
        cache["v"] = torch.zeros_like(cache["k"])
        cache["s_max"] = torch.tensor(s_max)
        cache["kv_block"] = torch.tensor(KV_BLOCK)
    if cfg.family == "audio":
        cache["enc"] = torch.zeros((batch_size, cfg.n_audio_ctx, cfg.d_model),
                                   dtype=cfg.param_dtype, device=device)
    return cache


@torch.inference_mode()
def prefill(cfg: ModelConfig, model: Model, batch: Dict[str, torch.Tensor],
            s_max: Optional[int] = None, cache: Optional[Dict] = None,
            inv_freq: Optional[torch.Tensor] = None):
    """Process the prompts (batch as :func:`forward`'s); returns
    (last-position logits ``[B, V]`` fp32, cache). ``s_max``: the cache's
    capacity in positions (prompt, patches included, plus the generation
    budget; default, or anything smaller: the prompt's length, no room to
    decode), the reference's.

    ``cache``: an :func:`init_cache` cache of this batch size and room for
    the prompt, written IN PLACE (the K/V rows zeroed first, so it ends as a
    new one would) and handed back, in place of a new one (``s_max`` then
    unused): what a graph captured over the prefill replays into.
    ``inv_freq``: the RoPE frequencies (``slot_consts``; default: built
    here). With both, the prefill reads nothing on the host."""
    tokens = batch["tokens"]
    B, dev = tokens.shape[0], tokens.device
    if inv_freq is None:
        inv_freq = _inv_freq(cfg, dev)
    x = L.embed_apply(model.embed, tokens)
    ks = vs = states = enc_out = None
    if cfg.family == "audio":
        enc_out = T.encode(cfg, model.encdec, batch["frames"])
        x, ks, vs = T.decode_stack_prefill(cfg, model.encdec, x, enc_out,
                                           inv_freq=inv_freq)
    elif cfg.family == "ssm":
        x, states = _ssm_stack(cfg, model, x, return_states=True)
    elif cfg.family == "hybrid":
        x, states, ks, vs = T.hybrid_prefill(cfg, model.hybrid, x,
                                             inv_freq=inv_freq)
    else:
        x = _with_patches(cfg, x, batch)
        ks_l, vs_l = [], []
        for blocks in model.stacks():
            x, k, v = T.stack_prefill(cfg, blocks, x, inv_freq=inv_freq)
            ks_l.append(k)
            vs_l.append(v)
        ks, vs = torch.cat(ks_l, dim=0), torch.cat(vs_l, dim=0)
    n = x.shape[1]
    if cache is None:
        cache = init_cache(cfg, B, max(n, s_max or 0), dev)
    elif "k" in cache:
        if cache["k"].shape[1] != B or cache["k"].shape[2] < n:
            raise ValueError(f"a cache of {tuple(cache['k'].shape[1:3])} "
                             f"(batch, rows) does not take {B} prompts of "
                             f"{n} positions")
        cache["k"].zero_()
        cache["v"].zero_()
    if ks is not None:
        cache["k"][:, :, :n] = ks
        cache["v"][:, :, :n] = vs
    if states is not None:
        for field, stacked in zip(S.SSMState._fields, cache["ssm"]):
            stacked.copy_(torch.stack([getattr(st, field) for st in states]))
    if enc_out is not None:
        cache["enc"].copy_(enc_out)
    cache["pos"].fill_(n)
    x = L.rmsnorm(model.final_ln, x[:, -1:], cfg.norm_eps)
    return L.lm_head(cfg, model.embed, x)[:, 0], cache


@torch.inference_mode()
def decode_step(cfg: ModelConfig, model: Model, cache: Dict[str, object],
                token: torch.Tensor, consts: Optional[SlotConsts] = None):
    """One decode step of the whole batch at the cache's one position; the
    cache is updated IN PLACE (``pos`` advanced in its tensor). token:
    ``[B]`` integer. The attention layers write their K/V row at ``pos`` and
    attend rows ``<= pos`` through ``layers.attn_decode`` (the paged kernel
    over the contiguous table, as the engine's dense decode), the Mamba2
    layers advance their states. ``consts``: the cache's
    :func:`slot_consts` (default: built here); given them, the step reads
    nothing on the host. Returns (logits ``[B, V]`` fp32, cache)."""
    c = slot_consts(cfg, cache) if consts is None else consts
    inv_freq = c.inv_freq
    x = L.embed_apply(model.embed, token[:, None])
    pos = cache["pos"]
    view = None
    if "k" in cache:                           # one for every layer
        view = L.decode_view(pos.expand(x.shape[0]), cache["k"].shape[2],
                             c.s_max, c.kv_block)
    if cfg.family == "audio":
        x = T.decode_stack_step(cfg, model.encdec, x, cache["enc"],
                                cache["k"], cache["v"], pos,
                                inv_freq=inv_freq, view=view)
    elif cfg.family == "ssm":
        x = T.ssm_layers_decode(cfg, model.ssm_ln, model.ssm, x, cache["ssm"],
                                range(cfg.n_layers))
    elif cfg.family == "hybrid":
        x = T.hybrid_decode(cfg, model.hybrid, x, cache, pos,
                            inv_freq=inv_freq, view=view)
    else:
        lo = 0
        for blocks in model.stacks():
            hi = lo + len(blocks)
            x, _, _ = T.stack_decode(cfg, blocks, x, cache["k"][lo:hi],
                                     cache["v"][lo:hi], pos,
                                     inv_freq=inv_freq, view=view)
            lo = hi
    pos.add_(1)
    x = L.rmsnorm(model.final_ln, x, cfg.norm_eps)
    return L.lm_head(cfg, model.embed, x)[:, 0], cache


def init_slot_cache(cfg: ModelConfig, n_slots: int, s_max: int,
                    device, block_size: int = 16,
                    lookahead: int = 0) -> Dict[str, torch.Tensor]:
    """Persistent KV cache of the continuous-batching engine: one row per
    serving slot, ``pos`` a PER-SLOT length vector.

    ``k`` / ``v``: ``[L, n_slots, rows, nkv, hd]`` with ``rows`` = ``s_max +
    lookahead`` rounded up to a multiple of ``block_size``: decode attends
    the cache as a pool of ``block_size``-row blocks through the paged kernel
    (``layers.attn_decode_slots``), the paged layout's block size keeping
    dense and paged decode one computation. Rows past ``s_max`` are never
    visible; ``lookahead`` spare rows take a speculative verify's writes
    past the committed stream (``spec_k + 1`` in a speculative engine), each
    in a row of its own. ``s_max`` and ``kv_block`` ride along as 0-d int
    tensors on the host (read without a device sync)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"slotted serving is token-only (dense/moe), not {cfg.family}")
    dt = cfg.param_dtype
    rows = -(-(s_max + lookahead) // block_size) * block_size
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
                      lengths: torch.Tensor, slots, pos0: torch.Tensor,
                      inv_freq: Optional[torch.Tensor] = None):
    """Admit right-padded prompt SUFFIXES into the paged cache, IN PLACE.

    tokens: ``[B, S_bucket]`` (each prompt minus the shared-prefix rows it
    adopted); lengths: ``[B]`` true suffix lengths (>= 1); slots: ``[B]``
    distinct real target slots, a host array or an integer tensor on the
    cache's device (the graph-safe form: no copy from host memory; the
    engine never pads an admission group, unlike the reference); pos0:
    ``[B]`` shared-prefix row counts; ``inv_freq``: the cache's
    ``SlotConsts.inv_freq`` (default: built here). A verify-shaped forward
    at absolute positions ``pos0[b] +
    arange(S_bucket)``: the suffix attends the adopted prefix rows through
    the slot's table, so with ``pos0 = 0`` it is the dense admission over a
    paged layout. ``pos`` is set to ``pos0 + lengths``. Returns (logits
    ``[B, V]`` fp32 at each row's last real suffix position, cache)."""
    dev = tokens.device
    slots_d = torch.as_tensor(slots).to(dev, torch.long)
    if inv_freq is None:
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
                  lengths: torch.Tensor,
                  inv_freq: Optional[torch.Tensor] = None):
    """Prefill right-padded prompts for slot insertion.

    tokens: [B, S_bucket] integer prompts padded to a shared bucket length;
    lengths: [B] true prompt lengths; ``inv_freq``: ``SlotConsts.inv_freq``
    (default: built here). Returns (logits [B, V] fp32 at each
    row's LAST REAL position, k [L, B, S_bucket, nkv, hd], v). Padding rows
    beyond ``lengths[b]`` produce garbage KV, which is harmless: causality
    keeps them out of every real position's context, and the decode mask
    hides them until they are overwritten in place."""
    if inv_freq is None:
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
    return insert_slot(cache, slots_h[rows_h].to(dev),
                       k_new.index_select(1, rows), v_new.index_select(1, rows),
                       lengths.to(dev).index_select(0, rows))


@torch.inference_mode()
def insert_slot(cache: Dict[str, torch.Tensor], slot: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor,
                lengths: torch.Tensor):
    """:func:`insert_slots` of real rows only, IN PLACE: ``slot`` ``[B]``
    distinct slot ids in ``[0, n_slots)`` as an integer tensor on the cache's
    device, read nowhere on the host (the form a CUDA graph captures: the
    admission graph's slot is a one-element input). k_new/v_new ``[L, B,
    S_bucket, nkv, hd]``; lengths ``[B]``."""
    dst = slot.to(torch.long)
    Sb = k_new.shape[2]
    cache["k"][:, dst, :Sb] = k_new.to(cache["k"].dtype)
    cache["v"][:, dst, :Sb] = v_new.to(cache["v"].dtype)
    cache["pos"][dst] = lengths.to(cache["pos"].dtype)
    return cache


@torch.inference_mode()
def decode_step_slots(cfg: ModelConfig, model: Model,
                      cache: Dict[str, torch.Tensor], token: torch.Tensor,
                      active: torch.Tensor,
                      consts: Optional[SlotConsts] = None):
    """One decode step across all serving slots; the cache is updated IN
    PLACE (``pos`` included, written into the same tensor).

    token: [B] integer (last sampled token per slot, anything for idle
    slots); active: [B] bool; ``consts``: the cache's :func:`slot_consts`
    (default: built here, which reads the dense cache's host scalars). Idle
    slots compute alongside but their ``pos`` does not advance, so they never
    corrupt state another request will read. Returns (logits [B, V] fp32,
    cache)."""
    consts = slot_consts(cfg, cache) if consts is None else consts
    inv_freq = consts.inv_freq
    x = L.embed_apply(model.embed, token[:, None])
    pos = cache["pos"]
    if "kp" in cache:                                  # the paged pool
        x = _paged_forward(cfg, model, cache, x, T.stack_decode_paged,
                           cache["tab"][:pos.shape[0]], pos, inv_freq)
        pos.copy_(torch.where(active, pos + 1, pos))
        x = L.rmsnorm(model.final_ln, x, cfg.norm_eps)
        return L.lm_head(cfg, model.embed, x)[:, 0], cache
    view = L.decode_view(pos, cache["k"].shape[2], consts.s_max,
                         consts.kv_block)              # one for every layer
    lo = 0
    for blocks in model.stacks():
        hi = lo + len(blocks)
        x, _, _ = T.stack_decode_slots(cfg, blocks, x, cache["k"][lo:hi],
                                       cache["v"][lo:hi], pos,
                                       inv_freq=inv_freq, view=view)
        lo = hi
    pos.copy_(torch.where(active, pos + 1, pos))
    x = L.rmsnorm(model.final_ln, x, cfg.norm_eps)
    logits = L.lm_head(cfg, model.embed, x)[:, 0]
    return logits, cache


@torch.inference_mode()
def verify_step_slots(cfg: ModelConfig, model: Model,
                      cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                      consts: Optional[SlotConsts] = None):
    """Multi-position forward across all serving slots (speculative
    verify); the cache is updated IN PLACE, ``pos`` is NOT advanced.

    tokens: ``[B, T]`` integer, slot b's last committed token followed by
    its draft proposals, at positions ``pos[b] .. pos[b] + T - 1``: their
    K/V rows are written (dense cache, or the paged pool in bf16 or int8;
    both stacks of a split model) and every position is scored. How many of
    the T positions become committed is the acceptance rule's decision
    (``serving.spec``), which moves ``pos``. ``consts``: the cache's
    :func:`slot_consts`.

    The contract: the logits of ``(b, t)`` and the K/V rows written are
    BITWISE what :func:`decode_step_slots` computes when fed the same tokens
    one position at a time, on the card and on the CPU. The activations run
    position-major: T blocks ``[B, 1, d]``, each through the decode step's
    own calls at the decode step's shapes (embedding, norms, projections,
    RoPE, router, LM head: a library product or a reduction may give a row
    other bits at another row count), while the hand-written kernels, whose
    rows do not depend on the other rows of a call, take all ``T * B`` rows
    in one launch each: the paged attention kernel with per-row ``lens``
    (``layers.attn_verify_slots``, ``attn_verify_slots_paged``) and the
    grouped MoE kernel (``moe.moe_apply_rows``; decode runs the gather
    kernel, and gather == grouped bitwise). Returns (logits ``[B, T, V]``
    fp32, cache)."""
    consts = slot_consts(cfg, cache) if consts is None else consts
    inv_freq = consts.inv_freq
    xs = [L.embed_apply(model.embed, tokens[:, t:t + 1])
          for t in range(tokens.shape[1])]
    pos = cache["pos"]
    if "kp" in cache:                                  # the paged pool
        xs = _paged_forward(cfg, model, cache, xs, T.stack_verify_slots_paged,
                            cache["tab"][:pos.shape[0]], pos, inv_freq)
    else:
        view = L.decode_view(pos, cache["k"].shape[2], consts.s_max,
                             consts.kv_block)
        lo = 0
        for blocks in model.stacks():
            hi = lo + len(blocks)
            xs = T.stack_verify_slots(cfg, blocks, xs, cache["k"][lo:hi],
                                      cache["v"][lo:hi], pos,
                                      inv_freq=inv_freq, view=view)
            lo = hi
    logits = [L.lm_head(cfg, model.embed,
                        L.rmsnorm(model.final_ln, x, cfg.norm_eps))[:, 0]
              for x in xs]
    return torch.stack(logits, dim=1), cache

"""Layer stacks: decoder-only (dense MLP or MoE blocks; the full-sequence
forward with calibration capture, and the serving path: prefill, decode at
one position or per slot, speculative verify), hybrid (Mamba2 blocks and one
shared attention / MLP block, zamba2) and encoder-decoder (whisper).

The reference scans stacked ``[L, ...]`` parameters; here a stack is a Python
sequence of :class:`Block` modules and the scan is a loop. Under training
(``train=True``) each block (a decoder-only block, a hybrid's Mamba2 layer
but not its shared block, an encoder or decoder block) is rematerialised
as ``cfg.remat`` asks, the reference's ``_maybe_remat``: ``"full"`` keeps
only the block's input (``torch.utils.checkpoint``), ``"dots"`` also keeps
the outputs of its matrix products (selective checkpointing). The reference also puts a
``bf16_cotangent`` barrier after each block, an identity in both passes on a
bf16 model (its cotangents are bf16 already) that fails on an fp32 one; the
port has no barrier, so an fp32 model trains with fp32 cotangents.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.utils import checkpoint as CP

from repro_torch.models import layers as L
from repro_torch.models import mamba as S
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
                positions=None, causal: bool = True, capture: bool = False,
                train: bool = False):
    """Full-sequence block. Returns (y, aux_loss, capture) with capture
    ``(expert_inputs [B, S, d], usage_counts [N])`` of the MoE layer when
    ``capture`` (None otherwise and for dense MLP blocks). ``train``: the
    training arithmetic (``layers``' module docstring)."""
    a = L.attn_apply(cfg, p.attn, L.rmsnorm(p.ln1, x, cfg.norm_eps),
                     inv_freq=inv_freq, positions=positions, causal=causal,
                     train=train)
    h = x + a
    hn = L.rmsnorm(p.ln2, h, cfg.norm_eps)
    if cfg.moe is not None:
        out = M.moe_apply(cfg, p.moe, hn, capture=capture, train=train)
        cap = (out.expert_inputs, out.usage_counts) if capture else None
        return h + out.y, out.aux_loss, cap
    return (h + L.mlp_apply(p.mlp, hn, train=train),
            torch.zeros((), dtype=torch.float32, device=x.device), None)


#: the products whose outputs ``remat="dots"`` keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CP.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CP.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under ``cfg.remat`` (``"none"``, ``"full"``,
    ``"dots"``), the reference's ``_maybe_remat``."""
    if cfg.remat == "full":
        return CP.checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return CP.checkpoint(fn, *args, use_reentrant=False,
                             context_fn=functools.partial(
                                 CP.create_selective_checkpoint_contexts,
                                 _dots_policy))
    if cfg.remat != "none":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return fn(*args)


def stack_apply(cfg: ModelConfig, blocks: Sequence[Block], x: torch.Tensor, *,
                inv_freq, capture: bool = False, train: bool = False):
    """The stack's full-sequence forward, a loop over its blocks. Returns
    (y, total aux loss, captures): captures ``(expert_inputs [L, B, S, d],
    usage_counts [L, N])`` when ``capture`` on an MoE stack, else None.
    ``train``: the training arithmetic, each block under ``cfg.remat``."""
    h = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caps = []
    for p in blocks:
        if train:
            h, a, cap = _remat(cfg, functools.partial(
                block_apply, cfg, p, inv_freq=inv_freq, capture=capture,
                train=True), h)
        else:
            h, a, cap = block_apply(cfg, p, h, inv_freq=inv_freq,
                                    capture=capture)
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


def _verify_layers(cfg: ModelConfig, blocks: Sequence[Block], xs, attn):
    """The layer loop of a verify forward over position blocks ``xs[t]``
    ``[B, 1, d]``: every norm and residual at the decode step's shape, the
    attention ``attn(i, p, hn)`` (T blocks in, T out) and the FFN over all
    T * B rows (:func:`_ffn_rows`)."""
    eps = cfg.norm_eps
    for i, p in enumerate(blocks):
        hn = [L.rmsnorm(p.ln1, h, eps) for h in xs]
        xs = [h + a for h, a in zip(xs, attn(i, p.attn, hn))]
        hn = [L.rmsnorm(p.ln2, h, eps) for h in xs]
        xs = [h + y for h, y in zip(xs, _ffn_rows(cfg, p, hn))]
    return xs


def _ffn_rows(cfg: ModelConfig, p: Block, hn):
    """The FFN of T position blocks: an MoE layer routes each block as the
    decode step does and runs all T * B rows through one grouped kernel
    launch (``moe.moe_apply_rows``); a dense MLP runs block by block."""
    if cfg.moe is not None:
        return M.moe_apply_rows(cfg, p.moe, hn)
    return [L.mlp_apply(p.mlp, h) for h in hn]


def stack_verify_slots(cfg: ModelConfig, blocks: Sequence[Block], xs,
                       cache_k: torch.Tensor, cache_v: torch.Tensor,
                       pos: torch.Tensor, *, inv_freq,
                       view: Optional[L.DecodeView] = None):
    """T-token forward with per-slot positions (speculative verify) over
    the dense slot cache, the multi-position sibling of
    :func:`stack_decode_slots`. ``xs``: T position blocks ``[B, 1, d]``
    (``layers.attn_verify_slots``); cache_k/v ``[L, B, rows, nkv, hd]``
    updated IN PLACE; ``view``: the step's ``layers.decode_view``. Every
    row is the decode step's row of its position, bitwise. Returns T blocks
    ``[B, 1, d]``."""
    if view is None:
        view = L.decode_view(pos, cache_k.shape[2])
    return _verify_layers(cfg, blocks, xs, lambda i, p, hn: L.attn_verify_slots(
        cfg, p, hn, cache_k[i], cache_v[i], pos, inv_freq=inv_freq,
        view=view))


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


def stack_verify_slots_paged(cfg: ModelConfig, blocks: Sequence[Block], xs,
                             kp, vp, ks, vs, tab, pos, *, inv_freq):
    """:func:`stack_verify_slots` over paged KV pools (the pools and the
    table as :func:`stack_decode_paged`; ``layers.attn_verify_slots_paged``).
    Returns T blocks ``[B, 1, d]``."""
    return _verify_layers(cfg, blocks, xs, lambda i, p, hn:
                          L.attn_verify_slots_paged(
                              cfg, p, hn, kp[i], vp[i], _sl(ks, i), _sl(vs, i),
                              tab, pos, inv_freq=inv_freq))


def stack_decode(cfg: ModelConfig, blocks: Sequence[Block], x: torch.Tensor,
                 cache_k: torch.Tensor, cache_v: torch.Tensor,
                 pos: torch.Tensor, *, inv_freq,
                 view: Optional[L.DecodeView] = None):
    """One-token decode at ONE position for the whole batch (the non-slot
    cache; ``pos`` a 0-d tensor): :func:`stack_decode_slots` with ``pos``
    expanded to ``[B]``, so every layer runs ``layers.attn_decode``'s paged
    kernel over the contiguous table. cache_k/v ``[L, B, rows, nkv, hd]``
    updated IN PLACE. Returns (y, cache_k, cache_v)."""
    return stack_decode_slots(cfg, blocks, x, cache_k, cache_v,
                              pos.expand(x.shape[0]), inv_freq=inv_freq,
                              view=view)


# ---------------------------------------------------------------------------
# hybrid stack (zamba2): Mamba2 blocks + ONE shared attention / MLP block
# read after every ``hybrid_attn_every`` of them
# ---------------------------------------------------------------------------

class HybridStack(nn.Module):
    """``mamba_ln`` / ``mamba``: one norm and one Mamba2 block per layer;
    ``shared_ln1 shared_attn shared_ln2 shared_mlp``: the one transformer
    block every segment reads (its weights shared, its KV cache one entry
    per segment)."""

    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator):
        super().__init__()
        dt = cfg.param_dtype
        self.mamba_ln = nn.ModuleList(L.RMSNorm(cfg.d_model, dt, device)
                                      for _ in range(cfg.n_layers))
        self.mamba = nn.ModuleList(S.Mamba(cfg, device, generator)
                                   for _ in range(cfg.n_layers))
        self.shared_ln1 = L.RMSNorm(cfg.d_model, dt, device)
        self.shared_attn = L.Attention(cfg, device, generator)
        self.shared_ln2 = L.RMSNorm(cfg.d_model, dt, device)
        self.shared_mlp = L.MLP(cfg.d_model, cfg.d_ff, dt, device, generator)


def n_segments(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid_attn_every


def _segment_layers(cfg: ModelConfig, s_i: int) -> range:
    every = cfg.hybrid_attn_every
    return range(s_i * every, (s_i + 1) * every)


def _shared_mlp(cfg: ModelConfig, p: HybridStack, x: torch.Tensor,
                train: bool = False):
    return x + L.mlp_apply(p.shared_mlp,
                           L.rmsnorm(p.shared_ln2, x, cfg.norm_eps),
                           train=train)


def mamba_layer(cfg: ModelConfig, ln, mp, x: torch.Tensor) -> torch.Tensor:
    """One Mamba2 layer over a full sequence: norm, block, residual."""
    return x + S.mamba_apply(cfg, mp, L.rmsnorm(ln, x, cfg.norm_eps))


def hybrid_apply(cfg: ModelConfig, p: HybridStack, x: torch.Tensor, *,
                 inv_freq, train: bool = False) -> torch.Tensor:
    """Full-sequence forward of the hybrid stack. ``train``: the training
    arithmetic, each Mamba2 layer under ``cfg.remat``; the shared block is
    not rematerialised (the reference wraps only its Mamba2 scan body)."""
    eps = cfg.norm_eps
    for s_i in range(n_segments(cfg)):
        for li in _segment_layers(cfg, s_i):
            layer = functools.partial(mamba_layer, cfg, p.mamba_ln[li],
                                      p.mamba[li])
            x = _remat(cfg, layer, x) if train else layer(x)
        h = x + L.attn_apply(cfg, p.shared_attn,
                             L.rmsnorm(p.shared_ln1, x, eps),
                             inv_freq=inv_freq, train=train)
        x = _shared_mlp(cfg, p, h, train=train)
    return x


def hybrid_prefill(cfg: ModelConfig, p: HybridStack, x: torch.Tensor, *,
                   inv_freq):
    """Full-sequence forward that also emits the decode cache's contents.
    Returns (y, per-layer :class:`mamba.SSMState` list, k ``[nseg, B, S,
    nkv, hd]``, v): one KV entry per segment of the shared block."""
    eps = cfg.norm_eps
    states, ks, vs = [], [], []
    for s_i in range(n_segments(cfg)):
        for li in _segment_layers(cfg, s_i):
            out, st = S.mamba_apply(cfg, p.mamba[li],
                                    L.rmsnorm(p.mamba_ln[li], x, eps),
                                    return_state=True)
            x = x + out
            states.append(st)
        a, k, v = L.attn_prefill(cfg, p.shared_attn,
                                 L.rmsnorm(p.shared_ln1, x, eps),
                                 inv_freq=inv_freq)
        x = _shared_mlp(cfg, p, x + a)
        ks.append(k)
        vs.append(v)
    return x, states, torch.stack(ks), torch.stack(vs)


def ssm_layers_decode(cfg: ModelConfig, lns, mambas, x: torch.Tensor,
                      state: S.SSMState, layers) -> torch.Tensor:
    """One token through the Mamba2 layers ``layers`` (indices into
    ``lns`` / ``mambas`` and the stacked ``state``), each layer's residual
    in turn; ``state``'s ``[L, ...]`` tensors are updated IN PLACE."""
    for li in layers:
        out, st = S.mamba_decode(cfg, mambas[li],
                                 L.rmsnorm(lns[li], x, cfg.norm_eps),
                                 S.SSMState(state.ssm[li], state.conv[li]))
        state.ssm[li].copy_(st.ssm)
        state.conv[li].copy_(st.conv)
        x = x + out
    return x


def hybrid_decode(cfg: ModelConfig, p: HybridStack, x: torch.Tensor,
                  cache: dict, pos: torch.Tensor, *, inv_freq,
                  view: Optional[L.DecodeView] = None) -> torch.Tensor:
    """One token through the hybrid stack (0-d ``pos``). cache: ``"ssm"``,
    a :class:`mamba.SSMState` of ``[L, ...]`` tensors, and ``"k"`` / ``"v"``
    ``[nseg, B, rows, nkv, hd]``, all updated IN PLACE; ``view``: the step's
    ``layers.decode_view``. Returns y."""
    eps = cfg.norm_eps
    for s_i in range(n_segments(cfg)):
        x = ssm_layers_decode(cfg, p.mamba_ln, p.mamba, x, cache["ssm"],
                              _segment_layers(cfg, s_i))
        a, _, _ = L.attn_decode(cfg, p.shared_attn,
                                L.rmsnorm(p.shared_ln1, x, eps),
                                cache["k"][s_i], cache["v"][s_i], pos,
                                inv_freq=inv_freq, view=view)
        x = _shared_mlp(cfg, p, x + a)
    return x


# ---------------------------------------------------------------------------
# encoder-decoder (whisper-style)
# ---------------------------------------------------------------------------

class EncBlock(nn.Module):
    """ln1 -> self-attention (no RoPE, no mask) -> ln2 -> MLP."""

    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator):
        super().__init__()
        dt = cfg.param_dtype
        self.ln1 = L.RMSNorm(cfg.d_model, dt, device)
        self.attn = L.Attention(cfg, device, generator)
        self.ln2 = L.RMSNorm(cfg.d_model, dt, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dt, device, generator)


class DecBlock(nn.Module):
    """ln1 -> causal self-attention -> ln_x -> cross-attention over the
    encoder's output -> ln2 -> MLP."""

    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator):
        super().__init__()
        dt = cfg.param_dtype
        self.ln1 = L.RMSNorm(cfg.d_model, dt, device)
        self.self_attn = L.Attention(cfg, device, generator)
        self.ln_x = L.RMSNorm(cfg.d_model, dt, device)
        self.cross_attn = L.Attention(cfg, device, generator)
        self.ln2 = L.RMSNorm(cfg.d_model, dt, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dt, device, generator)


class EncDec(nn.Module):
    """``enc``: ``n_layers`` encoder blocks, ``enc_ln`` the encoder's final
    norm; ``dec``: ``n_layers`` decoder blocks."""

    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator):
        super().__init__()
        self.enc = nn.ModuleList(EncBlock(cfg, device, generator)
                                 for _ in range(cfg.n_layers))
        self.enc_ln = L.RMSNorm(cfg.d_model, cfg.param_dtype, device)
        self.dec = nn.ModuleList(DecBlock(cfg, device, generator)
                                 for _ in range(cfg.n_layers))


def _sinusoid(S_len: int, d: int, device) -> torch.Tensor:
    """``[S, d]`` fp32: sines of ``pos / 10000^(2i/d)`` then their
    cosines."""
    pos = torch.arange(S_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    base = torch.full((), 10000.0, dtype=torch.float32, device=device)
    ang = pos / torch.pow(base, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block(cfg: ModelConfig, b: EncBlock, x: torch.Tensor,
               train: bool = False) -> torch.Tensor:
    eps = cfg.norm_eps
    x = x + L.attn_apply(cfg, b.attn, L.rmsnorm(b.ln1, x, eps),
                         inv_freq=None, causal=False, train=train)
    return x + L.mlp_apply(b.mlp, L.rmsnorm(b.ln2, x, eps), train=train)


def encode(cfg: ModelConfig, p: EncDec, frames: torch.Tensor,
           train: bool = False) -> torch.Tensor:
    """frames ``[B, n_audio_ctx, d]`` (precomputed frame embeddings, the
    conv front end's stand-in) -> the encoder's output, in frames' type.
    ``train``: the training arithmetic, each block under ``cfg.remat``."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)
    for b in p.enc:
        if train:
            x = _remat(cfg, functools.partial(_enc_block, cfg, b,
                                              train=True), x)
        else:
            x = _enc_block(cfg, b, x)
    return L.rmsnorm(p.enc_ln, x, cfg.norm_eps)


def _cross_mlp(cfg: ModelConfig, b: DecBlock, h: torch.Tensor,
               enc_out: torch.Tensor, train: bool = False) -> torch.Tensor:
    """The decoder block after its self-attention: the cross-attention
    (encoder K and V projected anew at every call, as the reference does)
    and the MLP, each with its residual."""
    eps = cfg.norm_eps
    h = h + L.attn_apply(cfg, b.cross_attn, L.rmsnorm(b.ln_x, h, eps),
                         inv_freq=None, kv=enc_out, train=train)
    return h + L.mlp_apply(b.mlp, L.rmsnorm(b.ln2, h, eps), train=train)


def _dec_block(cfg: ModelConfig, b: DecBlock, x: torch.Tensor,
               enc_out: torch.Tensor, *, inv_freq,
               train: bool = False) -> torch.Tensor:
    h = x + L.attn_apply(cfg, b.self_attn, L.rmsnorm(b.ln1, x, cfg.norm_eps),
                         inv_freq=inv_freq, causal=True, train=train)
    return _cross_mlp(cfg, b, h, enc_out, train=train)


def decode_stack_apply(cfg: ModelConfig, p: EncDec, x: torch.Tensor,
                       enc_out: torch.Tensor, *, inv_freq,
                       train: bool = False) -> torch.Tensor:
    """The decoder's full-sequence forward over the encoder's output.
    ``train``: the training arithmetic, each block under ``cfg.remat``."""
    for b in p.dec:
        if train:
            x = _remat(cfg, functools.partial(_dec_block, cfg, b,
                                              inv_freq=inv_freq, train=True),
                       x, enc_out)
        else:
            x = _dec_block(cfg, b, x, enc_out, inv_freq=inv_freq)
    return x


def decode_stack_prefill(cfg: ModelConfig, p: EncDec, x: torch.Tensor,
                         enc_out: torch.Tensor, *, inv_freq):
    """:func:`decode_stack_apply` that also emits the self-attention's K/V.
    Returns (y, k ``[L, B, S, nkv, hd]``, v)."""
    ks, vs = [], []
    for b in p.dec:
        a, k, v = L.attn_prefill(cfg, b.self_attn,
                                 L.rmsnorm(b.ln1, x, cfg.norm_eps),
                                 inv_freq=inv_freq)
        x = _cross_mlp(cfg, b, x + a, enc_out)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def decode_stack_step(cfg: ModelConfig, p: EncDec, x: torch.Tensor,
                      enc_out: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, pos: torch.Tensor, *, inv_freq,
                      view: Optional[L.DecodeView] = None) -> torch.Tensor:
    """One token through the decoder (0-d ``pos``): the self-attention over
    ``cache_k`` / ``cache_v`` ``[L, B, rows, nkv, hd]`` (updated IN PLACE)
    through ``layers.attn_decode``, the cross-attention over ``enc_out``.
    Returns y."""
    for i, b in enumerate(p.dec):
        a, _, _ = L.attn_decode(cfg, b.self_attn,
                                L.rmsnorm(b.ln1, x, cfg.norm_eps),
                                cache_k[i], cache_v[i], pos,
                                inv_freq=inv_freq, view=view)
        x = _cross_mlp(cfg, b, x + a, enc_out)
    return x

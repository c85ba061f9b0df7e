"""Optimizers on trees of torch tensors: the port's copy of the reference's
``repro/optim/optimizers.py``.

* ``adamw``     — default below ~100B params. States m, v mirror params.
* ``adafactor`` — factored second moment for the >=100B configs: states are
  O(sum of dims), not O(params).
* ``sgd``; global-norm clipping and a cosine schedule; ``make_optimizer``.

A tree is nested dicts / lists / tuples of tensors, in the reference's
layout: a layer stack's leaves stacked along a leading ``[L, ...]`` axis,
each parameter leaf mapped to a dict of fp32 state leaves (``{"m", "v"}``,
``{"v"}`` or ``{"vr", "vc"}``; ``{"na"}`` for an integer leaf, ``{"_"}`` for
sgd). So a state saved by either package is the other's. A gradient tree
has the parameters' structure; an integer leaf's entry is anything (None,
the reference's float0) and is never read.

The arithmetic is the reference's, operation for operation (fp32 states;
bias correction from ``step + 1``; weight decay inside the update; clipped
gradients ``g.float() * scale``, as the reference's bf16 gradient times its
fp32 scale promotes). Two differences of form, none of value:

* ``update`` writes the new state INTO the state tensors handed in and
  returns that tree (the reference's jitted step donates its state);
* each optimizer is built from a whole-tree part and a per-leaf part
  (``Optimizer.begin`` / ``leaf`` / ``leaf_state``), which ``update`` runs
  over the tree and the train step (``launch/steps.py``) runs one leaf at a
  time, so that a step never holds a second copy of every parameter.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

F32 = torch.float32


def _diffable(p) -> bool:
    return isinstance(p, torch.Tensor) and p.is_floating_point()


def tree_map(fn: Callable, params, *rest):
    """``fn(p, *r)`` at every leaf of ``params`` (nested dicts / lists /
    tuples), in JAX's order (dict keys sorted), ``rest`` walked in parallel
    by key: each holds the parameters' structure down to their leaves and
    anything below them (a state dict)."""
    if isinstance(params, dict):
        return {k: tree_map(fn, params[k], *[r[k] for r in rest])
                for k in sorted(params)}
    if isinstance(params, (list, tuple)):
        out = [tree_map(fn, p, *[r[i] for r in rest])
               for i, p in enumerate(params)]
        return type(params)(out)
    return fn(params, *rest)


def tree_leaves(params) -> list:
    """The leaves of ``params`` in JAX's order (dict keys sorted)."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in tree_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [x for p in params for x in tree_leaves(p)]
    return [params]


def _scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32).to(device)


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params, step) ->
    (updates, state)``, the reference's signature, the state written in
    place. The parts ``update`` is made of: ``begin(grads, state, step) ->
    (grads', ctx)`` (the whole-tree part: clipping's norm, the learning
    rate, error feedback); ``leaf(g, s, p, ctx) -> (u, s)`` (one parameter
    leaf, ``s`` its state dict, updated in place); ``leaf_state(state)``
    (the tree of per-leaf state dicts ``leaf`` walks)."""
    init: Callable[[Any], Any]
    update: Callable[..., tuple]
    state_factored: bool = False
    begin: Optional[Callable] = None
    leaf: Optional[Callable] = None
    leaf_state: Optional[Callable] = None


def _assemble(init, begin, leaf, leaf_state=lambda s: s,
              state_factored=False) -> Optimizer:
    def update(grads, state, params, step):
        grads, ctx = begin(grads, state, step)
        per_leaf = leaf_state(state)
        updates = tree_map(lambda p, g, s: leaf(g, s, p, ctx)[0], params,
                           grads, per_leaf)
        return updates, state
    return Optimizer(init, update, state_factored, begin, leaf, leaf_state)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every floating leaf, in fp32."""
    leaves = [torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree)
              if _diffable(x)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(grads, max_norm: float) -> Optional[torch.Tensor]:
    """The reference's ``_clip`` factor ``min(1, max_norm / (|g| + 1e-9))``,
    or None when clipping is off."""
    if not max_norm:
        return None
    g = global_norm(grads)
    return torch.clamp(max_norm / (g + 1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """One clipped gradient leaf in fp32 (the reference's ``x * scale``)."""
    if scale is None:
        return g.to(F32)
    return g.to(F32) * scale


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step).to(F32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def apply_updates(params, updates):
    """``(p.float() + u).to(p.dtype)`` at every floating leaf; integer
    leaves (MoE ``remap`` / ``live``) and missing updates pass through."""
    def one(p, u):
        if u is None or not _diffable(p):
            return p
        return (p.to(F32) + u).to(p.dtype)
    return tree_map(one, params, updates)


def _state_device(params):
    for x in tree_leaves(params):
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _step_scalars(step, lr_fn, device):
    """(t = step + 1, lr_t) as fp32 0-d tensors on ``device``."""
    step = torch.as_tensor(step)
    t = step.to(F32) + 1.0
    return t.to(device), _scalar(lr_fn(step), device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr=1e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          max_grad_norm=1.0, schedule=None) -> Optimizer:
    lr_fn = schedule or (lambda step: lr)

    def init(params):
        def one(p):
            if not _diffable(p):
                return {"na": torch.zeros((), dtype=F32, device=p.device)}
            return {"m": torch.zeros(p.shape, dtype=F32, device=p.device),
                    "v": torch.zeros(p.shape, dtype=F32, device=p.device)}
        return tree_map(one, params)

    def begin(grads, state, step):
        dev = _state_device(grads)
        t, lr_t = _step_scalars(step, lr_fn, dev)
        return grads, dict(scale=_clip_scale(grads, max_grad_norm), lr=lr_t,
                           bc1=1.0 - b1 ** t, bc2=1.0 - b2 ** t)

    def leaf(g, s, p, ctx):
        if g is None or not _diffable(p):
            return torch.zeros((), dtype=F32, device=p.device), s
        g = _clipped(g, ctx["scale"])
        m = s["m"].mul_(b1).add_((1 - b1) * g)
        v = s["v"].mul_(b2).add_((1 - b2) * g * g)
        del g
        u = (m / ctx["bc1"]).div_(torch.sqrt(v / ctx["bc2"]).add_(eps))
        u.add_(weight_decay * p.to(F32))
        return u.mul_(-ctx["lr"]), s

    return _assemble(init, begin, leaf)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------

def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0,
              max_grad_norm=1.0, schedule=None) -> Optimizer:
    lr_fn = schedule or (lambda step: lr)

    def _factored(p) -> bool:
        return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1

    def init(params):
        def one(p):
            dev = p.device
            if not _diffable(p):
                return {"na": torch.zeros((), dtype=F32, device=dev)}
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32, device=dev),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=F32, device=dev)}
            return {"v": torch.zeros(p.shape, dtype=F32, device=dev)}
        return tree_map(one, params)

    def begin(grads, state, step):
        dev = _state_device(grads)
        t, lr_t = _step_scalars(step, lr_fn, dev)
        return grads, dict(scale=_clip_scale(grads, max_grad_norm), lr=lr_t,
                           beta=1.0 - t ** (-decay))

    def leaf(g, s, p, ctx):
        if g is None or not _diffable(p):
            return torch.zeros((), dtype=F32, device=p.device), s
        beta = ctx["beta"]
        g = _clipped(g, ctx["scale"])
        g2 = g * g + eps
        if "vr" in s:
            vr = s["vr"].copy_(beta * s["vr"]
                               + (1 - beta) * torch.mean(g2, dim=-1))
            vc = s["vc"].copy_(beta * s["vc"]
                               + (1 - beta) * torch.mean(g2, dim=-2))
            denom = (vr[..., None] / torch.mean(vr, dim=-1, keepdim=True)[
                ..., None]) * vc[..., None, :]
            u = g * torch.rsqrt(denom + eps)
        else:
            v = s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
            u = g * torch.rsqrt(v + eps)
        # update clipping (Adafactor's RMS-based trust ratio)
        rms = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        return -ctx["lr"] * u, s

    return _assemble(init, begin, leaf, state_factored=True)


def sgd(lr=1e-2, max_grad_norm=0.0) -> Optimizer:
    def init(params):
        return tree_map(lambda p: {"_": torch.zeros(
            (), dtype=F32, device=p.device)}, params)

    def begin(grads, state, step):
        return grads, dict(scale=_clip_scale(grads, max_grad_norm))

    def leaf(g, s, p, ctx):
        if g is None or not _diffable(p):
            # the reference's -lr * (its float0 gradient) is zeros of p's shape
            return torch.zeros(p.shape, dtype=F32, device=p.device), s
        return -lr * _clipped(g, ctx["scale"]), s

    return _assemble(init, begin, leaf)


def make_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}[name](**kw)


def default_optimizer_for(param_count: int) -> str:
    """>=100B params -> factored states."""
    return "adafactor" if param_count >= 100e9 else "adamw"

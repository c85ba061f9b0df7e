"""Bridge from the reference's parameter pytree to the port's modules.

``from_reference_params(tree, cfg, device, dtype)`` takes the reference's
parameters as NESTED DICTS OF NUMPY ARRAYS (fp32 copies of the leaves are
exact for bf16 sources: bf16 -> fp32 -> bf16 round-trips) or of torch tensors
and returns a :class:`repro_torch.models.model.Model` holding them.
``reference_tree(model)`` is the way back, the model's tensors in the
reference's tree layout, built from ``unstacked_tree(model)`` and
``stack_tree(blocks)`` (the compression pipeline assembles a merged model
as such a tree; checkpoints store it). The reference stacks a
layer stack's leaves along a leading ``[L, ...]`` axis; the port keeps one
module per layer, so every stacked leaf is sliced along axis 0. Leaf names
inside a layer are the reference's (``attn.wq wk wv wo``, ``moe.router wg wu
wd remap live``, ``ln1 ln2 final_ln .scale``, ``embed.tok embed.head``), in
every family: ``ssm_ln`` / ``ssm`` (``in_proj conv_w conv_b dt_bias A_log D
norm_scale out_proj``), ``hybrid.{mamba_ln, mamba, shared_ln1, shared_attn,
shared_ln2, shared_mlp}``, ``encdec.{enc, enc_ln, dec}``; each leaf keeps
its own dtype (a Mamba2 block's ``dt_bias``, ``A_log`` and ``D`` are fp32
in a bf16 model).
Every shape is checked and a missing or an extra leaf raises.

Training state crosses both ways too: :func:`tree_to_torch` /
:func:`tree_to_numpy` carry any tree of the reference's layout (an
optimizer state: ``{"m", "v"}`` / ``{"na"}`` / adafactor's ``{"vr", "vc"}``
leaves over stacked ``[L, ...]`` shapes, as ``repro_torch.optim`` builds it)
between numpy arrays and torch tensors, leaf for leaf, dtypes kept.

Int8 expert tables cross as the reference stores them: a stack whose tree
holds ``moe.qexp.{wg,wu,wd,wg_scale,wu_scale,wd_scale}`` (from
``repro.core.quant.quantize_model_experts`` or an int8 compression plan)
becomes a stack of quantized layers (:mod:`repro_torch.core.quant`), int8
staying int8 and the scales fp32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from repro_torch.ckpt import treedef as TD
from repro_torch.core import quant as Q
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, leaf_groups, nest, split_name


def tree_to_torch(tree, device="cpu"):
    """A tree of numpy arrays (or anything ``np.asarray`` takes: the
    reference's ``jax.Array`` leaves) as torch tensors on ``device``, each
    leaf's dtype kept (bf16 leaves must arrive widened to fp32: numpy has no
    bf16)."""
    return TD.tree_map(lambda a: torch.from_numpy(np.array(a)).to(device),
                       tree)


def tree_to_numpy(tree):
    """A tree of torch tensors as numpy arrays on the host (bf16 leaves
    widened to fp32, exactly)."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return TD.tree_map(one, tree)


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flatten(val, name))
        else:
            out[name] = val if isinstance(val, torch.Tensor) else np.asarray(val)
    return out


def stack_tree(blocks, skip=()) -> dict:
    """A sequence of blocks as one reference-layout stack: nested dicts under
    the reference's leaf names, each leaf the blocks' tensors stacked along a
    leading ``[L, ...]`` axis (a copy, on their device). ``skip``: leaf
    names (``"moe.wg"``) left out."""
    per_layer: Dict[str, list] = {}
    for block in blocks:
        named = dict(block.named_parameters())
        named.update(dict(block.named_buffers()))
        for name, t in named.items():
            if name not in skip:
                per_layer.setdefault(name, []).append(t)
    return nest({name: torch.stack(ts) for name, ts in per_layer.items()})


def unstacked_tree(model: Model) -> dict:
    """The model's leaves outside its layer stacks (embedding, final norm,
    the hybrid family's shared block, the encoder's final norm) under the
    reference's names, the model's own tensors. With :func:`stack_tree` for
    each stack it makes the tree :func:`from_reference_params` takes."""
    return nest({name: t for name, t in _targets(model).items()
                 if split_name(name)[1] is None})


def reference_tree(model: Model) -> dict:
    """The whole model as the reference's parameter tree: the inverse of
    :func:`from_reference_params` (each stack's leaves stacked, a copy on
    the model's device; the leaves outside the stacks the model's own)."""
    return nest({name: torch.stack(ts) if stacked else ts[0]
                 for name, (ts, stacked) in leaf_groups(model).items()})


def _targets(model: Model) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``model`` by its module path."""
    out = {name: p for name, p in model.named_parameters()}
    out.update({name: b for name, b in model.named_buffers()})
    return out


def from_reference_params(tree: dict, cfg: ModelConfig, device,
                          dtype: Optional[torch.dtype] = None) -> Model:
    """Build the port's model from the reference's parameter tree.

    ``dtype``: storage type of the floating leaves (default ``cfg.dtype``);
    the router stays fp32 and ``remap`` / ``live`` stay int32, as in the
    reference."""
    device = torch.device(device)
    if dtype is not None and dtype != cfg.param_dtype:
        names = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                 torch.float16: "float16"}
        cfg = cfg.replace(dtype=names[dtype])
    # the skeleton's random weights are all overwritten below; build it on
    # the meta device so nothing is drawn or allocated twice
    gen = torch.Generator(device="cpu")
    with torch.device("meta"):
        model = Model(cfg, "meta", gen)
    flat = _flatten(tree)
    for stack in ("stack", "stack_c"):
        if hasattr(model, stack) and any(
                name.startswith(f"{stack}.moe.qexp.") for name in flat):
            for block in getattr(model, stack):
                Q.quantize_moe(block.moe)
    targets = _targets(model)

    # reference name -> list of (port name) per layer slice, or one name
    expected: Dict[str, list] = {}
    for name in targets:
        ref_name, layer = split_name(name)
        if layer is None:
            expected[name] = [(None, name)]
        else:
            expected.setdefault(ref_name, []).append((layer, name))
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise ValueError(
            f"reference tree does not fit config {cfg.name}: "
            f"missing leaves {missing}, unexpected leaves {extra}")

    loaded: Dict[str, torch.Tensor] = {}
    for ref_name, slots in expected.items():
        src = flat[ref_name]
        for layer, name in slots:
            tgt = targets[name]
            if layer is None:
                arr = src
            else:
                if src.ndim < 1 or src.shape[0] != len(slots):
                    raise ValueError(
                        f"{ref_name}: leading (layer) axis is "
                        f"{src.shape[:1]}, the config has {len(slots)} layers "
                        f"in this stack")
                arr = src[layer]
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(
                    f"{ref_name}{'' if layer is None else f'[{layer}]'}: shape "
                    f"{tuple(arr.shape)} != expected {tuple(tgt.shape)}")
            if not isinstance(arr, torch.Tensor):
                arr = torch.from_numpy(np.array(arr))
            loaded[name] = arr.to(device=device, dtype=tgt.dtype)

    for name, value in loaded.items():
        mod_path, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_path) if mod_path else model
        if leaf in mod._parameters:
            mod._parameters[leaf] = nn.Parameter(value, requires_grad=False)
        else:
            mod._buffers[leaf] = value
    return model

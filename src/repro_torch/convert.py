"""Bridge from the reference's parameter pytree to the port's modules.

``from_reference_params(tree, cfg, device, dtype)`` takes the reference's
parameters as NESTED DICTS OF NUMPY ARRAYS (fp32 copies of the leaves are
exact for bf16 sources: bf16 -> fp32 -> bf16 round-trips) or of torch tensors
and returns a :class:`repro_torch.models.model.Model` holding them.
``unstacked_tree(model)`` and ``stack_tree(blocks)`` are the way back: the
model's tensors in the reference's tree layout (the compression pipeline
assembles a merged model as such a tree). The reference stacks a
layer stack's leaves along a leading ``[L, ...]`` axis; the port keeps one
module per layer, so every stacked leaf is sliced along axis 0. Leaf names
inside a layer are the reference's (``attn.wq wk wv wo``, ``moe.router wg wu
wd remap live``, ``ln1 ln2 final_ln .scale``, ``embed.tok embed.head``).
Every shape is checked and a missing or an extra leaf raises.

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

from repro_torch.core import quant as Q
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flatten(val, name))
        else:
            out[name] = val if isinstance(val, torch.Tensor) else np.asarray(val)
    return out


def _nest(flat: Dict[str, Any]) -> dict:
    tree: dict = {}
    for name, val in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


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
    return _nest({name: torch.stack(ts) for name, ts in per_layer.items()})


def unstacked_tree(model: Model) -> dict:
    """The model's leaves outside its layer stacks (embedding, final norm)
    under the reference's names, the model's own tensors. With
    :func:`stack_tree` for each stack it makes the tree
    :func:`from_reference_params` takes."""
    return _nest({name: t for name, t in _targets(model).items()
                  if name.split(".")[0] not in ("stack", "stack_c")})


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
        parts = name.split(".")
        if parts[0] in ("stack", "stack_c"):
            ref_name = ".".join([parts[0]] + parts[2:])
            expected.setdefault(ref_name, []).append((int(parts[1]), name))
        else:
            expected[name] = [(None, name)]
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

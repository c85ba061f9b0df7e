"""Bridge from the reference's parameter pytree to the port's modules.

``from_reference_params(tree, cfg, device, dtype)`` takes the reference's
parameters as NESTED DICTS OF NUMPY ARRAYS (fp32 copies of the leaves are
exact for bf16 sources: bf16 -> fp32 -> bf16 round-trips) and returns a
:class:`repro_torch.models.model.Model` holding them. The reference stacks a
layer stack's leaves along a leading ``[L, ...]`` axis; the port keeps one
module per layer, so every stacked leaf is sliced along axis 0. Leaf names
inside a layer are the reference's (``attn.wq wk wv wo``, ``moe.router wg wu
wd remap live``, ``ln1 ln2 final_ln .scale``, ``embed.tok embed.head``).
Every shape is checked and a missing or an extra leaf raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flatten(val, name))
        else:
            out[name] = np.asarray(val)
    return out


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
            loaded[name] = torch.from_numpy(np.array(arr)).to(
                device=device, dtype=tgt.dtype)

    for name, value in loaded.items():
        mod_path, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_path) if mod_path else model
        if leaf in mod._parameters:
            mod._parameters[leaf] = nn.Parameter(value, requires_grad=False)
        else:
            mod._buffers[leaf] = value
    return model

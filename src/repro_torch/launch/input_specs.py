"""Stand-ins for every model input, the counterpart of the reference's
``ShapeDtypeStruct`` specs: tensors on ``torch.device("meta")``, which carry
a shape and a dtype and allocate nothing, so a full-size cell (kimi-k2's
trillion parameters, a 32k-token decode cache) is described on any host.

  train_batch_specs(cfg, global_batch, seq_len) -> {"tokens", "patches" | "frames"}
  decode_specs(cfg, global_batch, s_max)        -> (cache, token)
  params_specs(cfg)                             -> the reference's parameter tree
  input_specs(arch, shape_name)                 -> one (arch, shape) cell
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import configs
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, global_batch: int,
                      seq_len: int) -> Dict[str, torch.Tensor]:
    specs = {"tokens": _spec((global_batch, seq_len), torch.int32)}
    if cfg.family == "vlm":
        specs["patches"] = _spec(
            (global_batch, cfg.vlm_num_patches, cfg.d_model), cfg.param_dtype)
    if cfg.family == "audio":
        specs["frames"] = _spec(
            (global_batch, cfg.n_audio_ctx, cfg.d_model), cfg.param_dtype)
    return specs


def decode_specs(cfg: ModelConfig, global_batch: int, s_max: int) -> Tuple:
    """(cache, token) of one serve step: ``model.init_cache`` on the meta
    device (its ``s_max`` / ``kv_block`` host scalars ride along) and the
    ``[B]`` int32 token."""
    cache = MD.init_cache(cfg, global_batch, s_max, META)
    return cache, _spec((global_batch,), torch.int32)


def params_specs(cfg: ModelConfig) -> dict:
    """The reference's parameter tree of ``cfg`` (stacked ``[L, ...]``
    leaves), each leaf a meta tensor of its shape and dtype."""
    with torch.device(META):
        model = MD.Model(cfg, META, torch.Generator(device="cpu"))
    return MD.shape_tree(model)


def input_specs(arch: str, shape_name: str) -> Dict:
    """Per (arch, shape) cell, everything the step function needs, as meta
    tensors. A full-attention arch on a sub-quadratic-only shape
    (``long_500k``) is refused, as the reference refuses it."""
    cfg = configs.get(arch)
    sh = configs.SHAPES[shape_name]
    if not configs.shape_applicable(cfg, shape_name):
        raise ValueError(
            f"{arch} x {shape_name}: skipped (full-attention arch on a "
            "sub-quadratic-only shape)")
    gb, seq = sh["global_batch"], sh["seq_len"]
    if sh["kind"] in ("train", "prefill"):
        return {"kind": sh["kind"], "cfg": cfg,
                "batch": train_batch_specs(cfg, gb, seq)}
    cache, token = decode_specs(cfg, gb, seq)
    return {"kind": "decode", "cfg": cfg, "cache": cache, "token": token}

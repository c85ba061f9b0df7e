"""End-to-end MergeMoE compression pipeline, driven by a CompressionPlan.

``compress_with_plan(cfg, model, plan, batches=...)``:
  1. stream calibration batches through the ORIGINAL model on its device
     (:class:`repro_torch.core.calibration.CalibrationStream`: the port's
     forward with ``capture=True``, folded on the host with bounded memory),
  2. execute the plan layer by layer on the host: each :class:`LayerSpec`
     picks a registered merge strategy and a per-layer budget M_l, solved in
     fp64 NumPy (:mod:`repro_torch.core.merge`, the reference's solves
     unchanged),
  3. return (compressed_cfg, compressed_model, report): the suffix stack's
     expert tables replaced by the merged experts (padded to the plan's max
     M), the ``[N] -> [M]`` remap and the per-layer live-expert counts. The
     merged model is assembled as a reference-layout tree
     (:func:`repro_torch.convert.stack_tree`) and built through
     :func:`repro_torch.convert.from_reference_params`, so it is laid out as
     the reference lays out its compressed parameters.

``compress_model(cfg, model, method=..., merged_experts=..., split=...)``
builds a uniform plan and executes it (the reference's legacy surface).

Fed the same calibration, the merged tables, remaps and live counts equal
the reference's bit for bit (the solves are the same fp64 NumPy code on the
same fp32 inputs). Mesh execution (``mesh=``: sharded capture and solves)
belongs to a later slice and raises ``NotImplementedError``.
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import calibration as CAL
from repro_torch.core import plan as PLAN
from repro_torch.core import quant as Q
from repro_torch.core.errors import CalibrationError, TechniqueInapplicable
from repro_torch.distributed.compression import shard_layer_solves
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model

# Paper Fig. 4: below ~32 calibration samples the least-squares system is
# under-determined and quality collapses to chance.
MIN_SAMPLE_WARN = 32

#: the suffix leaves the merge replaces
_MERGED_LEAVES = ("moe.wg", "moe.wu", "moe.wd", "moe.remap", "moe.live")


def _model_bytes(model: Model) -> int:
    """Bytes of every parameter and buffer (the reference's tree bytes)."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def _pad_rows(a: np.ndarray, M_max: int) -> np.ndarray:
    """Zero-pad the expert (first) axis of a merged table to M_max."""
    if a.shape[0] == M_max:
        return a
    widths = [(0, M_max - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, widths)


def _host32(t: torch.Tensor) -> np.ndarray:
    """A tensor as fp32 NumPy on the host (exact for bf16 and fp32)."""
    return t.detach().to(torch.float32).cpu().numpy()


def _merged_table(results, key: str, M_max: int) -> np.ndarray:
    """The suffix's merged tables ``[L_c, M_max, ...]`` as fp32, the type
    the reference's (64-bit disabled) arrays pass through on the way to the
    model type."""
    return np.stack([_pad_rows(getattr(r, key), M_max)
                     for r in results]).astype(np.float32)


def compress_with_plan(cfg: ModelConfig, model: Model,
                       plan: PLAN.CompressionPlan, *,
                       batches: Optional[Iterable[dict]] = None,
                       stream: Optional[CAL.CalibrationStream] = None,
                       max_tokens: Optional[int] = None,
                       strict_samples: bool = False, seed: int = 0,
                       calib_policy: str = "reservoir", mesh=None,
                       ) -> Tuple[ModelConfig, Model, Dict]:
    """Execute ``plan`` against ``model`` (uncompressed, plain tables).
    Calibration comes from ``stream`` (a pre-fed :class:`CalibrationStream`,
    reusable across planning and merging; anything with ``n_tokens`` and
    ``layer(l)``) or is collected here from ``batches`` (``calib_policy``
    picks what survives a ``max_tokens`` cap). The compressed model lives on
    ``model``'s device and shares its unmerged tensors."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-parallel compression (sharded capture and solves) is not "
            "ported yet: it comes with the mesh slice")
    plan.validate(cfg)
    if cfg.moe_merged:
        raise ValueError("model is already compressed")

    new_cfg = plan.apply_to(cfg)
    split = plan.split
    L, N = cfg.n_layers, cfg.moe.n_experts
    M_max = plan.max_merged

    t0 = time.perf_counter()
    if stream is None:
        stream = CAL.CalibrationStream(cfg, model,
                                       max_tokens_per_layer=max_tokens,
                                       seed=seed, policy=calib_policy)
    if batches is not None:
        stream.consume(batches)
    t_calib = time.perf_counter() - t0

    n_samples = stream.n_tokens
    if n_samples < MIN_SAMPLE_WARN:
        if strict_samples:
            raise CalibrationError(
                f"{n_samples} calibration tokens < critical threshold "
                f"{MIN_SAMPLE_WARN} (paper Fig. 4)")
        warnings.warn(
            f"only {n_samples} calibration tokens (< {MIN_SAMPLE_WARN}, "
            "paper Fig. 4): the least-squares merge may be under-determined",
            stacklevel=2)

    blocks = model.stack
    if any(Q.is_quantized(b.moe) for b in blocks):
        raise ValueError("compress an unquantized model (the plan's "
                         "weight_dtype quantizes the merged tables)")

    # ---- solve stage: one closure per layer, fp64 NumPy on the host (the
    # tables cross to the host one layer at a time)
    calibs = {spec.layer: stream.layer(spec.layer) for spec in plan.specs}

    def solve_one(spec):
        strategy = PLAN.get_strategy(spec.method)
        calib = calibs[spec.layer]
        moe = blocks[spec.layer].moe
        return strategy.merge(
            _host32(moe.wg), _host32(moe.wu), _host32(moe.wd),
            calib.counts if "counts" in strategy.requires else None,
            calib.x if "x" in strategy.requires else None,
            spec.merged_experts,
            router=(_host32(moe.router)
                    if "router" in strategy.requires else None),
        )

    t0 = time.perf_counter()
    merged, _ = shard_layer_solves(
        [lambda spec=spec: solve_one(spec) for spec in plan.specs], 1)
    t_merge = time.perf_counter() - t0

    per_layer: List[Dict] = []
    for spec, res in zip(plan.specs, merged):
        resid = res.info.get("resid")
        per_layer.append({
            "layer": spec.layer, "method": spec.method,
            "merged_experts": spec.merged_experts,
            "resid": (None if resid is None
                      else [float(r) for r in np.asarray(resid)]),
        })

    # ---- assemble the compressed model: a reference-layout tree whose
    # suffix holds the merged tables (padded to max M), built by the bridge
    tree = convert.unstacked_tree(model)
    if split > 0:
        tree["stack"] = convert.stack_tree(blocks[:split])
    suffix = convert.stack_tree(blocks[split:], skip=_MERGED_LEAVES)
    suffix["moe"].update(wg=_merged_table(merged, "wg", M_max),
                         wu=_merged_table(merged, "wu", M_max),
                         wd=_merged_table(merged, "wd", M_max),
                         remap=np.stack([r.remap for r in merged]).astype(
                             np.int32),
                         live=np.asarray(plan.merged_per_layer, np.int32))
    tree["stack_c"] = suffix
    new_model = convert.from_reference_params(tree, new_cfg, model.device)
    del tree, suffix
    if plan.weight_dtype == "int8":
        # calibration-aware int8: scales from the solved tables (per expert,
        # per output channel); zero pad rows quantize to zero scale
        for block in new_model.stack_c:
            Q.quantize_moe(block.moe)

    orig = _model_bytes(model)
    padded = _model_bytes(new_model)
    # live bytes: what a ragged artifact stores, pad rows excluded (the
    # budget planner's per-expert byte model at the plan's storage type)
    pad_bytes = sum((M_max - m) * PLAN.expert_bytes(cfg, plan.weight_dtype)
                    for m in plan.merged_per_layer)
    comp = padded - pad_bytes
    methods = sorted(set(plan.methods))
    info = {
        "method": methods[0] if len(methods) == 1 else "mixed",
        "plan": plan.to_json_dict(),
        "mesh": None,
        "weight_dtype": plan.weight_dtype,
        "layers_merged": list(plan.layers),
        "merged_per_layer": list(plan.merged_per_layer),
        "per_layer": per_layer,
        "n_experts": N,
        "merged_experts": M_max,
        "calib_tokens": int(n_samples),
        "calib_warning": bool(n_samples < MIN_SAMPLE_WARN),
        "t_calibrate_s": t_calib,
        "t_merge_s": t_merge,
        "bytes_original": int(orig),
        "bytes_compressed": int(comp),
        "bytes_padded": int(padded),
        "compression_ratio": float(orig) / float(comp),
        "resid": [e["resid"] for e in per_layer if e["resid"] is not None],
    }
    return new_cfg, new_model, info


def compress_model(cfg: ModelConfig, model: Model, *,
                   method: str = "mergemoe", merged_experts: int,
                   split: int | None = None, batches: Iterable[dict],
                   max_tokens: int | None = None,
                   strict_samples: bool = False, seed: int = 0,
                   ) -> Tuple[ModelConfig, Model, Dict]:
    """Single-method surface: builds a uniform plan and executes it, a
    ``max_tokens`` cap keeping the FIRST tokens (``calib_policy="head"``)."""
    if cfg.moe is None:
        raise TechniqueInapplicable(
            f"{cfg.name} ({cfg.family}) has no routed experts (DESIGN.md §4).")
    plan = PLAN.uniform(cfg, method=method, merged_experts=merged_experts,
                        split=split)
    return compress_with_plan(cfg, model, plan, batches=batches,
                              max_tokens=max_tokens,
                              strict_samples=strict_samples, seed=seed,
                              calib_policy="head")

"""MergeMoE compression entry point: build -> calibrate -> plan -> merge -> eval.

    # uniform plan on the reduced config, on the card
    PYTHONPATH=src python -m repro_torch.launch.compress \\
        --arch qwen3-moe-30b-a3b --method mergemoe --merged-experts 4

    # the same on the CPU (the plain PyTorch path)
    PYTHONPATH=src python -m repro_torch.launch.compress --device cpu

    # a plan from disk, or budget-driven per-layer M from calibration stats
    PYTHONPATH=src python -m repro_torch.launch.compress --plan plan.json
    PYTHONPATH=src python -m repro_torch.launch.compress --target-ratio 1.4

Calibration runs the port's forward with ``capture=True`` on ``--device``;
the merge solves run in fp64 on the host. Prints the reference CLI's report
(``repro/launch/compress.py``): bytes before / after, held-out loss of the
full and the compressed model, merge and eval wall times, the executed
per-layer plan. The model has random weights from ``--seed`` (loading a
trained checkpoint, ``--save-dir`` and ``--mesh`` belong to later slices and
raise ``NotImplementedError``); the token batches come from a NumPy
generator, not the reference's JAX keys.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import calibration as CAL
from repro_torch.core import compress as CMP
from repro_torch.core import plan as PLAN
from repro_torch.models import model as MD


def eval_loss(cfg, model, batches) -> float:
    return float(np.mean([float(MD.loss(cfg, model, b)[0]) for b in batches]))


def make_batches(cfg, n, device, batch=4, seq=64, seed=0):
    """``n`` batches ``{"tokens": [batch, seq]}`` of uniform token ids on
    ``device``, one NumPy generator per batch (``seed + i``)."""
    return [{"tokens": torch.from_numpy(
        np.random.default_rng(seed + i).integers(
            0, cfg.vocab_size, (batch, seq), dtype=np.int64)).to(device)}
        for i in range(n)]


def build_plan(cfg, *, plan_path=None, target_ratio=None, method="mergemoe",
               merged_experts=4, split=None, stream=None,
               weight_dtype="bf16"):
    """Resolve the CLI's three plan sources, most declarative first.
    ``weight_dtype`` applies to the built plan (a plan file keeps its own)."""
    if plan_path:
        return PLAN.CompressionPlan.load(plan_path).validate(cfg)
    if target_ratio:
        stats = stream.stats() if stream is not None else None
        return PLAN.for_target_ratio(cfg, target_ratio=target_ratio,
                                     stats=stats, method=method, split=split,
                                     weight_dtype=weight_dtype)
    return PLAN.uniform(cfg, method=method, merged_experts=merged_experts,
                        split=split, weight_dtype=weight_dtype)


def run(arch: str = "qwen3-moe-30b-a3b", method: str = "mergemoe",
        merged_experts: int = 4, split=None, calib_batches: int = 2,
        eval_batches: int = 4, model=None, cfg=None, seed: int = 0,
        plan=None, plan_path=None, target_ratio=None, max_calib_tokens=None,
        save_dir=None, mesh_spec=None, weight_dtype: str = "bf16",
        device: str = "cuda", batch: int = 4, seq: int = 64, stream=None):
    """Compress ``model`` (default: random weights from ``seed`` on the
    reduced ``arch``) and evaluate both on ``eval_batches`` batches of
    ``[batch, seq]`` tokens. ``stream``: a pre-fed
    :class:`~repro_torch.core.calibration.CalibrationStream` (default: one
    fed here with ``calib_batches`` batches). Returns (compressed cfg,
    compressed model, report)."""
    if save_dir is not None:
        raise NotImplementedError(
            "--save-dir (compressed checkpoints) is not ported yet: it comes "
            "with the checkpoint slice")
    if mesh_spec is not None:
        raise NotImplementedError(
            "--mesh (mesh-parallel compression) is not ported yet: it comes "
            "with the mesh slice")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device and none is "
                           "available; pass --device cpu for the plain "
                           "PyTorch path")
    cfg = cfg if cfg is not None else configs.get(arch).reduced()
    if model is None:
        model = MD.init(cfg, device, seed=seed)
    device = model.device
    evalb = make_batches(cfg, eval_batches, device, batch, seq, seed + 200)

    t0 = time.perf_counter()
    base_loss = eval_loss(cfg, model, evalb)
    t_eval_base = time.perf_counter() - t0

    # calibrate ONCE: the same stream feeds the budget planner's stats and
    # the per-layer merges
    if stream is None:
        calib = make_batches(cfg, calib_batches, device, batch, seq,
                             seed + 100)
        stream = CAL.CalibrationStream(cfg, model,
                                       max_tokens_per_layer=max_calib_tokens,
                                       seed=seed).consume(calib)
    if plan is None:
        plan = build_plan(cfg, plan_path=plan_path, target_ratio=target_ratio,
                          method=method, merged_experts=merged_experts,
                          split=split, stream=stream,
                          weight_dtype=weight_dtype)

    t0 = time.perf_counter()
    new_cfg, new_model, info = CMP.compress_with_plan(cfg, model, plan,
                                                      stream=stream)
    t_total = time.perf_counter() - t0

    t0 = time.perf_counter()
    comp_loss = eval_loss(new_cfg, new_model, evalb)
    t_eval_comp = time.perf_counter() - t0

    report = {
        "arch": arch, "method": info["method"],
        "plan": info["plan"],
        "mesh": info["mesh"],
        "weight_dtype": info["weight_dtype"],
        "n_experts": info["n_experts"],
        "merged_experts": info["merged_experts"],
        "merged_per_layer": info["merged_per_layer"],
        "layers_merged": info["layers_merged"],
        "calib_tokens": info["calib_tokens"],
        "bytes_original": info["bytes_original"],
        "bytes_compressed": info["bytes_compressed"],
        "compression_ratio": round(info["compression_ratio"], 4),
        "t_merge_s": round(info["t_merge_s"], 3),
        "t_total_s": round(t_total, 3),
        "t_eval_base_s": round(t_eval_base, 3),
        "t_eval_compressed_s": round(t_eval_comp, 3),
        "t_eval_s": round(t_eval_base + t_eval_comp, 3),
        "loss_full": round(base_loss, 4),
        "loss_compressed": round(comp_loss, 4),
        "loss_delta": round(comp_loss - base_loss, 4),
    }
    return new_cfg, new_model, report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--plan", default=None, metavar="PLAN_JSON",
                    help="execute a CompressionPlan from disk "
                         "(overrides --method/--merged-experts/--split)")
    ap.add_argument("--target-ratio", type=float, default=None,
                    help="budget-driven planning: allocate per-layer M from "
                         "calibration stats to hit this compression ratio")
    ap.add_argument("--method", default="mergemoe",
                    choices=PLAN.available_methods())
    ap.add_argument("--weight-dtype", default="bf16",
                    choices=PLAN.WEIGHT_DTYPES,
                    help="storage type of the merged expert tables (int8: "
                         "per-expert, per-output-channel); ignored when "
                         "--plan is given (the plan file carries its own)")
    ap.add_argument("--merged-experts", type=int, default=4)
    ap.add_argument("--split", type=int, default=None)
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--max-calib-tokens", type=int, default=None,
                    help="calibration reservoir cap per layer (bounds host "
                         "memory; default keeps every token)")
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--save-dir", default=None,
                    help="persist the compressed artifact (not ported yet: "
                         "raises)")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="device mesh for the pipeline (not ported yet: "
                         "raises)")
    ap.add_argument("--device", default="cuda",
                    help="where calibration and evaluation run: cuda (the "
                         "hand-written kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    _, _, report = run(args.arch, args.method, args.merged_experts,
                       split=args.split, calib_batches=args.calib_batches,
                       eval_batches=args.eval_batches, plan_path=args.plan,
                       target_ratio=args.target_ratio,
                       max_calib_tokens=args.max_calib_tokens,
                       save_dir=args.save_dir, mesh_spec=args.mesh,
                       weight_dtype=args.weight_dtype, device=args.device)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()

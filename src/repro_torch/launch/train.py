"""The end-to-end trainer, the port's copy of ``repro/launch/train.py``.

One device: the data pipeline with its checkpointable cursor, the train
step (``launch/steps.py :: make_train_step``), atomic keep-N checkpoints
with async save in the reference's format (``(params, opt_state)`` with the
data cursor in the extras, so either package resumes the other's),
automatic resume from the latest, straggler monitoring, optional int8
error-feedback gradient compression, gradient accumulation.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \
        --steps 100 --global-batch 8 --seq-len 128 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5

Every family but audio trains on the pipeline's token batches, as the
reference's trainer does (a vlm on its text alone, no patches); the audio
family's forward needs frames the pipeline does not make, so :func:`build`
refuses it (ROADMAP C13). It runs on ``cuda`` unless ``--device cpu`` is
given, never falling back.
``--no-reduced --layers 4`` trains the published widths of ``--arch`` at a
cut depth; ``--dtype float32`` overrides the parameters' type. Booleans take
``--x`` / ``--no-x``. The reference's mesh (``--mesh-shape``) belongs to
the mesh slice (ROADMAP A15) and is refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import configs, convert
from repro_torch.ckpt import checkpoint as CKPT
from repro_torch.data.pipeline import DataState, make_pipeline
from repro_torch.distributed import StragglerMonitor, ef_compressed
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.optim import default_optimizer_for, make_optimizer


@dataclasses.dataclass
class TrainConfig:
    arch: str = "qwen3-moe-30b-a3b"
    reduced: bool = True
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    optimizer: str = ""                # "" -> size-based default
    microbatches: int = 1
    ckpt_dir: str = ""
    ckpt_every: int = 50
    ckpt_keep: int = 3
    async_ckpt: bool = True
    grad_compression: bool = False
    seed: int = 0
    data_dir: str = ""
    log_every: int = 10
    mesh_shape: str = ""               # the reference's mesh: refused here
    # the port's own
    device: str = "cuda"
    layers: int = 0                    # depth override (0: the config's)
    dtype: str = ""                    # parameter type ("": the config's)


def to_device(batch, device):
    """A pipeline batch (numpy int32) as int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, torch.int64)
            for k, v in batch.items()}


def build(tc: TrainConfig):
    """(cfg, model, opt_state, step_fn) on ``tc.device``: the model's weights
    drawn from ``tc.seed``, the optimizer state in the reference's tree."""
    if tc.mesh_shape:
        raise NotImplementedError(
            f"mesh_shape={tc.mesh_shape!r}: training on a device mesh belongs "
            f"to the mesh slice (ROADMAP A15), not ported yet; the port "
            f"trains on one device")
    device = torch.device(tc.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device and none is "
                           "available; pass --device cpu")
    cfg = configs.get(tc.arch)
    if tc.reduced:
        cfg = cfg.reduced()
    if tc.layers:
        cfg = cfg.replace(n_layers=tc.layers)
    if tc.dtype:
        cfg = cfg.replace(dtype=tc.dtype)
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: the audio family's forward needs 'frames' "
            f"[B, n_audio_ctx, d_model] and the data pipeline makes token "
            f"batches only (the reference's trainer fails on its first step "
            f"there, ROADMAP C13); train it through "
            f"launch.steps.make_train_step with frames in the batch")
    opt_name = tc.optimizer or default_optimizer_for(cfg.param_count())
    opt = make_optimizer(opt_name, lr=tc.lr)
    if tc.grad_compression:
        opt = ef_compressed(opt)
    model = MD.init(cfg, device, seed=tc.seed)
    opt_state = opt.init(MD.shape_tree(model))
    step_fn = ST.make_train_step(cfg, opt, microbatches=tc.microbatches)
    return cfg, model, opt_state, step_fn


def _state(model, opt_state):
    return (convert.reference_tree(model), opt_state)


def train(tc: TrainConfig):
    """Train; returns ``{"losses", "final_loss", "params": the model
    (frozen again), "cfg", "step_s": each step's seconds}``, or, when the
    straggler policy fires, ``{"aborted_for_relaunch": True, "step",
    "losses"}`` after a checkpoint."""
    cfg, model, opt_state, step_fn = build(tc)
    device = model.device
    data = make_pipeline(cfg, tc.seq_len, tc.global_batch,
                         data_dir=tc.data_dir or None, seed=tc.seed)
    start_step = 0
    mgr = None
    if tc.ckpt_dir:
        mgr = CKPT.CheckpointManager(tc.ckpt_dir, keep=tc.ckpt_keep,
                                     async_save=tc.async_ckpt)
        latest = mgr.latest_step()
        if latest is not None:
            (params, opt_state), extras = mgr.restore(latest, device=device)
            model = convert.from_reference_params(params, cfg, device)
            del params
            data.restore(DataState.from_json(extras["data_state"]))
            start_step = latest
            print(f"[train] resumed from step {latest}")

    mon = StragglerMonitor()
    history, step_s = [], []
    for step in range(start_step, tc.steps):
        batch = to_device(next(data), device)
        mon.start_step()
        model, opt_state, loss, metrics = step_fn(model, opt_state, batch,
                                                  step)
        loss = float(loss)
        rep = mon.end_step()
        history.append(loss)
        step_s.append(rep.duration_s)
        if rep.should_restart:
            print(f"[train] straggler policy fired at step {step} "
                  f"(x{rep.ratio:.1f} median) — checkpoint + abort for relaunch")
            if mgr:
                mgr.save(step + 1, _state(model, opt_state),
                         {"data_state": data.state().to_json()})
                mgr.wait()
            return {"aborted_for_relaunch": True, "step": step,
                    "losses": history}
        if step % tc.log_every == 0 or step == tc.steps - 1:
            print(f"[train] step={step} loss={loss:.4f} "
                  f"ce={float(metrics['ce']):.4f} dt={rep.duration_s*1e3:.0f}ms",
                  flush=True)
        if mgr and (step + 1) % tc.ckpt_every == 0:
            mgr.save(step + 1, _state(model, opt_state),
                     {"data_state": data.state().to_json()})
    if mgr:
        mgr.save(tc.steps, _state(model, opt_state),
                 {"data_state": data.state().to_json()})
        mgr.wait()
    return {"losses": history, "final_loss": history[-1] if history else None,
            "params": MD.trainable(model, False), "cfg": cfg,
            "step_s": step_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainConfig):
        name = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            ap.add_argument(name, action=argparse.BooleanOptionalAction,
                            default=f.default)
        else:
            ap.add_argument(name, type=type(f.default), default=f.default)
    args = ap.parse_args(argv)
    tc = TrainConfig(**{f.name: getattr(args, f.name)
                        for f in dataclasses.fields(TrainConfig)})
    out = train(tc)
    print(json.dumps({k: v for k, v in out.items()
                      if k in ("final_loss", "aborted_for_relaunch", "step")}))


if __name__ == "__main__":
    main()

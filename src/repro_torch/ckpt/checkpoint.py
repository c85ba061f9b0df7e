"""Checkpoints and compressed artifacts in the reference's on-disk format.

Layout (``repro/ckpt/checkpoint.py``'s, unchanged):

    <dir>/step_00000420.tmp/...      (in-flight write)
    <dir>/step_00000420/             (renamed into place when complete)
        meta.json                    (step, treedef, leaves, extras,
                                      tree_digest)
        leaf_00000.npy ...           (one file per leaf, the whole array)
        COMMIT                       (a step directory without it is
                                      ignored)

A tree is nested dicts / lists / tuples / ``None`` holding torch tensors or
numpy arrays, flattened in JAX's order (:mod:`repro_torch.ckpt.treedef`,
which also writes and reads ``meta.json``'s ``treedef``: JAX's
``PyTreeDef`` protobuf). bf16 leaves are stored as fp32 ``.npy`` files with
``"dtype": "bfloat16"`` (exact both ways); other dtypes are stored as they
are. :func:`tree_digest` hashes each leaf's key path and its raw bytes (a
bf16 leaf's two-byte bits), bitwise the reference's, so either side reads
the other's artifacts and verifies them.

Compressed artifacts (:func:`save_compressed`) hold a MergeMoE model in the
reference's tree layout (stacked ``[L, ...]`` leaves under the reference's
names: :func:`repro_torch.convert.reference_tree`) with heterogeneous
suffix tables stored unpadded, and the config, plan, report and mesh
provenance in ``meta.json``'s extras; :func:`load_compressed` rebuilds the
model on the device asked for. Restoring onto a mesh (the reference's
``shardings=``) belongs to the mesh slice: :func:`load` takes a ``device``.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import convert
from repro_torch.ckpt import treedef as TD
from repro_torch.core import errors as ERR

_BF16 = "bfloat16"


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _host(leaf) -> Tuple[bytes, np.ndarray]:
    """(the bytes :func:`tree_digest` hashes, the array the ``.npy`` file
    stores) of one leaf: for bf16, its two-byte bits and their fp32
    widening."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), t.float().numpy()
        a = t.numpy()
        return a.tobytes(), a
    a = np.ascontiguousarray(np.asarray(leaf))
    return a.tobytes(), (a.astype(np.float32) if str(a.dtype) == _BF16 else a)


def tree_digest(tree) -> str:
    """sha256 over every leaf's key path (as JAX prints it) and raw bytes:
    the reference's ``tree_digest`` of the same tree, bit for bit."""
    h = hashlib.sha256()
    for path, leaf in TD.leaves_with_path(tree):
        h.update(str(path).encode())
        h.update(_host(leaf)[0])
    return h.hexdigest()


def save(directory, step: int, tree, extras: Optional[Dict] = None,
         keep: int = 3) -> Path:
    """Atomic save of ``tree`` as ``<directory>/step_<step>``; keeps the
    ``keep`` newest committed steps (0: all). Returns the committed
    directory."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    h = hashlib.sha256()
    leaves = []
    for i, (path, leaf) in enumerate(TD.leaves_with_path(tree)):
        raw, arr = _host(leaf)
        h.update(str(path).encode())
        h.update(raw)
        np.save(tmp / f"leaf_{i:05d}.npy", arr)
        leaves.append({"dtype": _dtype_name(leaf), "shape": list(arr.shape)})
    meta = {
        "step": step,
        "treedef": TD.encode(tree).hex(),
        "leaves": leaves,
        "extras": extras or {},
        # load() recomputes it over the restored tree and refuses an
        # artifact whose bytes changed after the save
        "tree_digest": h.hexdigest(),
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    (tmp / "COMMIT").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _gc(directory, keep)
    return final


def _gc(directory: Path, keep: int) -> None:
    steps = sorted(d for d in directory.glob("step_????????")
                   if (d / "COMMIT").exists())
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(d, ignore_errors=True)
    for d in directory.glob("step_*.tmp"):       # orphaned partial writes
        if not (d / "COMMIT").exists():
            shutil.rmtree(d, ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in directory.glob("step_????????")
             if (d / "COMMIT").exists()]
    return max(steps) if steps else None


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("loading onto device='cuda' needs a CUDA device "
                           "and none is available; pass device='cpu'")
    return device


def load(directory, step: Optional[int] = None, device="cuda",
         verify: bool = True) -> Tuple[Any, Dict]:
    """Restore (tree, extras), the leaves torch tensors on ``device`` in
    their stored dtypes (bf16 back from its fp32 file, exactly).

    ``verify=True`` recomputes :func:`tree_digest` over the restored tree
    and raises :class:`repro_torch.core.errors.ArtifactCorruptError` when it
    does not match the digest recorded at save time. Checkpoints written
    without a digest skip the check; ``verify=False`` loads a corrupted
    artifact for forensics."""
    device = _check_device(device)
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = directory / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    leaves = []
    for i, info in enumerate(meta["leaves"]):
        t = torch.from_numpy(np.load(d / f"leaf_{i:05d}.npy"))
        leaves.append(t.to(torch.bfloat16) if info["dtype"] == _BF16 else t)
    tree = TD.unflatten(bytes.fromhex(meta["treedef"]), leaves)
    want = meta.get("tree_digest")
    if verify and want is not None:
        got = tree_digest(tree)
        if got != want:
            raise ERR.ArtifactCorruptError(
                f"checkpoint {d} failed digest verification: meta.json "
                f"records {want[:16]}… but the restored tree hashes to "
                f"{got[:16]}… — the artifact bytes were corrupted after "
                f"save. Pass verify=False to load anyway (forensics only).")
    if device.type != "cpu":
        tree = TD.tree_map(lambda t: t.to(device), tree)
    return tree, meta.get("extras", {})


# ---------------------------------------------------------------------------
# compressed artifacts: plan + report + config ride in meta.json extras
# ---------------------------------------------------------------------------

_EXPERT_TABLES = ("wg", "wu", "wd")


def _pack_stacked(stacked, live):
    """[L_c, M_max, ...] -> {layer_i: [live_i, ...]} (expert axis sliced)."""
    return {f"layer_{i:03d}": stacked[i, :int(live[i])]
            for i in range(stacked.shape[0])}


def _unpack_stacked(layers, M):
    """Inverse of :func:`_pack_stacked`: zero-pad each layer back to ``M``
    rows and restack (pad rows are exact zeros, values and int8 scales
    alike)."""
    out = []
    for i in range(len(layers)):
        a = layers[f"layer_{i:03d}"]
        pad = M - a.shape[0]
        if pad:
            a = F.pad(a, (0, 0) * (a.dim() - 1) + (0, pad))
        out.append(a)
    return torch.stack(out)


def _pack_ragged_suffix(cfg, params):
    """Store heterogeneous suffix expert tables UNPADDED: each stacked
    ``[L_c, M_max, ...]`` leaf becomes one per-layer leaf sliced to that
    layer's live count (the six ``qexp`` leaves of int8 tables alike), so
    the artifact's bytes are the plan's budget, not the in-memory
    padding."""
    if cfg.moe_merged_layers is None:
        return params
    live = cfg.live_experts_per_suffix_layer()
    moe = dict(params["stack_c"]["moe"])
    if "qexp" in moe:
        moe["qexp"] = {k: _pack_stacked(v, live)
                       for k, v in moe["qexp"].items()}
    else:
        for key in _EXPERT_TABLES:
            moe[key] = _pack_stacked(moe[key], live)
    return {**params, "stack_c": {**params["stack_c"], "moe": moe}}


def _unpack_ragged_suffix(cfg, tree):
    """Inverse of :func:`_pack_ragged_suffix`: every suffix layer padded
    back to ``cfg.moe_merged`` rows and restacked."""
    if cfg.moe_merged_layers is None:
        return tree
    M = cfg.moe_merged
    moe = dict(tree["stack_c"]["moe"])
    if "qexp" in moe:
        moe["qexp"] = {k: _unpack_stacked(v, M)
                       for k, v in moe["qexp"].items()}
    else:
        for key in _EXPERT_TABLES:
            moe[key] = _unpack_stacked(moe[key], M)
    return {**tree, "stack_c": {**tree["stack_c"], "moe": moe}}


def save_compressed(directory, cfg, model, plan=None, report=None,
                    step: int = 0, keep: int = 0) -> Path:
    """Persist a MergeMoE-compressed :class:`~repro_torch.models.model.Model`
    as a loadable artifact: its reference-layout tree through :func:`save`,
    the ``ModelConfig``, the executed plan (a ``CompressionPlan`` or its
    JSON dict), the compression report and the mesh it ran under in
    ``meta.json``'s extras, so :func:`load_compressed` (and
    ``Engine.from_checkpoint``) rebuild the model with nothing else.
    ``keep=0`` disables GC: artifacts are not a rolling window."""
    if not cfg.moe_merged:
        raise ValueError(
            f"{cfg.name} is not compressed; save_compressed stores MergeMoE "
            "artifacts — use save() for training checkpoints")
    plan_dict = None
    if plan is not None:
        plan_dict = plan if isinstance(plan, dict) else plan.to_json_dict()
    # mesh provenance, never a loading constraint; one schema whatever its
    # source: {"axes": {...}, ...} (the plan's flat axis dict is wrapped)
    mesh_meta = (report or {}).get("mesh")
    if mesh_meta is None and plan_dict is not None \
            and plan_dict.get("mesh") is not None:
        mesh_meta = {"axes": plan_dict["mesh"]}
    extras = {"compressed": {
        "format": 1,
        "config": cfg.to_json_dict(),
        "plan": plan_dict,
        "report": report or {},
        "mesh": mesh_meta,
    }}
    tree = _pack_ragged_suffix(cfg, convert.reference_tree(model))
    return save(directory, step, tree, extras=extras, keep=keep)


def load_compressed_tree(directory, step: Optional[int] = None,
                         verify: bool = True):
    """(cfg, tree, artifact) of a :func:`save_compressed` directory: the
    reference-layout tree on the host, suffix tables padded back to
    ``cfg.moe_merged`` rows with exact zeros, leaves torch CPU tensors in
    their stored dtypes (numpy has no bf16); ``artifact`` is the extras
    (``format``, ``config``, ``plan``, ``report``, ``mesh``)."""
    from repro_torch.models.config import config_from_dict
    tree, extras = load(directory, step, device="cpu", verify=verify)
    art = extras.get("compressed")
    if art is None:
        raise ValueError(
            f"{directory} holds a plain checkpoint, not a compressed "
            "artifact (no 'compressed' extras); use load()")
    cfg = config_from_dict(art["config"])
    return cfg, _unpack_ragged_suffix(cfg, tree), art


def load_compressed(directory, step: Optional[int] = None,
                    verify: bool = True, device="cuda"):
    """(cfg, model, artifact) of a :func:`save_compressed` directory, the
    model built on ``device`` (:func:`load_compressed_tree`, then
    ``convert.from_reference_params``)."""
    device = _check_device(device)
    cfg, tree, art = load_compressed_tree(directory, step, verify=verify)
    return cfg, convert.from_reference_params(tree, cfg, device), art


class CheckpointManager:
    """Keep-N manager with optional ASYNC saves: the tree is copied to the
    host on the caller's thread, then written on a worker thread, so the
    caller never waits on the disk (the next call waits for it)."""

    def __init__(self, directory, keep: int = 3, async_save: bool = False):
        self.directory = Path(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree, extras: Optional[Dict] = None) -> None:
        self.wait()
        if not self.async_save:
            save(self.directory, step, tree, extras, self.keep)
            return
        snapshot = TD.tree_map(
            lambda x: (x.detach().to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else np.array(x)), tree)

        def work():
            try:
                save(self.directory, step, snapshot, extras, self.keep)
            except BaseException as e:   # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    def restore(self, step: Optional[int] = None, device="cuda"):
        self.wait()
        return load(self.directory, step, device=device)

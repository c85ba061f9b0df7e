"""Calibration capture: the expert-layer inputs and usage counts the merge
solves consume.

* :class:`CalibrationStream` is a STREAMING accumulator. Feed it batches one
  at a time (``update``): each runs the port's full-sequence forward with
  ``capture=True`` on the model's device (the flash kernel on the card) and
  folds the captured activations into a per-layer token reservoir on the
  host, with running usage counts. Host memory is ``O(L * max_tokens * d)``
  however many batches are streamed (Algorithm-R reservoir sampling once the
  cap is hit, with ONE shared replacement schedule across layers, so every
  layer keeps the same token positions; deterministic under ``seed``).
* :func:`collect` is the one-shot API: every batch through a stream,
  returned as ``{layer: LayerCalibration}``.

The replacement schedule is a PURE FUNCTION of a token's global stream index
(:func:`reservoir_slots`, a counter-based splitmix64 draw), so any partition
of the stream folds to the same reservoir (:func:`merge_reservoirs`). The
reservoir functions are the port's copies of the reference's
(``repro/core/calibration.py``) and bit-identical to them. Capture over a
device mesh (``mesh=``) belongs to a later slice and raises
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig


@dataclass
class LayerCalibration:
    x: np.ndarray        # [T, d] expert-layer inputs (tokens pooled)
    counts: np.ndarray   # [N] usage frequencies


# ---------------------------------------------------------------------------
# deterministic reservoir schedule (shared across layers AND shards)
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _u01(seed: int, g: np.ndarray) -> np.ndarray:
    """Counter-based uniform draws in [0, 1): a pure function of (seed,
    global token index). splitmix64 finalizer over the index — no RNG state,
    so the draw for token g is the same no matter which shard computes it or
    in what order tokens are folded."""
    z = g.astype(np.uint64)
    z = z ^ np.uint64((seed * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019)
                      & _MASK64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) * 2.0 ** -53


def reservoir_slots(g: np.ndarray, cap: int, seed: int,
                    policy: str = "reservoir") -> np.ndarray:
    """Reservoir slot claimed by each global token index (-1 = dropped).

    Token g claims slot g while the reservoir fills; beyond that, Algorithm
    R — slot ``floor(u(g)·(g+1))`` iff it lands below ``cap`` (replacement
    probability cap/(g+1), uniform over slots). ``policy="head"`` claims
    only the fill phase (legacy first-``cap`` truncation).

    The final reservoir is defined as: slot j holds the token with the
    LARGEST global index among all tokens claiming j. Because the claim is a
    pure function of (seed, g), that definition is independent of how the
    stream is partitioned — any sharding folds to the same reservoir.
    """
    if policy == "head":
        return np.where(g < cap, g, -1)
    js = np.floor(_u01(seed, g) * (g + 1).astype(np.float64)).astype(np.int64)
    return np.where(g < cap, g, np.where(js < cap, js, -1))


def fold_tokens(x: np.ndarray, slot_g: np.ndarray, xi: np.ndarray,
                g: np.ndarray, *, cap: int, seed: int,
                policy: str = "reservoir") -> None:
    """Fold tokens ``xi [L, n, d]`` with global indices ``g [n]`` into the
    reservoir state (``x [L, cap, d]``, ``slot_g [cap]``) in place.

    Last-write-wins BY GLOBAL INDEX, not by call order: a slot is overwritten
    only when the incoming token's g exceeds the g already stored there, so
    folding any partition of a stream in any order yields the same state as
    one sequential pass."""
    slots = reservoir_slots(g, cap, seed, policy)
    keep = slots >= 0
    if not keep.any():
        return
    tok = np.flatnonzero(keep)
    slots, gk = slots[keep], g[keep]
    order = np.argsort(gk, kind="stable")
    slots, gk, tok = slots[order], gk[order], tok[order]
    # per-slot winner within this chunk: the last (max-g) occurrence
    uniq, first_rev = np.unique(slots[::-1], return_index=True)
    sel = len(slots) - 1 - first_rev
    win = gk[sel] > slot_g[uniq]
    tgt = uniq[win]
    x[:, tgt] = xi[:, tok[sel[win]]]
    slot_g[tgt] = gk[sel[win]]


def merge_reservoirs(parts: Iterable[Tuple[np.ndarray, np.ndarray]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic cross-shard reservoir merge: per slot, keep the row
    holding the largest global token index. Given per-shard states folded
    over disjoint token ranges, the merge equals the sequential fold of the
    whole stream (claims are pure functions of g — DESIGN.md §6)."""
    parts = list(parts)
    if not parts:
        raise ValueError("merge_reservoirs needs at least one shard state")
    x, g = parts[0][0].copy(), parts[0][1].copy()
    for xi, gi in parts[1:]:
        win = gi > g
        x[:, win] = xi[:, win]
        g[win] = gi[win]
    return x, g


class CalibrationStream:
    """Streaming per-layer activation reservoir + running expert counts.

    ``max_tokens_per_layer=None`` keeps every streamed token (the legacy
    ``collect`` behavior — unbounded); an integer cap bounds host memory.
    Beyond the cap, ``policy`` picks what survives:

    * ``"reservoir"`` (default) — Algorithm-R uniform sample over every
      streamed token (seeded, deterministic, shard-count invariant);
    * ``"head"`` — keep the FIRST cap tokens and drop the rest, exactly the
      legacy concatenate-then-truncate capture (counts keep accumulating
      over the whole stream either way).

    Tokens below the cap are kept in stream order under both policies, so
    with a cap ≥ the total token count the stream is bit-identical to the
    legacy capture.

    ``mesh`` must be None (mesh-parallel capture is a later slice).
    """

    def __init__(self, cfg: ModelConfig, model: MD.Model,
                 max_tokens_per_layer: Optional[int] = None, seed: int = 0,
                 policy: str = "reservoir", mesh=None):
        if cfg.moe is None:
            raise ValueError("calibration capture requires an MoE model")
        if policy not in ("reservoir", "head"):
            raise ValueError(f"unknown calibration policy {policy!r}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh-parallel capture is not ported yet (it comes with the "
                "mesh slice); capture on one device")
        self.cfg = cfg
        self.cap = max_tokens_per_layer
        self.policy = policy
        self.seed = seed
        self.mesh = None
        self._model = model
        self._x: Optional[np.ndarray] = None      # [L, cap, d] reservoir rows
        self._slot_g: Optional[np.ndarray] = None  # [cap] global idx per slot
        # uncapped mode defers concatenation: chunks pile up here and are
        # joined once on first read (streaming B batches stays O(B), not
        # O(B^2) in host copies)
        self._chunks: List[np.ndarray] = []
        self._counts: Optional[np.ndarray] = None  # [L, N]
        self.tokens_seen = 0
        self.batches_seen = 0

    # ---- feeding ----------------------------------------------------------
    def update(self, batch: Dict[str, torch.Tensor]) -> None:
        """Run one capture forward on the model's device and fold the batch
        into the reservoir on the host. batch: ``{"tokens": [B, S]}``
        (moved to the model's device)."""
        dev = self._model.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        _, _, (expert_inputs, cnts) = MD.forward(self.cfg, self._model, batch,
                                                 capture=True)
        c = cnts.to(torch.float32).cpu().numpy()           # [L, N]
        self._counts = c if self._counts is None else self._counts + c
        L, B, S, d = expert_inputs.shape
        xi = expert_inputs.to(torch.float32).cpu().numpy().reshape(L, B * S, d)
        if self.cap is None:
            self._chunks.append(xi)
        else:
            if self._x is None:
                self._x = np.zeros((L, self.cap, d), np.float32)
                self._slot_g = np.full(self.cap, -1, np.int64)
            g = self.tokens_seen + np.arange(B * S, dtype=np.int64)
            fold_tokens(self._x, self._slot_g, xi, g, cap=self.cap,
                        seed=self.seed, policy=self.policy)
        self.tokens_seen += B * S
        self.batches_seen += 1

    def consume(self, batches: Iterable[dict]) -> "CalibrationStream":
        for b in batches:
            self.update(b)
        return self

    def reservoir_state(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows [L, cap, d], slot_g [cap]) — the mergeable shard state for
        cross-host reduction via :func:`merge_reservoirs`."""
        if self.cap is None or self._x is None:
            raise ValueError("reservoir_state requires a capped, fed stream")
        return self._x, self._slot_g

    def _materialize(self) -> np.ndarray:
        if self._chunks:
            parts = self._chunks
            self._chunks = [parts[0] if len(parts) == 1
                            else np.concatenate(parts, axis=1)]
            return self._chunks[0]
        if self._x is None:
            raise ValueError("CalibrationStream has seen no batches")
        held = int((self._slot_g >= 0).sum())
        # fill-phase claims are slot g == token g, so filled slots form a
        # contiguous prefix; a full reservoir returns the whole buffer
        return self._x if held == self.cap else self._x[:, :held]

    # ---- consuming --------------------------------------------------------
    @property
    def n_tokens(self) -> int:
        """Tokens currently held per layer (≤ cap)."""
        if self._chunks:
            return sum(c.shape[1] for c in self._chunks)
        if self._x is None:
            return 0
        return int((self._slot_g >= 0).sum())

    def layer(self, l: int) -> LayerCalibration:
        """Calibration view for ONE layer (the plan executor's access path)."""
        x = self._materialize()
        return LayerCalibration(x=x[l], counts=self._counts[l])

    def counts(self, l: int) -> np.ndarray:
        if self._counts is None:
            raise ValueError("CalibrationStream has seen no batches")
        return self._counts[l]

    def stats(self) -> Dict[int, np.ndarray]:
        """{layer: usage counts} — the budget planner's input."""
        if self._counts is None:
            return {}
        return {l: self._counts[l] for l in range(self._counts.shape[0])}

    def as_dict(self) -> Dict[int, LayerCalibration]:
        """Legacy ``collect``-shaped view (per-layer materialization)."""
        x = self._materialize()
        return {l: self.layer(l) for l in range(x.shape[0])}


def collect(cfg: ModelConfig, model: MD.Model, batches: Iterable[dict],
            max_tokens_per_layer: int | None = None, seed: int = 0
            ) -> Dict[int, LayerCalibration]:
    """Returns {layer_index: LayerCalibration} for every MoE layer
    (compatibility wrapper over :class:`CalibrationStream`; ``policy='head'``
    reproduces the historical concatenate-then-truncate capture exactly)."""
    assert cfg.moe is not None, "calibration capture requires an MoE model"
    stream = CalibrationStream(cfg, model,
                               max_tokens_per_layer=max_tokens_per_layer,
                               seed=seed, policy="head")
    stream.consume(batches)
    return stream.as_dict()

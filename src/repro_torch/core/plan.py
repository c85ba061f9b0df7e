"""Declarative compression plans + the merge-strategy registry.

The paper frames MergeMoE as a PER-LAYER decision: which layers to merge,
down to how many experts, with which construction. A ``CompressionPlan`` makes
that decision explicit and serializable instead of baking one global
``(method, merged_experts, split)`` triple into ``compress_model``:

    plan = PLAN.uniform(cfg, method="mergemoe", merged_experts=4, split=28)
    plan = PLAN.suffix(cfg, method="mergemoe", merged_experts=4, frac=0.4)
    plan = PLAN.for_target_ratio(cfg, target_ratio=1.6, stats=stream.stats())

Plans are executed by :func:`repro_torch.core.compress.compress_with_plan`
(the port does not persist artifacts yet).

Strategies are self-describing classes registered with ``@register_method``;
each declares which calibration inputs it needs (``requires`` ⊆ {"x",
"counts", "router"}) so the executor only materializes what a layer's method
actually consumes — this replaces the old ``METHODS`` dict plus the
``if method == "msmoe"`` special case in ``merge_layer``.

The port's copy of the reference's ``repro/core/plan.py`` (pure NumPy / Python,
no framework): the same inputs give bit-identical results.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.core import merge as MG
from repro_torch.core.errors import TechniqueInapplicable
from repro_torch.models.config import ModelConfig

PLAN_FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# strategy registry
# ---------------------------------------------------------------------------

class MergeStrategy:
    """One way of collapsing N experts into M. Subclasses declare their
    calibration ``requires`` and implement :meth:`merge`."""

    name: str = ""
    #: subset of {"x", "counts", "router"} the strategy consumes. Everything
    #: it does not list may be passed as None by the executor.
    requires: Tuple[str, ...] = ()

    def merge(self, wg, wu, wd, counts, X, M, *, router=None,
              **kw) -> MG.MergeResult:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<MergeStrategy {self.name} requires={self.requires}>"


_REGISTRY: Dict[str, MergeStrategy] = {}


def register_method(name: str):
    """Class decorator: ``@register_method("mergemoe")``. The class is
    instantiated once and becomes addressable from plans and the CLI."""
    def deco(cls: Type[MergeStrategy]) -> Type[MergeStrategy]:
        inst = cls()
        inst.name = name
        _REGISTRY[name] = inst
        return cls
    return deco


def get_strategy(name: str) -> MergeStrategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown merge method {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def available_methods() -> List[str]:
    return sorted(_REGISTRY)


@register_method("mergemoe")
class MergeMoEStrategy(MergeStrategy):
    """Paper §4: cluster -> frequency-weighted T2/T3 average -> least-squares
    down projection against the merged cluster outputs."""
    requires = ("x", "counts")

    def merge(self, wg, wu, wd, counts, X, M, *, router=None, **kw):
        return MG.merge_mergemoe(wg, wu, wd, counts, X, M, **kw)


@register_method("msmoe")
class MSMoEStrategy(MergeStrategy):
    """M-SMoE (Li et al., 2023): frequency-weighted parameter averaging,
    clustered on the router columns (the routing-policy view)."""
    requires = ("counts", "router")

    def merge(self, wg, wu, wd, counts, X, M, *, router=None, **kw):
        return MG.merge_msmoe(wg, wu, wd, counts, X, M, router=router)


@register_method("average")
class AverageStrategy(MergeStrategy):
    """Uniform parameter averaging within weight-similarity clusters."""
    requires = ("counts",)

    def merge(self, wg, wu, wd, counts, X, M, *, router=None, **kw):
        return MG.merge_average(wg, wu, wd, counts, X, M)


@register_method("zipit")
class ZipItStrategy(MergeStrategy):
    """ZipIt-style activation-correlation neuron matching before averaging."""
    requires = ("x", "counts")

    def merge(self, wg, wu, wd, counts, X, M, *, router=None, **kw):
        return MG.merge_zipit(wg, wu, wd, counts, X, M)


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerSpec:
    """Compression decision for one layer."""
    layer: int
    method: str
    merged_experts: int

    def to_dict(self) -> dict:
        return {"layer": self.layer, "method": self.method,
                "merged_experts": self.merged_experts}

    @classmethod
    def from_dict(cls, d: Mapping) -> "LayerSpec":
        return cls(layer=int(d["layer"]), method=str(d["method"]),
                   merged_experts=int(d["merged_experts"]))


#: storage dtypes a plan may request for the merged expert tables.
#: "bf16" keeps the model dtype; "int8" stores symmetric
#: per-expert-per-output-channel int8 + fp32 scales (DESIGN.md §8).
WEIGHT_DTYPES = ("bf16", "int8")


@dataclass(frozen=True)
class CompressionPlan:
    """An ordered set of per-layer merge decisions.

    The merged layers must form a contiguous SUFFIX of the stack (the model
    splits into an untouched prefix ``stack`` and a compressed ``stack_c`` at
    ``split``); methods and budgets may differ per layer.

    ``mesh`` records the device mesh the plan was built/executed under
    (``(("data", 4), ("model", 2))``-style pairs, or None for single-device).
    It is provenance METADATA only: execution is bit-for-bit identical across
    mesh shapes (DESIGN.md §6), so a plan may be replayed on any mesh.

    ``weight_dtype`` picks the STORAGE dtype of the merged expert tables —
    the second, multiplicative axis of the memory budget next to the
    per-layer M: ``"bf16"`` (default) or ``"int8"``
    (per-expert-per-output-channel symmetric quantization applied at the end
    of ``compress_with_plan``, DESIGN.md §8). Orthogonal to the merge
    decisions: the planner's budget math stays in the bf16 byte model, and
    quantization is deterministic on the solved tables, so the §6 mesh
    bit-for-bit contract is unaffected.
    """
    specs: Tuple[LayerSpec, ...]
    mesh: Optional[Tuple[Tuple[str, int], ...]] = None
    weight_dtype: str = "bf16"

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(
            sorted(self.specs, key=lambda s: s.layer)))
        if self.mesh is not None:
            object.__setattr__(self, "mesh", tuple(
                (str(a), int(s)) for a, s in
                (self.mesh.items() if isinstance(self.mesh, Mapping)
                 else self.mesh)))

    def with_mesh(self, mesh) -> "CompressionPlan":
        """Same plan annotated with the mesh it ran under. Accepts a
        mesh object with a ``shape`` mapping, an {axis: size} mapping, pair tuples, or None."""
        if mesh is not None and hasattr(mesh, "shape") \
                and not isinstance(mesh, (Mapping, tuple)):
            mesh = {str(k): int(v) for k, v in mesh.shape.items()}
        return CompressionPlan(self.specs, mesh, self.weight_dtype)

    # ---- views ------------------------------------------------------------
    @property
    def split(self) -> int:
        """First merged layer."""
        if not self.specs:
            raise ValueError("empty plan has no split")
        return self.specs[0].layer

    @property
    def layers(self) -> Tuple[int, ...]:
        return tuple(s.layer for s in self.specs)

    @property
    def merged_per_layer(self) -> Tuple[int, ...]:
        return tuple(s.merged_experts for s in self.specs)

    @property
    def max_merged(self) -> int:
        return max(s.merged_experts for s in self.specs)

    @property
    def methods(self) -> Tuple[str, ...]:
        return tuple(s.method for s in self.specs)

    @property
    def is_uniform(self) -> bool:
        return (len({s.merged_experts for s in self.specs}) == 1
                and len({s.method for s in self.specs}) == 1)

    def spec_for(self, layer: int) -> LayerSpec:
        for s in self.specs:
            if s.layer == layer:
                return s
        raise KeyError(layer)

    # ---- validation -------------------------------------------------------
    def validate(self, cfg: ModelConfig) -> "CompressionPlan":
        """Checks the plan is executable against ``cfg``; returns self."""
        if cfg.moe is None:
            raise TechniqueInapplicable(
                f"{cfg.name} ({cfg.family}) has no routed experts "
                "(DESIGN.md §4).")
        if not self.specs:
            raise ValueError("plan has no layers")
        N, L = cfg.moe.n_experts, cfg.n_layers
        if self.layers != tuple(range(self.split, L)):
            raise ValueError(
                f"merged layers must form a contiguous suffix of "
                f"[0, {L}); got {self.layers}")
        for s in self.specs:
            if not 1 <= s.merged_experts <= N:
                raise ValueError(
                    f"layer {s.layer}: merged_experts={s.merged_experts} "
                    f"outside [1, {N}]")
            get_strategy(s.method)       # raises on unregistered methods
        if self.weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(
                f"weight_dtype={self.weight_dtype!r} not in {WEIGHT_DTYPES}")
        return self

    def apply_to(self, cfg: ModelConfig) -> ModelConfig:
        """Config view after executing this plan."""
        self.validate(cfg)
        return cfg.compressed_per_layer(self.merged_per_layer, self.split)

    # ---- calibration requirements -----------------------------------------
    def requirements(self) -> Tuple[str, ...]:
        """Union of the calibration inputs any layer's strategy consumes."""
        req = set()
        for s in self.specs:
            req.update(get_strategy(s.method).requires)
        return tuple(sorted(req))

    # ---- (de)serialization -------------------------------------------------
    def to_json_dict(self) -> dict:
        d = {"version": PLAN_FORMAT_VERSION,
             "weight_dtype": self.weight_dtype,
             "specs": [s.to_dict() for s in self.specs]}
        if self.mesh is not None:
            d["mesh"] = {a: s for a, s in self.mesh}
        return d

    @classmethod
    def from_json_dict(cls, d: Mapping) -> "CompressionPlan":
        mesh = d.get("mesh")
        return cls(specs=tuple(LayerSpec.from_dict(s) for s in d["specs"]),
                   mesh=None if mesh is None else tuple(
                       (str(a), int(s)) for a, s in mesh.items()),
                   # absent in pre-int8 plan files -> bf16 (back-compat)
                   weight_dtype=str(d.get("weight_dtype", "bf16")))

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), indent=1)

    @classmethod
    def from_json(cls, text: str) -> "CompressionPlan":
        return cls.from_json_dict(json.loads(text))

    @classmethod
    def load(cls, path) -> "CompressionPlan":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def _default_split(cfg: ModelConfig, split: Optional[int]) -> int:
    if split is None:
        split = int(cfg.n_layers * 0.6)   # paper's suffix convention
    if not 0 <= split < cfg.n_layers:
        raise ValueError(f"split={split} outside [0, {cfg.n_layers})")
    return split


def uniform(cfg: ModelConfig, *, method: str = "mergemoe",
            merged_experts: int, split: Optional[int] = None,
            weight_dtype: str = "bf16") -> CompressionPlan:
    """Same method and budget for every layer in [split, n_layers) — the
    legacy ``compress_model(method, merged_experts, split)`` surface."""
    split = _default_split(cfg, split)
    return CompressionPlan(tuple(
        LayerSpec(l, method, merged_experts)
        for l in range(split, cfg.n_layers)),
        weight_dtype=weight_dtype).validate(cfg)


def suffix(cfg: ModelConfig, *, method: str = "mergemoe",
           merged_experts: int, frac: float = 0.4,
           weight_dtype: str = "bf16") -> CompressionPlan:
    """Merge the last ``frac`` of the stack uniformly (paper App. C.2 merges
    the final ~40% of layers)."""
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"frac={frac} outside (0, 1]")
    split = cfg.n_layers - max(1, int(round(cfg.n_layers * frac)))
    return uniform(cfg, method=method, merged_experts=merged_experts,
                   split=split, weight_dtype=weight_dtype)


def expert_bytes(cfg: ModelConfig, weight_dtype: str = "bf16") -> int:
    """Bytes of ONE expert's three projection matrices at ``weight_dtype``.

    int8 stores one byte per weight plus the fp32 per-output-channel scale
    rows: ``2f`` columns for wg/wu and ``d`` for wd (DESIGN.md §8)."""
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    if weight_dtype == "int8":
        return 3 * d * f + 4 * (2 * f + d)
    return 3 * d * f * cfg.param_dtype.itemsize


def _total_bytes(cfg: ModelConfig) -> int:
    """Analytic full-model byte count (same napkin model as ``param_count``,
    at the parameter dtype)."""
    return cfg.param_count() * cfg.param_dtype.itemsize


def plan_live_ratio(cfg: ModelConfig, plan: CompressionPlan) -> float:
    """Analytic live-byte compression ratio of ``plan`` (the byte model the
    budget planner optimizes: pad rows excluded, napkin totals)."""
    per_expert = expert_bytes(cfg)
    total = _total_bytes(cfg)
    saved = sum((cfg.moe.n_experts - m) * per_expert
                for m in plan.merged_per_layer)
    return total / (total - saved)


def layer_importance(stats: Optional[Mapping[int, np.ndarray]],
                     layers: Sequence[int], n_experts: int) -> np.ndarray:
    """Per-layer merge-sensitivity proxy from calibration usage counts.

    Importance = the routing distribution's PERPLEXITY (exp of entropy): the
    effective number of experts the layer actually uses. A layer whose
    traffic concentrates on few experts (low perplexity) loses little when
    merged hard; a layer that spreads tokens across many experts needs a
    larger M. Uniform importance when no stats are given.
    """
    if stats is None:
        return np.ones(len(layers))
    imp = np.ones(len(layers))
    for i, l in enumerate(layers):
        c = np.asarray(stats.get(l), np.float64) if l in stats else None
        if c is None or c.sum() <= 0:
            imp[i] = float(n_experts)
            continue
        p = c / c.sum()
        ent = -np.sum(p * np.log(np.where(p > 0, p, 1.0)))
        imp[i] = float(np.exp(ent))
    return imp


def for_target_ratio(cfg: ModelConfig, *, target_ratio: float,
                     stats: Optional[Mapping[int, np.ndarray]] = None,
                     method: str = "mergemoe", split: Optional[int] = None,
                     min_merged: int = 1,
                     weight_dtype: str = "bf16") -> CompressionPlan:
    """Budget-driven planner: allocate per-layer M so the compressed model's
    (live) bytes hit ``total_bytes / target_ratio``.

    Greedy marginal allocation: start every suffix layer at M = N and
    repeatedly decrement the layer with the cheapest marginal quality cost
    ``importance_l * N / (M (M - 1))`` (the 1/M curvature makes early
    decrements cheap and deep ones expensive, so low-importance layers are
    squeezed harder but no layer collapses for free) until the byte target is
    met. Deterministic given (cfg, stats).
    """
    if cfg.moe is None:
        raise TechniqueInapplicable(
            f"{cfg.name} ({cfg.family}) has no routed experts (DESIGN.md §4).")
    if target_ratio <= 1.0:
        raise ValueError(f"target_ratio must exceed 1.0, got {target_ratio}")
    split = _default_split(cfg, split)
    layers = list(range(split, cfg.n_layers))
    N = cfg.moe.n_experts
    per_expert = expert_bytes(cfg)
    total = _total_bytes(cfg)
    need_saving = total - total / target_ratio

    imp = layer_importance(stats, layers, N)
    M = np.full(len(layers), N, np.int64)
    saved = 0.0

    def marginal(i):
        return imp[i] * N / (M[i] * (M[i] - 1))

    while saved < need_saving:
        cand = [i for i in range(len(layers)) if M[i] > min_merged]
        if not cand:
            max_ratio = total / (total - float(len(layers) * (N - min_merged)
                                               * per_expert))
            raise ValueError(
                f"target_ratio={target_ratio} unreachable by expert merging "
                f"alone over layers [{split}, {cfg.n_layers}) "
                f"(max ≈ {max_ratio:.3f}); lower the ratio or the split")
        i = min(cand, key=marginal)
        M[i] -= 1
        saved += per_expert

    # weight_dtype rides along without altering the M allocation: the greedy
    # budget math stays in the bf16 byte model, and int8 composes on top
    # (target_ratio then understates the final ratio — by design, the two
    # axes are reported separately in the compression report).
    return CompressionPlan(tuple(
        LayerSpec(l, method, int(M[i]))
        for i, l in enumerate(layers)),
        weight_dtype=weight_dtype).validate(cfg)

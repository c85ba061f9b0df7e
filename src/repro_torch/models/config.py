"""Unified model configuration covering all assigned architecture families.

Families: dense | moe | vlm | hybrid | ssm | audio (enc-dec).
A single ``ModelConfig`` instance fully determines parameter shapes,
forward semantics and sharding-relevant dimensions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


#: the dtype strings a config may carry, as the torch types the port stores
#: parameters in
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


@dataclass(frozen=True)
class MoEConfig:
    """Routed-expert configuration (token-choice top-k, GShard-style capacity dispatch)."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # Tokens are dispatched within groups of this size; keeps the one-hot
    # dispatch einsum linear in total tokens (cost ~ k*cf*d_model*T*group).
    group_size: int = 1024
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01
    # 'dense'  = capacity/einsum dispatch (pjit friendly, used in dry-run)
    # 'ragged' = sort-based grouped matmul (single-device / Pallas path)
    # 'gather' = ragged that specializes decode-shaped calls (one token per
    #            sequence, S == 1, and T <= gather_max_tokens) to the
    #            per-token gather kernel; prefill buckets (S > 1) always
    #            keep the grouped kernel. Trace-time switch (DESIGN.md §7).
    dispatch: str = "dense"
    # token-count ceiling for the gather specialization under
    # dispatch='gather' (the serving engine raises it to cover n_slots)
    gather_max_tokens: int = 8
    # Expert parallelism (serving; DESIGN.md §13). ``ep_axis`` names the
    # mesh axis the expert tables are partitioned over and must only be set
    # on configs traced INSIDE a shard_map over that axis; ``ep_degree`` is
    # the static partition count (tables hold n_real/ep_degree rows per
    # shard). Defaults keep every existing config / artifact single-device.
    ep_axis: Optional[str] = None
    ep_degree: int = 1
    # Wire dtype for the EP combine step: 'fp32' returns per-pair outputs
    # via all-to-all (bitwise vs single device); 'int8' all-reduces the
    # pair table through distributed.compressed_psum (tolerance-gated).
    combine_wire_dtype: str = "fp32"
    combine_wire_seed: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) configuration."""
    d_state: int
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk_size: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                        # dense-MLP width (0 for pure SSM)
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    # MergeMoE compression state: layers [moe_split, n_layers) hold
    # ``moe_merged`` REAL expert slots (plus the original router + remap
    # table). moe_merged == 0 means uncompressed. Heterogeneous per-layer
    # budgets set ``moe_merged_layers`` (one live count per suffix layer);
    # the stored tables stay padded to ``moe_merged`` = max so the suffix
    # stack scans homogeneously, and the remap/router-logit mask keeps the
    # pad rows unreachable (DESIGN.md §5).
    moe_split: int = 0
    moe_merged: int = 0
    moe_merged_layers: Optional[Tuple[int, ...]] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one *shared* attention+MLP block applied every k SSM blocks
    hybrid_attn_every: int = 0

    # enc-dec (whisper): n_layers applies to BOTH encoder and decoder stacks
    encdec: bool = False
    n_audio_ctx: int = 0             # encoder sequence length (precomputed frames)

    # vlm: number of precomputed image-patch embeddings prepended to the text
    vlm_num_patches: int = 0

    dtype: str = "bfloat16"
    remat: str = "none"              # none | full | dots
    scan_layers: bool = True
    logits_softcap: float = 0.0

    # ---- derived ----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def param_dtype(self):
        return _TORCH_DTYPES[self.dtype]

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> eligible for the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def compressed(self, merged_experts: int, split: Optional[int] = None
                   ) -> "ModelConfig":
        """Config view after MergeMoE compression: layers [split, n_layers)
        carry ``merged_experts`` real experts. Default split follows the
        paper's suffix convention (last ~40% of layers) when not given."""
        if self.moe is None:
            from repro_torch.core.errors import TechniqueInapplicable
            raise TechniqueInapplicable(
                f"{self.name} ({self.family}) has no routed experts; "
                "MergeMoE expert merging does not apply (DESIGN.md §4).")
        if split is None:
            split = int(self.n_layers * 0.6)
        return self.replace(moe_split=split, moe_merged=merged_experts,
                            moe_merged_layers=None)

    def compressed_per_layer(self, merged_per_layer: Tuple[int, ...],
                             split: int) -> "ModelConfig":
        """Config view after a heterogeneous plan: suffix layer ``split + i``
        keeps ``merged_per_layer[i]`` LIVE experts; physical tables are
        padded to the max so the stack scans homogeneously (DESIGN.md §5)."""
        if self.moe is None:
            from repro_torch.core.errors import TechniqueInapplicable
            raise TechniqueInapplicable(
                f"{self.name} ({self.family}) has no routed experts; "
                "MergeMoE expert merging does not apply (DESIGN.md §4).")
        merged = tuple(int(m) for m in merged_per_layer)
        if len(merged) != self.n_layers - split:
            raise ValueError(
                f"need one merged-expert count per layer in "
                f"[{split}, {self.n_layers}); got {len(merged)}")
        if any(not 1 <= m <= self.moe.n_experts for m in merged):
            raise ValueError(
                f"per-layer merged counts {merged} outside "
                f"[1, {self.moe.n_experts}]")
        uniform = len(set(merged)) == 1
        return self.replace(moe_split=split, moe_merged=max(merged),
                            moe_merged_layers=None if uniform else merged)

    def live_experts_per_suffix_layer(self) -> Tuple[int, ...]:
        """Live (routable) expert count for each compressed suffix layer."""
        if not self.moe_merged:
            raise ValueError("model is not compressed")
        if self.moe_merged_layers is not None:
            return self.moe_merged_layers
        return (self.moe_merged,) * (self.n_layers - self.moe_split)

    # ---- (de)serialization for compressed artifacts ------------------------
    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.moe_merged_layers is not None:
            d["moe_merged_layers"] = list(self.moe_merged_layers)
        return d

    # ---- parameter accounting (for roofline MODEL_FLOPS) ------------------
    def attn_params_per_layer(self) -> int:
        d, hd = self.d_model, self.hd
        nq, nkv = self.n_heads, self.n_kv_heads
        qkv = d * (nq * hd + 2 * nkv * hd)
        if self.qkv_bias:
            qkv += nq * hd + 2 * nkv * hd
        out = nq * hd * d
        return qkv + out

    def dense_mlp_params_per_layer(self) -> int:
        return 3 * self.d_model * self.d_ff if self.d_ff else 0

    def ssm_params_per_layer(self) -> int:
        if self.ssm is None:
            return 0
        s, d = self.ssm, self.d_model
        di = s.d_inner(d)
        nh = s.n_heads(d)
        in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
        conv = (di + 2 * s.n_groups * s.d_state) * s.conv_width
        out_proj = di * d
        extra = nh * 2 + di  # A_log, D, norm
        return in_proj + conv + out_proj + extra

    def moe_params_per_layer(self, active_only: bool = False) -> int:
        if self.moe is None:
            return 0
        m = self.moe
        per_expert = 3 * self.d_model * m.d_ff_expert
        n = m.top_k if active_only else m.n_experts
        router = self.d_model * m.n_experts
        shared = m.n_shared_experts * per_expert
        return n * per_expert + router + shared

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active) parameter count, for 6*N*D napkin math."""
        emb = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            emb *= 2
        total = emb
        if self.family == "ssm":
            total += self.n_layers * self.ssm_params_per_layer()
        elif self.family == "hybrid":
            total += self.n_layers * self.ssm_params_per_layer()
            # one shared attention+MLP block
            total += self.attn_params_per_layer() + self.dense_mlp_params_per_layer()
        elif self.family == "audio":
            per_enc = self.attn_params_per_layer() + self.dense_mlp_params_per_layer()
            per_dec = 2 * self.attn_params_per_layer() + self.dense_mlp_params_per_layer()
            total += self.n_layers * (per_enc + per_dec)
        else:
            per = self.attn_params_per_layer()
            if self.moe is not None:
                per += self.moe_params_per_layer(active_only=active_only)
            else:
                per += self.dense_mlp_params_per_layer()
            total += self.n_layers * per
        return total

    # ---- reduced variant for CPU smoke tests ------------------------------
    def reduced(self) -> "ModelConfig":
        """Small same-family config: 2 layers, narrow width, tiny vocab."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            scan_layers=self.scan_layers,
            remat="none",
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=2, d_ff_expert=32, group_size=64,
                n_shared_experts=min(self.moe.n_shared_experts, 1))
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk_size=32)
        if self.hybrid_attn_every:
            kw["hybrid_attn_every"] = 2
        if self.encdec:
            kw["n_audio_ctx"] = 32
        if self.vlm_num_patches:
            kw["vlm_num_patches"] = 4
        return self.replace(**kw)


def config_from_dict(d: dict) -> ModelConfig:
    """Inverse of :meth:`ModelConfig.to_json_dict` (JSON-safe types back to
    the frozen dataclasses; lists back to tuples)."""
    d = dict(d)
    if d.get("moe") is not None:
        d["moe"] = MoEConfig(**d["moe"])
    if d.get("ssm") is not None:
        d["ssm"] = SSMConfig(**d["ssm"])
    if d.get("moe_merged_layers") is not None:
        d["moe_merged_layers"] = tuple(int(m) for m in d["moe_merged_layers"])
    return ModelConfig(**d)

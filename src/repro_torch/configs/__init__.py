"""Architecture registry: ``get(arch_id)`` -> ModelConfig, exact shapes from
the assignment table. One module per architecture."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "yi_34b",
    "qwen1_5_110b",
    "granite_8b",
    "phi3_medium_14b",
    "kimi_k2_1t_a32b",
    "qwen3_moe_30b_a3b",
    "phi_3_vision_4_2b",
    "zamba2_2_7b",
    "mamba2_370m",
    "whisper_base",
]

# assignment ids (with dashes/dots) -> module names
ALIASES: Dict[str, str] = {
    "yi-34b": "yi_34b",
    "qwen1.5-110b": "qwen1_5_110b",
    "granite-8b": "granite_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-370m": "mamba2_370m",
    "whisper-base": "whisper_base",
}


def canonical(arch: str) -> str:
    return ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))


def get(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# input shapes (assignment): per-arch applicability handled in launch.shapes
# ---------------------------------------------------------------------------
SHAPES = {
    "train_4k":    dict(seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524_288, global_batch=1,   kind="decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    """long_500k only for sub-quadratic archs (assignment skip rule)."""
    if shape == "long_500k":
        return cfg.supports_long_context
    return True

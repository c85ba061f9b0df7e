"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768 vocab=151936, head_dim=128.
This matches the paper's own Qwen3-30B-A3B evaluation target (Table 1):
128 -> 64 merged experts reproduces the paper's 30B -> 25B compression.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        n_experts=128,
        top_k=8,
        d_ff_expert=768,
        n_shared_experts=0,
        capacity_factor=1.25,
        group_size=512,
    ),
    remat="full",
)

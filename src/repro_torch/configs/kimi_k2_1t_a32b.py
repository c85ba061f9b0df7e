"""kimi-k2-1t-a32b — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff(expert)=2048 vocab=163840,
MoE 384 experts top-8 (+1 shared expert, per the K2 design), head_dim=128.
This is the PRIMARY MergeMoE target at scale: 384 -> 192 merged experts
halves expert memory (see core.merge / launch.compress).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=163840,
    rope_theta=50_000.0,
    moe=MoEConfig(
        n_experts=384,
        top_k=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        capacity_factor=1.25,
        group_size=2048,
    ),
    remat="full",
)

"""zamba2-2.7b — hybrid: Mamba2 blocks + ONE shared attention/MLP block
applied every 6 blocks [arXiv:2411.15242; hf].

54L d_model=2560, shared attn 32H (kv=32) d_ff=10240, vocab=32000,
ssm_state=64. Sub-quadratic -> eligible for long_500k.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_width=4,
                  chunk_size=512),
    hybrid_attn_every=6,
    remat="full",
)

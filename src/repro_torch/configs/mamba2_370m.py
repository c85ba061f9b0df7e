"""mamba2-370m — pure SSM, SSD (state-space duality) [arXiv:2405.21060;
unverified].

48L d_model=1024, attention-free, d_ff=0, vocab=50280, ssm_state=128.
Sub-quadratic -> eligible for long_500k.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=16,       # unused (attention-free); kept for config uniformity
    n_kv_heads=16,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_width=4,
                  chunk_size=512),
    remat="full",
)

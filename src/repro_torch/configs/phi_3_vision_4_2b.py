"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend STUB
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L d_model=3072 32H (kv=32, MHA) d_ff=8192 vocab=32064, head_dim=96.
The vision tower is a stub per the assignment: ``input_specs()`` provides
precomputed patch embeddings [B, 64, d_model] prepended to the text tokens.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10_000.0,
    vlm_num_patches=64,
    remat="full",
)

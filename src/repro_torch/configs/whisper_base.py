"""whisper-base — enc-dec audio, conv frontend STUB [arXiv:2212.04356;
unverified].

6L (encoder) + 6L (decoder), d_model=512 8H (kv=8, MHA) d_ff=2048
vocab=51865. ``input_specs()`` provides precomputed mel-frame embeddings
[B, 1500, d_model]; positional scheme: sinusoidal (encoder) + RoPE (decoder
self-attention) — noted in DESIGN.md as a TPU-idiomatic simplification.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    encdec=True,
    n_audio_ctx=1500,
    remat="none",
)

"""llama-3.2-vision-11b — decoder with image cross-attn every 5th layer; vision frontend stubbed.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

``input_specs()`` delivers precomputed patch embeddings (1600 tokens, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    cross_attn_every=5, n_frontend_tokens=1600, frontend_dim=4096,
    rope_theta=500000.0, remat="full",
    source="hf:meta-llama/Llama-3.2-11B-Vision (assignment card)",
)

"""seamless-m4t-large-v2 — enc-dec multimodal backbone; audio frontend stubbed. [arXiv:2308.11596; hf]

Backbone only: 24 encoder + 24 decoder layers; ``input_specs()`` delivers precomputed
audio frame embeddings (seq/4 frames, d_model) in place of the w2v-BERT frontend.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    mlp_act="gelu", norm="layernorm", frontend_dim=1024,
    rope_theta=10000.0, remat="dots",
    source="arXiv:2308.11596",
)

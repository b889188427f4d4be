"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave, MoE 16e top-2. [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    n_experts=16, moe_top_k=2, moe_every=2,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    attn_every=8, rope_theta=1000000.0,
    opt_dtype="bfloat16", remat="full",
    source="arXiv:2403.19887",
)

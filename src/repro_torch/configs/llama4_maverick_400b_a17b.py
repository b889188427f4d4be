"""llama4-maverick-400b-a17b — MoE, early fusion. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    n_experts=128, moe_top_k=1, moe_every=1,
    rope_theta=500000.0, opt_dtype="bfloat16", remat="full", remat_group=4,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (assignment card)",
)

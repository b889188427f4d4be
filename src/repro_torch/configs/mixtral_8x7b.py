"""mixtral-8x7b — 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    n_experts=8, moe_top_k=2, moe_every=1,
    sliding_window=4096, rope_theta=1000000.0, remat="full", remat_group=2,
    source="arXiv:2401.04088",
)

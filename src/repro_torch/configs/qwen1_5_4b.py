"""qwen1.5-4b — dense, QKV bias, near-MHA (kv=20). [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab_size=151936,
    qkv_bias=True, rope_theta=1000000.0, remat="full", remat_group=2,
    source="hf:Qwen/Qwen1.5-0.5B (assignment card)",
)

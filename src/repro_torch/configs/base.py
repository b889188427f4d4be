"""Architecture / shape configuration system (a plain copy of the
reference's ``repro.configs.base``).

Every assigned architecture is a frozen ``ArchConfig``; input shapes are
``ShapeConfig`` entries in ``SHAPES``.  ``reduce_for_smoke`` produces the
CPU-runnable reduced config of the same family used by the smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1              # apply MoE on layers where (layer % moe_every == moe_offset)
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0             # hybrid: one attention layer per `attn_every` layers
    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    sliding_window: int = 0         # 0 = full causal
    # --- enc-dec ---
    enc_layers: int = 0             # >0 -> encoder-decoder model
    # --- vlm ---
    cross_attn_every: int = 0       # insert image cross-attn every k-th layer
    n_frontend_tokens: int = 0      # stub frontend: #precomputed frame/patch embeddings
    frontend_dim: int = 0           # embedding dim delivered by the stub frontend
    # --- misc ---
    mlp_act: str = "swiglu"         # swiglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    opt_dtype: str = "float32"      # AdamW m/v dtype (bf16 for the ~400B archs)
    remat: str = "dots"             # none | dots | full
    remat_group: int = 1            # layers per remat/scan group (carry /= this)
    source: str = ""                # provenance note

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid families)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:       # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def n_params(self) -> int:
        """Total parameter count (approximate, matches the spec builder closely)."""
        from repro_torch.models.params import count_params
        return count_params(self)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts FFN branches)."""
        from repro_torch.models.params import count_params
        return count_params(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                       # train | prefill | decode
    seq_len: int
    global_batch: int
    long_context: bool = False      # long_500k: seq-sharded cache, needs sub-quadratic

    def applicable(self, cfg: ArchConfig) -> bool:
        if self.long_context:
            return cfg.sub_quadratic
        return True


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1, long_context=True),
}

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


# ----------------------------------------------------------------------
def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config: small widths, few experts, tiny vocab."""
    upd = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        rope_theta=10000.0,
        remat="none",
        opt_dtype="float32",
    )
    if cfg.n_experts:
        # capacity_factor = n_experts ⇒ no token ever dropped (exactness tests)
        upd.update(n_experts=4, moe_top_k=min(cfg.moe_top_k, 2), capacity_factor=4.0)
    if cfg.ssm_state:
        upd.update(ssm_state=16, ssm_head_dim=16)
    if cfg.attn_every:
        # keep the interleave ratio visible but small: 1 attn per 4 layers
        upd.update(attn_every=4, n_layers=8)
    if cfg.enc_layers:
        upd.update(enc_layers=2, n_layers=2)
    if cfg.cross_attn_every:
        upd.update(cross_attn_every=2, n_layers=4, n_frontend_tokens=8, frontend_dim=32)
    if cfg.n_frontend_tokens and not cfg.cross_attn_every:
        upd.update(n_frontend_tokens=8, frontend_dim=32)
    if cfg.sliding_window:
        upd.update(sliding_window=64)
    return replace(cfg, **upd)

"""Input stand-ins for every (arch × shape) cell, and concrete batches
for the LM scaffold (the reference's ``repro.launch.specs``).

Shapes follow the assignment contract:

  * train/prefill: tokens (batch, seq)
  * decode: ONE new token per row
  * [audio]/[vlm]: the modality frontend is a stub — the batch carries
    precomputed frame/patch embeddings (``seq // 4`` audio frames).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.params import DTYPES


def input_specs(cfg: ArchConfig, shape: ShapeConfig, dm=None) -> Dict:
    """The cell's global batch as meta tensors of the reference's shapes
    and dtypes (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    bf = DTYPES[cfg.dtype]
    sds = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")  # noqa: E731
    out: Dict = {}
    if shape.kind == "train":
        out["tokens"] = sds((b, s), torch.int32)
        out["labels"] = sds((b, s), torch.int32)
    elif shape.kind == "prefill":
        out["tokens"] = sds((b, s), torch.int32)
    elif shape.kind == "decode":
        out["token"] = sds((b,), torch.int32)
    if cfg.family == "encdec" and shape.kind in ("train", "prefill"):
        out["frames"] = sds((b, max(s // 4, 1),
                             cfg.frontend_dim or cfg.d_model), bf)
    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        out["patches"] = sds((b, cfg.n_frontend_tokens,
                              cfg.frontend_dim or cfg.d_model), bf)
    return out


def concrete_batch(cfg: ArchConfig, shape_kind: str, batch: int, seq: int,
                   rng: np.random.Generator, device=None) -> Dict:
    """Small concrete batch for smoke tests / examples: the reference's
    draws from ``rng``, in its order, as tensors on ``device`` (``None``:
    the card, raising without one)."""
    dev = resolve_device(device)
    v = cfg.vocab_size
    ints = lambda shape: torch.as_tensor(rng.integers(0, v, shape),
                                         dtype=torch.int32, device=dev)
    out: Dict = {}
    if shape_kind == "train":
        out["tokens"] = ints((batch, seq))
        out["labels"] = ints((batch, seq))
    elif shape_kind == "prefill":
        out["tokens"] = ints((batch, seq))
    elif shape_kind == "decode":
        out["token"] = ints((batch,))
    width = cfg.frontend_dim or cfg.d_model
    if cfg.family == "encdec" and shape_kind in ("train", "prefill"):
        out["frames"] = torch.as_tensor(
            rng.standard_normal((batch, max(seq // 4, 1), width)),
            device=dev).to(DTYPES[cfg.dtype])
    if cfg.family == "vlm" and shape_kind in ("train", "prefill"):
        out["patches"] = torch.as_tensor(
            rng.standard_normal((batch, cfg.n_frontend_tokens, width)),
            device=dev).to(DTYPES[cfg.dtype])
    return out

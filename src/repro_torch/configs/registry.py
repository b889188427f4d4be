"""Architecture registry: ``get_config("<arch-id>")`` / ``list_archs()``
and the dry-run's ``cells`` (the reference's ``repro.configs.registry``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, SHAPES, SHAPE_ORDER,
                                     reduce_for_smoke)

_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mamba2-780m": "mamba2_780m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "starcoder2-15b": "starcoder2_15b",
    "llama3-8b": "llama3_8b",
    "qwen1.5-4b": "qwen1_5_4b",
    "qwen2.5-14b": "qwen2_5_14b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return reduce_for_smoke(get_config(arch))


def cells(include_inapplicable: bool = False):
    """All (arch, shape) dry-run cells; skipped cells carry a reason."""
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        for sname in SHAPE_ORDER:
            shape = SHAPES[sname]
            if shape.applicable(cfg):
                out.append((arch, sname, None))
            elif include_inapplicable:
                out.append((arch, sname, "long_500k requires sub-quadratic attention "
                                         f"({cfg.family} is full-attention)"))
    return out

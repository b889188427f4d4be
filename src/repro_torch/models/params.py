"""Parameter-spec system (the reference's ``repro.models.params``).

A model is described by a flat ``{path: ParamSpec}`` dict produced once from
the ``ArchConfig`` + ``ShardPlan``.  Shapes, logical sharding axes and
initializers live in one place, so ``init_params``, ``param_shapes`` (meta
tensors, for the dry-run), ``logical_axes`` (the sharding tree) and
``count_params`` can never drift apart, and the paths are the reference's:
a tree of the port's parameters has the reference's keys, leaf for leaf.

Paths are '/'-separated; a leading ``blocks`` component with logical axis
``layer`` on dim0 denotes group-stacked parameters (``Model`` loops over
the groups).
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ShardPlan:
    """Static padding / mesh-divisibility plan (tp=1 ⇒ no padding)."""
    tp: int = 1                 # size of the 'model' mesh axis
    fsdp: int = 1               # size of the 'data' mesh axis
    dp: int = 1                 # size of the 'pod' mesh axis
    vocab_multiple: int = 1     # pad vocab to this multiple (256 on real meshes)

    def pad_heads(self, h: int) -> int:
        return round_up(h, self.tp) if h else h

    def pad_vocab(self, v: int) -> int:
        m = max(self.vocab_multiple, self.tp)
        return round_up(v, m)


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # per-dim logical axis ("layer","fsdp","tp","vocab","expert",None)
    init: str = "normal"                 # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "bfloat16"


@dataclass
class ModelDims:
    """Resolved (padded) dimensions used by the compute graph."""
    h: int          # padded q heads
    kh: int         # padded kv heads
    hd: int         # head dim
    vocab: int      # padded vocab
    d: int
    f: int
    e: int          # experts
    groups: int     # layer groups
    group_layers: int
    ssm_h: int
    ssm_p: int
    ssm_n: int
    d_inner: int
    conv_dim: int
    conv_w: int
    enc_layers: int


def resolve_dims(cfg: ArchConfig, plan: ShardPlan) -> ModelDims:
    h = plan.pad_heads(cfg.n_heads)
    kh = plan.pad_heads(cfg.n_kv_heads)
    if h and kh and h % kh:
        kh = round_up(kh, math.gcd(h, kh))  # keep grouping integral
        while h % kh:
            kh += plan.tp
    vocab = plan.pad_vocab(cfg.vocab_size)
    if cfg.family == "hybrid":
        group_layers = cfg.attn_every
    elif cfg.family == "vlm":
        group_layers = cfg.cross_attn_every
    else:
        group_layers = 1
    groups = cfg.n_layers // group_layers
    assert groups * group_layers == cfg.n_layers, (cfg.name, cfg.n_layers, group_layers)
    d_inner = cfg.ssm_expand * cfg.d_model if cfg.ssm_state else 0
    ssm_h = d_inner // cfg.ssm_head_dim if cfg.ssm_state else 0
    conv_dim = d_inner + 2 * cfg.ssm_state if cfg.ssm_state else 0   # x + B + C (n_groups=1)
    return ModelDims(
        h=h, kh=kh, hd=cfg.resolved_head_dim, vocab=vocab, d=cfg.d_model, f=cfg.d_ff,
        e=cfg.n_experts, groups=groups, group_layers=group_layers,
        ssm_h=ssm_h, ssm_p=cfg.ssm_head_dim, ssm_n=cfg.ssm_state, d_inner=d_inner,
        conv_dim=conv_dim, conv_w=cfg.ssm_conv, enc_layers=cfg.enc_layers,
    )


# ----------------------------------------------------------------------
# Spec builders (one sub-builder per sublayer kind)
# ----------------------------------------------------------------------
def _attn_specs(cfg: ArchConfig, dm: ModelDims, prefix: str, L: int, cross: bool = False) -> Dict[str, ParamSpec]:
    d, h, kh, hd = dm.d, dm.h, dm.kh, dm.hd
    dt = cfg.dtype
    lay = ("layer",) if L else ()
    Ls = (L,) if L else ()
    s: Dict[str, ParamSpec] = {
        f"{prefix}/wq": ParamSpec(Ls + (d, h * hd), lay + ("fsdp", "tp"), dtype=dt),
        f"{prefix}/wk": ParamSpec(Ls + (d, kh * hd), lay + ("fsdp", "tp"), dtype=dt),
        f"{prefix}/wv": ParamSpec(Ls + (d, kh * hd), lay + ("fsdp", "tp"), dtype=dt),
        f"{prefix}/wo": ParamSpec(Ls + (h * hd, d), lay + ("tp", "fsdp"), dtype=dt),
        f"{prefix}/norm": ParamSpec(Ls + (d,), lay + (None,), init="ones", dtype=dt),
    }
    if cfg.qkv_bias:
        s[f"{prefix}/bq"] = ParamSpec(Ls + (h * hd,), lay + ("tp",), init="zeros", dtype=dt)
        s[f"{prefix}/bk"] = ParamSpec(Ls + (kh * hd,), lay + ("tp",), init="zeros", dtype=dt)
        s[f"{prefix}/bv"] = ParamSpec(Ls + (kh * hd,), lay + ("tp",), init="zeros", dtype=dt)
    if cfg.norm == "layernorm":
        s[f"{prefix}/norm_b"] = ParamSpec(Ls + (d,), lay + (None,), init="zeros", dtype=dt)
    return s


def _mlp_specs(cfg: ArchConfig, dm: ModelDims, prefix: str, L: int) -> Dict[str, ParamSpec]:
    d, f, dt = dm.d, dm.f, cfg.dtype
    lay = ("layer",) if L else ()
    Ls = (L,) if L else ()
    s = {
        f"{prefix}/w_in": ParamSpec(Ls + (d, f), lay + ("fsdp", "tp"), dtype=dt),
        f"{prefix}/w_out": ParamSpec(Ls + (f, d), lay + ("tp", "fsdp"), dtype=dt),
        f"{prefix}/norm": ParamSpec(Ls + (d,), lay + (None,), init="ones", dtype=dt),
    }
    if cfg.mlp_act == "swiglu":
        s[f"{prefix}/w_gate"] = ParamSpec(Ls + (d, f), lay + ("fsdp", "tp"), dtype=dt)
    if cfg.norm == "layernorm":
        s[f"{prefix}/norm_b"] = ParamSpec(Ls + (d,), lay + (None,), init="zeros", dtype=dt)
    return s


def _moe_specs(cfg: ArchConfig, dm: ModelDims, prefix: str, L: int) -> Dict[str, ParamSpec]:
    d, f, e, dt = dm.d, dm.f, dm.e, cfg.dtype
    lay = ("layer",) if L else ()
    Ls = (L,) if L else ()
    s = {
        f"{prefix}/router": ParamSpec(Ls + (d, e), lay + ("fsdp", None), dtype=dt),
        f"{prefix}/w_in": ParamSpec(Ls + (e, d, f), lay + ("expert", "fsdp", "tp"), dtype=dt),
        f"{prefix}/w_gate": ParamSpec(Ls + (e, d, f), lay + ("expert", "fsdp", "tp"), dtype=dt),
        f"{prefix}/w_out": ParamSpec(Ls + (e, f, d), lay + ("expert", "tp", "fsdp"), dtype=dt),
        f"{prefix}/norm": ParamSpec(Ls + (d,), lay + (None,), init="ones", dtype=dt),
    }
    if cfg.norm == "layernorm":
        s[f"{prefix}/norm_b"] = ParamSpec(Ls + (d,), lay + (None,), init="zeros", dtype=dt)
    return s


def _ssm_specs(cfg: ArchConfig, dm: ModelDims, prefix: str, L: int) -> Dict[str, ParamSpec]:
    d, dt = dm.d, cfg.dtype
    di, n, H = dm.d_inner, dm.ssm_n, dm.ssm_h
    in_dim = 2 * di + 2 * n + H          # z, x, B, C, dt
    lay = ("layer",) if L else ()
    Ls = (L,) if L else ()
    return {
        f"{prefix}/w_in": ParamSpec(Ls + (d, in_dim), lay + ("fsdp", "tp"), dtype=dt),
        f"{prefix}/conv_w": ParamSpec(Ls + (dm.conv_w, dm.conv_dim), lay + (None, "tp"), dtype=dt),
        f"{prefix}/conv_b": ParamSpec(Ls + (dm.conv_dim,), lay + ("tp",), init="zeros", dtype=dt),
        f"{prefix}/a_log": ParamSpec(Ls + (H,), lay + ("tp",), init="ones", dtype="float32"),
        f"{prefix}/dt_bias": ParamSpec(Ls + (H,), lay + ("tp",), init="zeros", dtype="float32"),
        f"{prefix}/d_skip": ParamSpec(Ls + (H,), lay + ("tp",), init="ones", dtype="float32"),
        f"{prefix}/out_norm": ParamSpec(Ls + (di,), lay + ("tp",), init="ones", dtype=dt),
        f"{prefix}/w_out": ParamSpec(Ls + (di, d), lay + ("tp", "fsdp"), dtype=dt),
        f"{prefix}/norm": ParamSpec(Ls + (d,), lay + (None,), init="ones", dtype=dt),
    }


def build_param_specs(cfg: ArchConfig, plan: ShardPlan = ShardPlan()) -> Dict[str, ParamSpec]:
    dm = resolve_dims(cfg, plan)
    dt = cfg.dtype
    G = dm.groups
    s: Dict[str, ParamSpec] = {
        "embed": ParamSpec((dm.vocab, dm.d), ("vocab", "fsdp"), dtype=dt),
        "final_norm": ParamSpec((dm.d,), (None,), init="ones", dtype=dt),
    }
    if cfg.norm == "layernorm":
        s["final_norm_b"] = ParamSpec((dm.d,), (None,), init="zeros", dtype=dt)
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((dm.d, dm.vocab), ("fsdp", "vocab"), dtype=dt)

    fam = cfg.family
    if fam in ("dense", "moe"):
        s.update(_attn_specs(cfg, dm, "blocks/attn", G))
        if fam == "moe":
            s.update(_moe_specs(cfg, dm, "blocks/moe", G))
        else:
            s.update(_mlp_specs(cfg, dm, "blocks/mlp", G))
    elif fam == "ssm":
        s.update(_ssm_specs(cfg, dm, "blocks/ssm", G))
    elif fam == "hybrid":
        # group of `attn_every` layers: layer0 = attention, rest = mamba;
        # ffn alternates dense (even in-group idx) / moe (odd in-group idx)
        gl = dm.group_layers
        s.update(_attn_specs(cfg, dm, "blocks/attn", G))
        for j in range(1, gl):
            s.update(_ssm_specs(cfg, dm, f"blocks/ssm{j}", G))
        for j in range(gl):
            if cfg.n_experts and (j % cfg.moe_every == cfg.moe_every - 1):
                s.update(_moe_specs(cfg, dm, f"blocks/ffn{j}_moe", G))
            else:
                s.update(_mlp_specs(cfg, dm, f"blocks/ffn{j}", G))
    elif fam == "encdec":
        s.update(_attn_specs(cfg, dm, "enc_blocks/attn", dm.enc_layers))
        s.update(_mlp_specs(cfg, dm, "enc_blocks/mlp", dm.enc_layers))
        s.update(_attn_specs(cfg, dm, "blocks/attn", G))
        s.update(_attn_specs(cfg, dm, "blocks/cross", G, cross=True))
        s.update(_mlp_specs(cfg, dm, "blocks/mlp", G))
        s["enc_final_norm"] = ParamSpec((dm.d,), (None,), init="ones", dtype=dt)
        if cfg.norm == "layernorm":
            s["enc_final_norm_b"] = ParamSpec((dm.d,), (None,), init="zeros", dtype=dt)
        if cfg.frontend_dim and cfg.frontend_dim != dm.d:
            s["frontend_proj"] = ParamSpec((cfg.frontend_dim, dm.d), ("fsdp", None), dtype=dt)
    elif fam == "vlm":
        # group of `cross_attn_every` layers; layer0 additionally has image cross-attn
        gl = dm.group_layers
        s.update(_attn_specs(cfg, dm, "blocks/attn", G))
        s.update(_attn_specs(cfg, dm, "blocks/cross", G, cross=True))
        s.update(_mlp_specs(cfg, dm, "blocks/mlp", G))
        for j in range(1, gl):
            s.update(_attn_specs(cfg, dm, f"blocks/attn{j}", G))
            s.update(_mlp_specs(cfg, dm, f"blocks/mlp{j}", G))
        if cfg.frontend_dim and cfg.frontend_dim != dm.d:
            s["frontend_proj"] = ParamSpec((cfg.frontend_dim, dm.d), ("fsdp", None), dtype=dt)
    else:
        raise ValueError(fam)
    return s


# ----------------------------------------------------------------------
def unflatten(flat: Dict[str, object]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def init_params(cfg: ArchConfig, plan: ShardPlan, generator: torch.Generator,
                device) -> Dict:
    """The reference's init rules, drawn with ``generator`` (which lives on
    ``device``): ``zeros``, ``ones`` (``a_log`` = log 1..H), and normal over
    sqrt(fan_in) drawn in f32 and cast to the spec's dtype, leaf by leaf in
    sorted path order — a stacked leaf one group at a time, so the f32
    draft never holds more than one group's slice."""
    out = {}
    for path, spec in sorted(build_param_specs(cfg, plan).items()):
        dtype = DTYPES[spec.dtype]
        if spec.init == "zeros":
            v = torch.zeros(spec.shape, dtype=dtype, device=device)
        elif spec.init == "ones":
            if path.endswith("a_log"):           # A ~ -[1..]; store log
                v = torch.log(torch.arange(1, spec.shape[-1] + 1,
                                           dtype=torch.float32, device=device)
                              ).to(dtype).expand(spec.shape).contiguous()
            else:
                v = torch.ones(spec.shape, dtype=dtype, device=device)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            v = torch.empty(spec.shape, dtype=dtype, device=device)
            for part in (v if len(spec.shape) > 2 else (v,)):
                part.copy_(torch.randn(part.shape, generator=generator,
                                       device=device, dtype=torch.float32)
                           / math.sqrt(fan_in))
        out[path] = v
    return unflatten(out)


def numpy_params(cfg: ArchConfig, seed: int,
                 plan: ShardPlan = ShardPlan()) -> Iterator[Tuple[str, np.ndarray]]:
    """The same init rules drawn with numpy from ``seed``: ``(path, f32
    array)`` in sorted path order, one leaf at a time, so a host without the
    card (or the reference) can rebuild the same parameters.  Feed it to
    :func:`params_from_reference`."""
    rng = np.random.default_rng(seed)
    for path, spec in sorted(build_param_specs(cfg, plan).items()):
        if spec.init == "zeros":
            v = np.zeros(spec.shape, np.float32)
        elif spec.init == "ones":
            v = np.ones(spec.shape, np.float32)
            if path.endswith("a_log"):
                v = v * np.log(np.arange(1, spec.shape[-1] + 1, dtype=np.float32))
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            v = rng.standard_normal(spec.shape, np.float32) / np.float32(math.sqrt(fan_in))
        yield path, v


def params_from_reference(flat, cfg: ArchConfig, device,
                          plan: ShardPlan = ShardPlan()) -> Dict:
    """Carry parameters given as host arrays under the reference's
    '/'-joined paths (a mapping, or ``(path, array)`` pairs such as
    :func:`numpy_params` yields) into the port's tree on ``device``, each
    copied and cast to its spec's dtype.  Every path of the spec must be given once,
    with the spec's shape."""
    specs = build_param_specs(cfg, plan)
    items = flat.items() if isinstance(flat, Mapping) else flat
    out = {}
    for path, a in items:
        spec = specs.get(path)
        if spec is None or path in out:
            raise KeyError(f"params_from_reference: unexpected path {path!r}")
        # a copy: a train step updates the parameters in place, and the
        # reference's arrays are read-only
        a = np.array(a, np.float32)
        if a.shape != spec.shape:
            raise ValueError(f"params_from_reference: {path} has shape "
                             f"{a.shape}, the spec {spec.shape}")
        out[path] = torch.from_numpy(a).to(device=device,
                                           dtype=DTYPES[spec.dtype])
    missing = sorted(set(specs) - set(out))
    if missing:
        raise KeyError(f"params_from_reference: missing {missing}")
    return unflatten(out)


def param_shapes(cfg: ArchConfig, plan: ShardPlan) -> Dict:
    """The parameter tree as meta tensors of the specs' shapes and dtypes:
    no allocation (the dry-run's stand-ins)."""
    return unflatten({p: torch.empty(s.shape, dtype=DTYPES[s.dtype],
                                     device="meta")
                      for p, s in build_param_specs(cfg, plan).items()})


def logical_axes(cfg: ArchConfig, plan: ShardPlan) -> Dict:
    """The parameter tree's logical axis tuples, leaf for leaf."""
    specs = build_param_specs(cfg, plan)
    return unflatten({p: s.logical for p, s in specs.items()})


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    specs = build_param_specs(cfg, ShardPlan())
    total = 0
    for path, s in specs.items():
        n = int(np.prod(s.shape))
        if active_only and ("/moe" in path or "_moe" in path) and not path.endswith("router"):
            n = n * cfg.moe_top_k // max(cfg.n_experts, 1)
        total += n
    return total

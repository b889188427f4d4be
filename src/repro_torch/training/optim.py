"""Hand-written AdamW + schedules + global-norm clipping (the reference's
``repro.training.optim``; no ``torch.optim``).

AdamW computes per leaf in f32 and casts back to the leaf's and the
moment's dtypes, as the reference does (``torch.optim.AdamW`` does its
arithmetic in the parameter's dtype, which rounds bf16 leaves otherwise).
It writes the parameters and moments in place, as the reference's jitted
step does into its donated buffers, a slice of a large leaf at a time, so
its f32 temporaries stay small; the arithmetic is elementwise, so slicing
changes no bit.  Divisors are tensors on the leaves' device: on the card a
division by a Python scalar multiplies by its reciprocal."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.models.params import DTYPES
from repro_torch.training.tree import leaves, tree_map

#: elements per slice of a leaf that AdamW and the clip work on at once
#: (2^26 elements: 256 MB per f32 temporary)
SLICE = 1 << 26


def _slices(*ts):
    """Matching slices along dim 0 of same-shape tensors, each at most
    about SLICE elements (a 0-d tensor is one slice)."""
    t = ts[0]
    if t.ndim == 0 or t.numel() <= SLICE:
        yield ts
        return
    rows = max(1, SLICE // max(1, t.numel() // t.shape[0]))
    for i in range(0, t.shape[0], rows):
        yield tuple(x[i:i + rows] for x in ts)


def adamw_init(params, opt_dtype: str = "float32") -> Dict:
    dt = DTYPES[opt_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares, leaf by leaf in the reference's
    (sorted-key) order."""
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / |grads|), each in its dtype;
    the global norm).  Returns new tensors."""
    gn = global_norm(grads)
    scale = torch.clamp_max(
        torch.tensor(max_norm, dtype=torch.float32, device=gn.device)
        / torch.clamp_min(gn, 1e-9), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def adamw_update(params, grads, opt, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1) -> Tuple[Dict, Dict]:
    """One AdamW step; ``lr`` a 0-d f32 tensor (or a float).  Decoupled
    weight decay on every leaf with ndim >= 2 (group-stacked norm scales
    too, as the reference).  Updates ``params`` and the moments in place
    and returns (params, {"m", "v", "step"})."""
    step = opt["step"] + 1
    sf = step.float()
    bc1 = 1.0 - b1 ** sf
    bc2 = 1.0 - b2 ** sf
    if not isinstance(lr, torch.Tensor):
        lr = torch.tensor(lr, dtype=torch.float32, device=sf.device)

    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(opt["m"]), leaves(opt["v"])):
            decay = p.ndim >= 2     # decoupled weight decay on matrices only
            for ps, gs, ms, vs in _slices(p, g, m, v):
                gf = gs.float()
                mf = b1 * ms.float() + (1 - b1) * gf
                vf = b2 * vs.float() + (1 - b2) * gf * gf
                update = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
                if decay:
                    update = update + weight_decay * ps.float()
                ps.copy_(ps.float() - lr * update)
                ms.copy_(mf)
                vs.copy_(vf)
    return params, {"m": opt["m"], "v": opt["v"], "step": step}


def cosine_schedule(step, *, base_lr=3e-4, warmup=100, total=10000,
                    min_frac=0.1):
    """Linear warm-up from 0, then cosine decay to ``min_frac``; f32."""
    s = step.float()
    div = lambda n: torch.tensor(float(n), device=s.device)  # noqa: E731
    warm = s / div(max(warmup, 1))
    prog = torch.clamp((s - warmup) / div(max(total - warmup, 1)), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(s < warmup, warm, cos)

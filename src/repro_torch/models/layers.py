"""Stateless layer ops: norms, RoPE, MLPs, embedding, the LM head and the
cross entropy (the reference's ``repro.models.layers``).  Norms compute in
f32 and return the input's dtype; the head accumulates in f32 (the
reference's ``preferred_element_type``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm(x: torch.Tensor, p: Dict, kind: str, key: str = "norm") -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p[key], p[f"{key}_b"])
    return rmsnorm(x, p[key])


# ----------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    half layout: the first hd/2 lanes rotate against the last hd/2."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions.float()[..., None] * inv                        # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                              # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
def mlp(x: torch.Tensor, p: Dict, act: str) -> torch.Tensor:
    h = x @ p["w_in"]
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    return h @ p["w_out"]


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_logits(x: torch.Tensor, params: Dict, tie: bool) -> torch.Tensor:
    """(..., d) → (..., vocab) f32: the products of the head's dtype,
    summed in f32."""
    head = params["embed"].T if tie else params["lm_head"]
    return x.float() @ head.float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_real: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean NLL over the (possibly padded) vocab dim, in f32.  Padded
    columns are set to -1e30 (not -inf, so their gradient is exactly 0) and
    never win.  The gold logit is gathered, which is the reference's
    one-hot sum bit for bit (every other term of that sum is 0)."""
    v_pad = logits.shape[-1]
    logits = logits.float()
    if v_pad != vocab_real:
        pad_mask = torch.arange(v_pad, device=logits.device) >= vocab_real
        logits = torch.where(pad_mask, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)

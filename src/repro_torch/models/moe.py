"""Top-k routed MoE with sort-based (permutation) dispatch (the reference's
``repro.models.moe``, single-device path).

Tokens are routed to their top-k experts (ties to the lower expert index,
as ``lax.top_k``), stably sorted by expert, packed into an ``(E, C, D)``
buffer of per-expert capacity C (overflowing tokens go to a dump row that is
dropped), run through each expert's SwiGLU FFN, and scatter-added back
weighted by their renormalised gates.  The expert-parallel mesh path of the
reference waits for the training slice of the port.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import norm
from repro_torch.models.params import ModelDims


def _route(xt: torch.Tensor, router: torch.Tensor, k: int):
    logits = (xt @ router).float()                           # (T,E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower expert first on a tie
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :k], eidx[:, :k]                  # (T,k)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    # load-balance aux (Switch-style) + router z-loss
    e = router.shape[-1]
    me = probs.mean(dim=0)                                   # (E,)
    ce = F.one_hot(eidx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(me * ce) + 1e-3 * torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)))
    return gates, eidx, aux


def _capacity(t: int, k: int, e: int, cf: float) -> int:
    return max(1, int(math.ceil(t * k * cf / e)))


def _sort_dispatch(xt: torch.Tensor, eidx: torch.Tensor, e: int, c: int):
    t, k = eidx.shape
    d = xt.shape[-1]
    flat_e = eidx.reshape(-1)                                 # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    e_s = flat_e[order]
    tok_s = order // k
    counts = torch.zeros(e, dtype=flat_e.dtype, device=xt.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))     # bincount, without a host sync
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(t * k, device=xt.device) - starts[e_s]
    keep = pos < c
    slot = torch.where(keep, e_s * c + pos, e * c)            # overflow -> dump row
    buf = torch.zeros((e * c + 1, d), dtype=xt.dtype, device=xt.device)
    buf[slot] = xt[tok_s]
    return buf[:e * c].reshape(e, c, d), (tok_s, slot, keep, order)


def _combine(out_buf: torch.Tensor, meta, gates: torch.Tensor, t: int):
    tok_s, slot, keep, order = meta
    e_c, d = out_buf.shape[0] * out_buf.shape[1], out_buf.shape[-1]
    padded = torch.cat([out_buf.reshape(e_c, d),
                        out_buf.new_zeros((1, d))], dim=0)
    y_s = padded[slot] * gates.reshape(-1)[order][:, None].to(out_buf.dtype)
    return out_buf.new_zeros((t, d)).index_add_(0, tok_s, y_s)


def _expert_ffn(buf: torch.Tensor, w_in, w_gate, w_out) -> torch.Tensor:
    h = torch.einsum("ecd,edf->ecf", buf, w_in)
    g = torch.einsum("ecd,edf->ecf", buf, w_gate)
    h = F.silu(g) * h
    return torch.einsum("ecf,efd->ecd", h, w_out)


def _moe_local(xt, router, w_in, w_gate, w_out, k: int, cf: float):
    """The MoE body on one device: (T,D) tokens → ((T,D), aux loss)."""
    t = xt.shape[0]
    e = w_in.shape[0]
    gates, eidx, aux = _route(xt, router, k)
    c = _capacity(t, k, e, cf)
    buf, meta = _sort_dispatch(xt, eidx, e, c)
    out = _expert_ffn(buf, w_in, w_gate, w_out)
    return _combine(out, meta, gates, t), aux


def moe_ffn(x: torch.Tensor, p: Dict, cfg: ArchConfig, dm: ModelDims,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (y, aux_loss). Pre-norm applied here."""
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            "moe_ffn: the expert-parallel mesh path arrives with the training "
            "slice of the port; pass mesh=None (one device)")
    h = norm(x, p, cfg.norm)
    b, s, d = h.shape
    y, aux = _moe_local(h.reshape(b * s, d), p["router"], p["w_in"],
                        p["w_gate"], p["w_out"], cfg.moe_top_k,
                        cfg.capacity_factor)
    return y.reshape(b, s, d), aux

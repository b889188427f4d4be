"""Top-k routed MoE with sort-based (permutation) dispatch (the reference's
``repro.models.moe``).

Tokens are routed to their top-k experts (ties to the lower expert index,
as ``lax.top_k``), stably sorted by expert, packed into an ``(E, C, D)``
buffer of per-expert capacity C (overflowing tokens go to a dump row that is
dropped), run through each expert's SwiGLU FFN, and scatter-added back
weighted by their renormalised gates.

On a ``ShardMesh`` of S > 1 shards the tokens are split over the shards
(when S divides them; else every shard takes them all), and each shard
routes its own tokens with its own capacity:

* **EP** (``E % S == 0``): experts are split over the shards; each shard's
  ``(E, C, D)`` buffer goes through a tiled ``all_to_all`` to the experts'
  owners, which run their slice of the experts on ``(E/S, S·C, D)``, and
  the reverse exchange brings each shard its ``(E, C, D)`` back.
* **fallback**: the experts are replicated and each shard runs the whole
  MoE on its tokens.

The aux loss is averaged over the shards (the reference's ``pmean``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import norm
from repro_torch.models.params import ModelDims
from repro_torch.parallel.sharding import ShardMesh, all_to_all, on_device


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


def _moe_mesh(xt, p, k: int, cf: float, e: int, mesh: ShardMesh):
    """The reference's ``shard_map`` body over a one-axis mesh (module
    docstring): (T,D) tokens on the caller's device → ((T,D), aux)."""
    S, devs = mesh.size, mesh.devices
    t = xt.shape[0]
    split = t % S == 0
    toks = torch.chunk(xt, S) if split else [xt] * S
    ep = e % S == 0
    w = {n: p[n] for n in ("w_in", "w_gate", "w_out")}
    if not ep:
        ys, auxs = [], []
        for s, dev in enumerate(devs):
            with on_device(dev):
                y, a = _moe_local(toks[s].to(dev), p["router"].to(dev),
                                  *(w[n].to(dev) for n in w), k, cf)
            ys.append(y)
            auxs.append(a)
    else:
        bufs, metas, gates_l, auxs = [], [], [], []
        for s, dev in enumerate(devs):
            with on_device(dev):
                xs = toks[s].to(dev)
                gates, eidx, a = _route(xs, p["router"].to(dev), k)
                buf, meta = _sort_dispatch(xs, eidx, e,
                                           _capacity(xs.shape[0], k, e, cf))
            bufs.append(buf)
            metas.append(meta)
            gates_l.append(gates)
            auxs.append(a)
        # (E, C, D) per shard -> (E/S, S·C, D) at each expert owner
        owned = all_to_all(bufs, mesh, split_dim=0, concat_dim=1)
        outs = []
        for r, dev in enumerate(devs):
            with on_device(dev):
                outs.append(_expert_ffn(owned[r], *(
                    torch.chunk(w[n], S)[r].to(dev) for n in w)))
        back = all_to_all(outs, mesh, split_dim=1, concat_dim=0)
        ys = []
        for s, dev in enumerate(devs):
            with on_device(dev):
                ys.append(_combine(back[s], metas[s], gates_l[s],
                                   toks[s].shape[0]))
    aux = torch.stack([a.to(xt.device) for a in auxs]).mean()
    y = (torch.cat([y.to(xt.device) for y in ys]) if split
         else ys[0].to(xt.device))
    return y, aux


def moe_ffn(x: torch.Tensor, p: Dict, cfg: ArchConfig, dm: ModelDims,
            mesh: ShardMesh | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (y, aux_loss). Pre-norm applied here."""
    h = norm(x, p, cfg.norm)
    b, s, d = h.shape
    xt = h.reshape(b * s, d)
    if mesh is None or mesh.size == 1:
        y, aux = _moe_local(xt, p["router"], p["w_in"], p["w_gate"],
                            p["w_out"], cfg.moe_top_k, cfg.capacity_factor)
    else:
        y, aux = _moe_mesh(xt, p, cfg.moe_top_k, cfg.capacity_factor, dm.e,
                           mesh)
    return y.reshape(b, s, d), aux

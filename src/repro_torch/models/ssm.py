"""Mamba2 (SSD — state-space duality) block, chunked dual form (the
reference's ``repro.models.ssm``).

Training and prefill use the block-decomposed SSD algorithm (intra-chunk quadratic term
+ inter-chunk state recurrence, a loop over chunks); decode is a
single-step state update.  Layout follows the minimal-SSD reference:
``x:(B,S,H,P)  dt:(B,S,H)  A:(H)<0  Bm,Cm:(B,S,N)`` (n_groups = 1).  The
state and the scan's math are f32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import norm, rmsnorm
from repro_torch.models.params import ModelDims


def _chunk(x: torch.Tensor, q: int) -> torch.Tensor:
    b, s = x.shape[:2]
    return x.reshape(b, s // q, q, *x.shape[2:])


def ssd_chunked(x, dt, a, bm, cm, chunk: int = 128, dtype16: bool = False):
    """Returns y:(B,S,H,P) and final state:(B,H,P,N). f32 math.
    dtype16=True keeps the O(S·Q·H) intra-chunk decay / weight tensors
    (``seg``, ``L``, ``C·Bᵀ`` and their product) in bf16, as the
    reference's ``ssd_dtype="bfloat16"``; every sum stays f32 (bf16
    products are exact in f32)."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    xb, dtb = _chunk(x, q), _chunk(dt, q)
    bb, cb = _chunk(bm, q), _chunk(cm, q)
    nc = s // q
    wdt = torch.bfloat16 if dtype16 else torch.float32

    da = dtb * a                                        # (B,nc,Q,H)
    da_cs = torch.cumsum(da, dim=2)                     # (B,nc,Q,H)

    # ---- intra-chunk (diagonal blocks) ----
    # L[i,j] = exp(da_cs[i] - da_cs[j]) for i >= j else 0
    seg = (da_cs[:, :, :, None, :].to(wdt)
           - da_cs[:, :, None, :, :].to(wdt))                    # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # mask BEFORE exp: the i<j entries are large-positive and would overflow
    seg = torch.where(tri[None, None, :, :, None], seg, -torch.inf)
    l_mat = torch.exp(seg)
    cb_bt = torch.einsum("bcin,bcjn->bcij", cb.to(wdt).float(),
                         bb.to(wdt).float()).to(wdt)             # (B,nc,Q,Q)
    w = cb_bt[..., None] * l_mat * dtb[:, :, None, :, :].to(wdt)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", w.float(),
                          xb.to(wdt).float())

    # ---- per-chunk final states ----
    decay_tail = torch.exp(da_cs[:, :, -1:, :] - da_cs)          # (B,nc,Q,H)
    st = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bb, decay_tail * dtb, xb)

    # ---- inter-chunk recurrence ----
    chunk_decay = torch.exp(torch.sum(da, dim=2))                # (B,nc,H)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prevs = []
    for ci in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + st[:, ci]
    prev_states = torch.stack(prevs, dim=1)                      # (B,nc,H,P,N)

    # ---- off-diagonal contribution ----
    decay_in = torch.exp(da_cs)                                  # (B,nc,Q,H)
    y_off = torch.einsum("bcin,bcih,bchpn->bcihp", cb, decay_in, prev_states)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, state


def ssd_decode_step(state, x1, dt1, a, b1, c1):
    """state:(B,H,P,N); x1:(B,H,P); dt1:(B,H); b1,c1:(B,N). One token."""
    da = torch.exp(dt1 * a)                                      # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", x1 * dt1[..., None], b1)
    state = state * da[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, c1)
    return y, state


# ----------------------------------------------------------------------
def _conv_full(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv; xbc:(B,S,C), w:(W,C): out[t] = Σ_i
    xbc[t - W + 1 + i] · w[i] (zeros before the sequence), summed in f32."""
    width = w.shape[0]
    s = xbc.shape[1]
    xp = F.pad(xbc.float(), (0, 0, width - 1, 0))
    wf = w.to(xbc.dtype).float()
    out = sum(xp[:, i:i + s] * wf[i] for i in range(width))
    return out.to(xbc.dtype) + bias.to(xbc.dtype)


def _split_in(h: torch.Tensor, dm: ModelDims):
    di, H = dm.d_inner, dm.ssm_h
    z = h[..., :di]
    xbc = h[..., di:di + dm.conv_dim]
    dt = h[..., di + dm.conv_dim:]
    assert dt.shape[-1] == H
    return z, xbc, dt


def mamba_train(x: torch.Tensor, p: Dict, cfg: ArchConfig, dm: ModelDims,
                return_state: bool = False, opts: Optional[dict] = None):
    """Full-sequence Mamba2 sublayer (pre-norm; residual added by caller).
    With ``return_state`` also the decode state: (ssm state, conv tail)."""
    opts = opts or {}
    bsz, s, _ = x.shape
    h = norm(x, p, cfg.norm) @ p["w_in"]
    z, xbc, dt = _split_in(h, dm)
    xbc = F.silu(_conv_full(xbc, p["conv_w"], p["conv_b"]))
    xi = xbc[..., :dm.d_inner].reshape(bsz, s, dm.ssm_h, dm.ssm_p).float()
    bm = xbc[..., dm.d_inner:dm.d_inner + dm.ssm_n].float()
    cm = xbc[..., dm.d_inner + dm.ssm_n:].float()
    dtf = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    default_chunk = 256 if s >= 8192 else 128   # intra∝Q vs state-pass∝1/Q
    y, state = ssd_chunked(xi, dtf, a, bm, cm,
                           chunk=opts.get("ssm_chunk", default_chunk),
                           dtype16=opts.get("ssd_dtype", "") == "bfloat16")
    y = y + xi * p["d_skip"][:, None]
    y = y.reshape(bsz, s, dm.d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["out_norm"])
    out = y @ p["w_out"]
    if return_state:
        conv_tail = xbc_raw_tail(x, p, cfg, dm)
        return out, (state, conv_tail)
    return out


def xbc_raw_tail(x, p, cfg: ArchConfig, dm: ModelDims):
    """Last (conv_w - 1) pre-conv xBC activations — the decode conv state."""
    h = norm(x, p, cfg.norm) @ p["w_in"]
    _, xbc, _ = _split_in(h, dm)
    return xbc[:, -(dm.conv_w - 1):, :]


def mamba_decode(x1: torch.Tensor, p: Dict, cfg: ArchConfig, dm: ModelDims,
                 state: torch.Tensor, conv_state: torch.Tensor):
    """x1:(B,1,D); state:(B,H,P,N); conv_state:(B,W-1,conv_dim).
    Returns (out, new state, new conv state)."""
    bsz = x1.shape[0]
    h = norm(x1, p, cfg.norm) @ p["w_in"]
    z, xbc, dt = _split_in(h, dm)
    xbc1 = xbc[:, 0]                                             # (B,conv_dim)
    window = torch.cat([conv_state, xbc1[:, None, :]], dim=1)    # (B,W,C)
    # a product and a sum over W, not einsum: on the card einsum's bmm
    # hands back (B,C) batch-minor, and every (B,H,P,N) state update after
    # it would then stride across the batch
    conv_out = ((window.float() * p["conv_w"].float()).sum(dim=1)
                + p["conv_b"].float())
    xbc1 = F.silu(conv_out)
    xi = xbc1[:, :dm.d_inner].reshape(bsz, dm.ssm_h, dm.ssm_p)
    b1 = xbc1[:, dm.d_inner:dm.d_inner + dm.ssm_n]
    c1 = xbc1[:, dm.d_inner + dm.ssm_n:]
    dtf = F.softplus(dt[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y, state = ssd_decode_step(state, xi, dtf, a, b1, c1)
    y = y + xi * p["d_skip"][:, None]
    y = y.reshape(bsz, 1, dm.d_inner).to(x1.dtype)
    y = rmsnorm(y * F.silu(z), p["out_norm"])
    new_conv = window[:, 1:, :].to(conv_state.dtype)
    return y @ p["w_out"], state, new_conv

"""GQA attention (the reference's ``repro.models.attention``):
double-chunked online-softmax attention for training, prefill and the
encoder, a direct decode path over the cache, cross-attention.  Plain torch
ops, one code path for the CPU and the card: scores and accumulators are
f32 (the reference's ``preferred_element_type``), taken from inputs cast to
f32, so a product of two bf16 values is exact and only the order of the
sums can differ.  Under autograd each q chunk's pass is checkpointed, so
backward keeps one chunk's f32 score tiles at a time (XLA's
rematerialisation does the same for the reference)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import apply_rope, norm
from repro_torch.models.params import ModelDims

NEG = -1e30


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> Tuple[torch.Tensor, int]:
    s = x.shape[axis]
    pad = (-s) % mult
    if pad == 0:
        return x, s
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths), s


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_valid=None, q_chunk: int = 1024, kv_chunk: int = 1024,
                    unroll: bool = False,
                    block_skip: bool = False) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,Kh,hd) with H % Kh == 0.  Returns (B,Sq,H,hd).

    Double-chunked online-softmax attention: outer loop over q chunks, inner
    loop over kv chunks.  All masking (causal / sliding window / kv validity /
    padding) happens on the f32 score tile.  Query head h attends with kv
    head h // (H / Kh) (the reference's ``(Kh, G)`` grouping).

    A causal pass stops at the diagonal: a kv chunk past a q chunk's last
    row is all masked, and folding it in would leave the result as it is
    bit for bit (its probabilities are exactly 0 and its correction 1).
    With gradients on, each q chunk's pass is checkpointed: its tiles are
    recomputed in backward instead of kept (the same numbers).
    ``unroll`` and ``block_skip`` are the reference's dry-run analysis
    options; they are accepted and ignored."""
    del unroll, block_skip
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    scale = hd ** -0.5
    qc = min(q_chunk, max(Sq, 1))
    kc = min(kv_chunk, max(Skv, 1))

    qp, Sq0 = _pad_to(q, 1, qc)
    kp, Skv0 = _pad_to(k, 1, kc)
    vp, _ = _pad_to(v, 1, kc)
    nq, nk = qp.shape[1] // qc, kp.shape[1] // kc
    if kv_valid is None:
        kv_valid = Skv0

    dev = q.device
    qp = qp.reshape(B, nq, qc, Kh, G, hd).float()
    kp = kp.reshape(B, nk, kc, Kh, hd).float()
    vp = vp.reshape(B, nk, kc, Kh, hd)

    def q_block(qi, kp, vp, iq: int):
        iq_glob = q_offset + iq * qc + torch.arange(qc, device=dev)
        m = torch.full((B, Kh, G, qc), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Kh, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Kh, G, qc, hd), dtype=torch.float32, device=dev)
        for jk in range(nk):
            if causal and isinstance(q_offset, int) and \
                    jk * kc > q_offset + iq * qc + qc - 1:
                break
            kj, vj = kp[:, jk], vp[:, jk]
            jk_glob = jk * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqkgh,bjkh->bkgqj", qi, kj) * scale
            mask = (jk_glob[None, :] < kv_valid).expand(qc, kc)
            if causal:
                mask = mask & (jk_glob[None, :] <= iq_glob[:, None])
            if window:
                mask = mask & (jk_glob[None, :] > iq_glob[:, None] - window)
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqj,bjkh->bkgqh", p.to(vj.dtype).float(),
                              vj.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]        # (B,Kh,G,qc,hd)
        return out.permute(0, 3, 1, 2, 4).to(q.dtype)          # (B,qc,Kh,G,hd)

    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    outs = [checkpoint(q_block, qp[:, iq], kp, vp, iq, use_reentrant=False,
                       preserve_rng_state=False)
            if grad else q_block(qp[:, iq], kp, vp, iq) for iq in range(nq)]
    out = torch.stack(outs, dim=1).reshape(B, nq * qc, H, hd)
    return out[:, :Sq0]


def decode_attention(q1: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     cur_len, window: int = 0) -> torch.Tensor:
    """q1: (B,1,H,hd); k,v: (B,S,Kh,hd) cache. Attends to positions < cur_len
    (and, with a window, > cur_len - window)."""
    B, _, H, hd = q1.shape
    S, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    qg = q1.reshape(B, Kh, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * (hd ** -0.5)
    pos = torch.arange(S, device=q1.device)
    mask = pos < cur_len
    if window:
        mask = mask & (pos > cur_len - window)
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v.dtype).float(), v.float())
    return out.reshape(B, 1, H, hd).to(q1.dtype)


# ----------------------------------------------------------------------
def _qkv(x: torch.Tensor, p: Dict, cfg: ArchConfig, dm: ModelDims):
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = x.shape[0], x.shape[1]
    return (q.reshape(B, S, dm.h, dm.hd),
            k.reshape(B, S, dm.kh, dm.hd),
            v.reshape(B, S, dm.kh, dm.hd))


def self_attn_train(x: torch.Tensor, p: Dict, cfg: ArchConfig, dm: ModelDims,
                    positions: torch.Tensor, causal: bool = True,
                    opts: Optional[Dict] = None) -> torch.Tensor:
    """Full-sequence self-attention sublayer (pre-norm, residual added by
    caller); the encoder's, with ``causal=False``."""
    h = norm(x, p, cfg.norm)
    q, k, v = _qkv(h, p, cfg, dm)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window,
                        **(opts or {}))
    return o.reshape(*x.shape[:2], dm.h * dm.hd) @ p["wo"]


def self_attn_prefill(x, p, cfg: ArchConfig, dm: ModelDims, positions,
                      opts: Optional[Dict] = None):
    """Like train, but also returns (k, v) for the cache."""
    h = norm(x, p, cfg.norm)
    q, k, v = _qkv(h, p, cfg, dm)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                        **(opts or {}))
    return o.reshape(*x.shape[:2], dm.h * dm.hd) @ p["wo"], (k, v)


def self_attn_decode(x1, p, cfg: ArchConfig, dm: ModelDims, cache_k, cache_v,
                     cur_len: int):
    """x1: (B,1,D). cache_k/v: (B,S,Kh,hd), written at ``cur_len`` in place
    (the reference donates the cache). Returns (out, cache_k, cache_v)."""
    h = norm(x1, p, cfg.norm)
    q, k, v = _qkv(h, p, cfg, dm)
    if cfg.rope_theta:
        pos = torch.full((1, 1), cur_len, dtype=torch.int32, device=x1.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    cache_k[:, cur_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cur_len] = v[:, 0].to(cache_v.dtype)
    o = decode_attention(q, cache_k, cache_v, cur_len=cur_len + 1,
                         window=cfg.sliding_window)
    return o.reshape(x1.shape[0], 1, dm.h * dm.hd) @ p["wo"], cache_k, cache_v


# ----------------------------------------------------------------------
def cross_kv(memory: torch.Tensor, p: Dict, cfg: ArchConfig, dm: ModelDims):
    B, S = memory.shape[:2]
    k = (memory @ p["wk"]).reshape(B, S, dm.kh, dm.hd)
    v = (memory @ p["wv"]).reshape(B, S, dm.kh, dm.hd)
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(dm.kh, dm.hd)
        v = v + p["bv"].reshape(dm.kh, dm.hd)
    return k, v


def cross_attn(x, memory_kv, p, cfg: ArchConfig, dm: ModelDims,
               opts: Optional[Dict] = None):
    """Cross-attention sublayer: queries from x, K/V precomputed from memory."""
    k, v = memory_kv
    h = norm(x, p, cfg.norm)
    B, S = x.shape[:2]
    q = (h @ p["wq"]).reshape(B, S, dm.h, dm.hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(dm.h, dm.hd)
    o = flash_attention(q, k, v, causal=False, **(opts or {}))
    return o.reshape(B, S, dm.h * dm.hd) @ p["wo"]

"""The plain reference: range-filtered brute-force top-k, in PyTorch.

It imports nothing of the program.  It reads the raw corpus, attribute and
queries that ``data`` made and works out everything else itself: which rows
lie in each range (by the attribute's value), the exact top-k, and the exact
distance of any returned id (float64, in the difference form).

``topk_in_range(..., precision=, rerank=)`` is also the control of step 2
of the comparison: the reference computed in the nearest precision below the
one a configuration states.  ``"tf32"`` rounds the operands of the distance
product to TF32's 10-bit mantissa (what a float32 product on the tensor
cores does with TF32 on) and reports the distances it computed; ``"int4"``
scores against the corpus quantized to int4 with one symmetric scale per
dimension and, with ``rerank=R``, keeps its best R survivors and rescores
them exactly, as the program's int8 path does with int8 survivors.
"""
from __future__ import annotations

import numpy as np
import torch


def rank_window(attrs: np.ndarray, ranges: np.ndarray):
    """Inclusive rank interval [lo, hi] of each range over the sorted
    attribute (lo > hi when the range holds no row)."""
    s = np.sort(np.asarray(attrs, np.float32))
    r = np.asarray(ranges, np.float32)
    lo = np.searchsorted(s, r[:, 0], side="left")
    hi = np.searchsorted(s, r[:, 1], side="right") - 1
    return lo.astype(np.int64), hi.astype(np.int64)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest at TF32's 10 mantissa bits."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _int4(x: torch.Tensor) -> torch.Tensor:
    """The corpus through int4 (-7..7, one scale per dimension) and back."""
    scale = (x.abs().amax(0) / 7.0).clamp_min(1e-12)
    return (x / scale).round().clamp(-7, 7) * scale


def _product(fn):
    """Run fn with TF32 off for float32 products, as the reference states."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def topk_in_range(vectors: torch.Tensor, attrs: torch.Tensor,
                  queries: np.ndarray, ranges: np.ndarray, k: int, *,
                  precision: str = "f32", rerank: int = 0):
    """Top-k rows by squared L2 among those whose attribute lies in each
    query's inclusive range.  ``vectors`` (n, d) f32 and ``attrs`` (n,) on
    the device that computes.  Returns numpy (ids (Q, k) int64, -1 where a
    range holds fewer than k rows; dists (Q, k), +inf there).

    ``"f32"``: candidates by the expansion form in float32, then the exact
    float64 distance of the best 32 + k decides the order.  ``"tf32"`` /
    ``"int4"``: the control, in that precision throughout, or, with
    ``rerank`` > 0, its best ``rerank`` candidates rescored exactly."""
    if precision not in ("f32", "tf32", "int4"):
        raise ValueError(f"precision {precision!r}")
    dev = vectors.device
    n = vectors.shape[0]
    x = _int4(vectors) if precision == "int4" else vectors
    xn = (x * x).sum(1)
    xm = _round_tf32(x) if precision == "tf32" else x
    exact = precision == "f32" or rerank > 0
    kk = min(max(k + 32 if precision == "f32" else k, rerank), n)
    block = max(1, (1 << 28) // max(n, 1))
    out_i, out_d = [], []
    for s in range(0, len(queries), block):
        q = torch.as_tensor(np.asarray(queries[s:s + block], np.float32),
                            device=dev)
        r = torch.as_tensor(np.asarray(ranges[s:s + block], np.float32),
                            device=dev)
        qm = _round_tf32(q) if precision == "tf32" else q
        d = _product(lambda: (q * q).sum(1, keepdim=True) + xn[None, :]
                     - 2.0 * (qm @ xm.T))
        ok = (attrs[None, :] >= r[:, :1]) & (attrs[None, :] <= r[:, 1:2])
        d = torch.where(ok, d.clamp_min(0), torch.inf)
        dk, ik = torch.topk(d, kk, dim=1, largest=False)
        if exact:
            ex = _exact(vectors, q, ik)
            ex = torch.where(torch.isfinite(dk), ex, torch.inf)
            dk, o = torch.sort(ex, dim=1, stable=True)
            ik = ik.gather(1, o)
            dk, ik = dk[:, :k], ik[:, :k]
        ik = torch.where(torch.isfinite(dk), ik, -1)
        out_i.append(ik.cpu().numpy())
        out_d.append(dk.cpu().numpy())
    return (np.concatenate(out_i).astype(np.int64),
            np.concatenate(out_d).astype(np.float64))


def _exact(vectors: torch.Tensor, q: torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
    """float64 squared L2 of rows ``ids`` (Q, m) (clipped into the corpus)
    against ``q`` (Q, d)."""
    rows = vectors[ids.clamp(0, vectors.shape[0] - 1)].to(torch.float64)
    diff = rows - q.to(torch.float64)[:, None, :]
    return (diff * diff).sum(2)


def exact_dists(vectors: torch.Tensor, pool: np.ndarray, q_idx: np.ndarray,
                ids: np.ndarray) -> np.ndarray:
    """float64 squared L2 of each answer's ids (A, k) against its query,
    row ``q_idx`` (A,) of the query pool; ids outside the corpus read
    NaN."""
    a, k = ids.shape
    dev = vectors.device
    pool_t = torch.as_tensor(np.asarray(pool, np.float32), device=dev)
    out = np.empty((a, k), np.float64)
    block = max(1, (1 << 26) // max(k * vectors.shape[1], 1))
    for s in range(0, a, block):
        q = pool_t[torch.as_tensor(q_idx[s:s + block], device=dev)]
        i = torch.as_tensor(np.asarray(ids[s:s + block], np.int64),
                            device=dev)
        e = _exact(vectors, q, i)
        bad = (i < 0) | (i >= vectors.shape[0])
        out[s:s + block] = torch.where(bad, torch.nan, e).cpu().numpy()
    return out

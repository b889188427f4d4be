"""KNN substrate: exact blocked brute force (a float32 matmul on the
device) and NNDescent.

Distances are squared L2 throughout."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

INF = float("inf")
BLOCK = 512             # query rows per distance block: a 1M-column f32
                        # block is 2 GB


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na,d) × (Nb,d) -> (Na,Nb) squared L2 via ‖a‖² - 2a·b + ‖b‖²,
    clamped at 0 (IEEE f32: TF32 is off package-wide)."""
    an = torch.sum(a * a, dim=-1, keepdim=True)
    bn = torch.sum(b * b, dim=-1)
    d = (a @ b.T).mul_(-2.0).add_(an).add_(bn[None, :])   # an - 2ab + bn
    return d.clamp_min_(0.0)


def smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row k smallest of a wide (rows, N) matrix, ordered by the
    lexicographic key (dist, column) — ``lax.top_k``'s tie order.

    A full stable sort of 1M-column rows is too slow, so ``torch.topk``
    selects the k survivors and only those are sorted by (dist, column).
    The one place this can differ from the reference: ties straddling the
    k-th slot, where ``torch.topk`` may keep a higher column than
    ``lax.top_k`` would."""
    vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=False)
    o = torch.argsort(idx, dim=1)                     # columns are unique
    vals, idx = vals.gather(1, o), idx.gather(1, o)
    o = torch.argsort(vals, dim=1, stable=True)
    return vals.gather(1, o), idx.gather(1, o)


def exact_knn(vecs: torch.Tensor, k: int, row0: int = 0,
              row1: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN of rows [row0, row1) of ``vecs`` (default every row)
    against all of its rows (ids exclude self), on the tensor's device.
    Pads n to a block multiple internally with rows at 1e9, which never
    enter a real row's top-k.  When ``k >= n`` the top-k spills into the pad
    rows; those slots come back masked (id -1, distance +inf).  ``row0``
    must be a multiple of ``BLOCK``: every distance block then has the
    whole call's shape, so a row range is those rows of the whole call bit
    for bit (the sharded build's slabs).  Returns (dists (row1-row0, k)
    f32, ids (row1-row0, k) int64)."""
    n, dim = vecs.shape
    row1 = n if row1 is None else row1
    if row0 % BLOCK:
        raise ValueError(f"exact_knn: row0={row0} is not a multiple of "
                         f"{BLOCK}")
    block = BLOCK
    pad = (-n) % block
    v = vecs.float()
    if pad:
        v = torch.cat([v, torch.full((pad, dim), 1e9, dtype=torch.float32,
                                     device=v.device)])
    ds, ids = [], []
    rows = torch.arange(block, device=v.device)
    for lo in range(row0, row1, block):
        d = sq_dists(v[lo:lo + block], v)
        d[rows, lo + rows] = INF                      # exclude self
        dv, di = smallest_k(d, k)
        ds.append(dv)
        ids.append(di)
        del d
    d, i = torch.cat(ds)[:row1 - row0], torch.cat(ids)[:row1 - row0]
    oob = i >= n                     # pad-row ids: only reachable when k >= n
    return torch.where(oob, INF, d), torch.where(oob, -1, i)


# ----------------------------------------------------------------------
def _nndescent_dists(vecs: torch.Tensor, vn: torch.Tensor, ids: torch.Tensor,
                     block: int) -> torch.Tensor:
    """(n, c) candidate ids -> (n, c) squared L2 of each row to its
    candidates, per ``block`` rows: the reference's expansion
    (‖x_c‖² − 2 q·x_c) + ‖q‖², clamped at 0."""
    out = torch.empty(ids.shape, dtype=torch.float32, device=vecs.device)
    for lo in range(0, vecs.shape[0], block):
        rows = ids[lo:lo + block]                             # (b, c)
        q = vecs[lo:lo + block]                               # (b, d)
        dots = torch.einsum("bd,bcd->bc", q, vecs[rows])
        d = vn[rows] - 2.0 * dots + torch.sum(q * q, -1, keepdim=True)
        out[lo:lo + block] = d.clamp_min_(0.0)
    return out


def _nndescent_merge(ids_a, d_a, ids_b, d_b, k: int):
    """Union of two candidate lists per row, duplicates and self masked to
    +inf, then the k nearest.  Both sorts are stable, which is the order of
    the reference's ``argsort`` and of ``lax.top_k`` (ties toward the lower
    position)."""
    n = ids_a.shape[0]
    ids = torch.cat([ids_a, ids_b], dim=1)
    d = torch.cat([d_a, d_b], dim=1)
    o = torch.argsort(ids, dim=1, stable=True)
    ids_s, d_s = ids.gather(1, o), d.gather(1, o)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    self_m = ids_s == torch.arange(n, device=ids.device)[:, None]
    d_s = torch.where(dup | self_m, INF, d_s)
    o = torch.argsort(d_s, dim=1, stable=True)[:, :k]
    return ids_s.gather(1, o), d_s.gather(1, o)


def nndescent(vecs: torch.Tensor, k: int, iters: int = 6, seed: int = 0,
              block: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate KNN graph via fixed-iteration vectorized NNDescent, on
    the tensor's device: random initial lists drawn as the reference draws
    them (``np.random.default_rng(seed)``), then ``iters`` rounds of
    merging each row's neighbours-of-neighbours.  n is padded to a block
    multiple with rows at 1e9.  Returns (dists (n,k) f32, ids (n,k)
    int64)."""
    n, dim = vecs.shape
    pad = (-n) % block
    v = vecs.float()
    if pad:
        v = torch.cat([v, torch.full((pad, dim), 1e9, dtype=torch.float32,
                                     device=v.device)])
    rng = np.random.default_rng(seed)
    init = torch.as_tensor(rng.integers(0, n, (n + pad, k)).astype(np.int64),
                           device=v.device)
    vn = torch.sum(v * v, dim=-1)
    d0 = _nndescent_dists(v, vn, init, block)
    ids, d = _nndescent_merge(init, d0, init, d0, k)
    for _ in range(iters):
        non = ids[ids].reshape(n + pad, -1)                   # (n, k*k)
        ids, d = _nndescent_merge(ids, d, non,
                                  _nndescent_dists(v, vn, non, block), k)
    return d[:n], ids[:n]


def knn_recall(approx_ids: np.ndarray, exact_ids: np.ndarray) -> float:
    hits = sum(len(set(a) & set(e)) for a, e in zip(approx_ids, exact_ids))
    return hits / exact_ids.size

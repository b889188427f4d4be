"""KNN substrate: exact blocked brute force (a float32 matmul on the device).

Distances are squared L2 throughout.  NNDescent (``knn_method="nndescent"``
in the reference) arrives with the baselines slice."""
from __future__ import annotations

from typing import Tuple

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


def exact_knn(vecs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN of every row of ``vecs`` (ids exclude self), on the
    tensor's device.  Pads n to a block multiple internally with rows at
    1e9, which never enter a real row's top-k.  When ``k >= n`` the top-k
    spills into the pad rows; those slots come back masked (id -1,
    distance +inf).  Returns (dists (n,k) f32, ids (n,k) int64)."""
    n, dim = vecs.shape
    block = BLOCK
    pad = (-n) % block
    v = vecs.float()
    if pad:
        v = torch.cat([v, torch.full((pad, dim), 1e9, dtype=torch.float32,
                                     device=v.device)])
    ds, ids = [], []
    rows = torch.arange(block, device=v.device)
    for lo in range(0, n + pad, block):
        d = sq_dists(v[lo:lo + block], v)
        d[rows, lo + rows] = INF                      # exclude self
        dv, di = smallest_k(d, k)
        ds.append(dv)
        ids.append(di)
        del d
    d, i = torch.cat(ds)[:n], torch.cat(ids)[:n]
    oob = i >= n                     # pad-row ids: only reachable when k >= n
    return torch.where(oob, INF, d), torch.where(oob, -1, i)

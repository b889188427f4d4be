"""Synthetic ANN datasets, attribute generators, selectivity-controlled query
ranges (the paper's 2^-i protocol), and brute-force ground truth.

The generators are numpy from a seed, copied from the reference, so both
packages see bit-identical data; the ground truth runs on the device."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index.knn import smallest_k, sq_dists


def make_vectors(n: int, d: int, seed: int = 0, kind: str = "mixture",
                 n_clusters: int = 32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random((n, d)).astype(np.float32)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign] +
            rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def make_attrs(n: int, seed: int = 0, kind: str = "uniform") -> np.ndarray:
    rng = np.random.default_rng(seed + 7)
    if kind == "zipf":
        a = rng.zipf(1.5, n).astype(np.float32) + rng.random(n).astype(np.float32)
    elif kind == "normal":
        a = rng.standard_normal(n).astype(np.float32)
    else:
        a = rng.random(n).astype(np.float32)
    # enforce distinct values (paper's tie-break assumption)
    a = a + np.arange(n) * 1e-9
    return a.astype(np.float32)


def selectivity_ranges(attrs: np.ndarray, nq: int, frac: float,
                       seed: int = 0) -> np.ndarray:
    """Random attribute windows covering ~frac·n points each."""
    rng = np.random.default_rng(seed + 13)
    s = np.sort(attrs)
    n = len(s)
    w = max(1, int(round(frac * n)))
    lo_idx = rng.integers(0, n - w + 1, nq)
    out = np.stack([s[lo_idx], s[lo_idx + w - 1]], axis=1)
    return out.astype(np.float32)


def mixed_workload(attrs: np.ndarray, nq: int, seed: int = 0,
                   levels: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Paper Exp-1: query set split evenly over selectivities 2^0 .. 2^-(levels-1).
    Returns (ranges (nq,2), level index per query)."""
    per = max(nq // levels, 1)
    ranges, lvl = [], []
    for i in range(levels):
        r = selectivity_ranges(attrs, per, 2.0 ** (-i), seed=seed * levels + i)
        ranges.append(r)
        lvl.extend([i] * per)
    rem = nq - per * levels
    if rem > 0:          # top up with full-range queries so len == nq
        ranges.append(selectivity_ranges(attrs, rem, 1.0, seed=seed * levels - 1))
        lvl.extend([0] * rem)
    out = np.concatenate(ranges)[:nq]
    return out, np.asarray(lvl[:nq])


def _on(x, dev) -> torch.Tensor:
    """An array or tensor as float32 on ``dev`` (no copy if it is)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def ground_truth(vectors: np.ndarray, attrs: np.ndarray, queries: np.ndarray,
                 ranges: np.ndarray, k: int, device=None):
    """Exact range-filtered KNN (the pre-filter/linear-scan baseline), on
    ``device`` (default the card); ``vectors`` and ``attrs`` may be tensors
    already there.  Returns numpy (ids (Q,k), dists (Q,k)),
    ids -1 / dists +inf where a range holds fewer than k points."""
    dev = resolve_device(device)
    v, a = _on(vectors, dev), _on(attrs, dev)
    ids_out, d_out = [], []
    block = 256                   # queries per (block, n) distance matrix
    for i in range(0, len(queries), block):
        q = torch.as_tensor(np.asarray(queries[i:i + block], np.float32),
                            device=dev)
        r = torch.as_tensor(np.asarray(ranges[i:i + block], np.float32),
                            device=dev)
        d = sq_dists(q, v)
        ok = (a[None, :] >= r[:, :1]) & (a[None, :] <= r[:, 1:2])
        d = torch.where(ok, d, float("inf"))
        dk, ik = smallest_k(d, k)
        ids_out.append(torch.where(torch.isfinite(dk), ik, -1).cpu().numpy())
        d_out.append(dk.cpu().numpy())
    return (np.concatenate(ids_out).astype(np.int32),
            np.concatenate(d_out))


def recall_at_k(found: np.ndarray, gt: np.ndarray) -> float:
    """recall@k = |found ∩ gt| / |gt-valid| averaged over queries."""
    tot, hit = 0, 0
    for f, g in zip(found, gt):
        gs = set(int(x) for x in g if x >= 0)
        if not gs:
            continue
        hit += len(gs & set(int(x) for x in f if x >= 0))
        tot += len(gs)
    return hit / max(tot, 1)

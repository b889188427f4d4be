"""Algorithm 3 — entry-node generation.

The entry node for a rank interval [L, R] is argmin over the interval of
δ(v, centroid), answered in O(1) by a range-argmin sparse table.  The
centroid, its distances and the table are built on the host in numpy,
copied from the reference (so ``dist_c`` and ``rmq`` are bit-equal to it);
the query runs in torch on the device, or on the host for one interval
(``rmq_query_np``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def centroid_dists(vecs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    c = vecs.mean(axis=0)
    d = np.sum((vecs - c) ** 2, axis=1)
    return c, d.astype(np.float32)


def build_rmq(dist_c: np.ndarray) -> np.ndarray:
    """Sparse table of range-argmin ids: (LOG, n) int32."""
    n = len(dist_c)
    logn = max(1, int(np.floor(np.log2(max(n, 1)))) + 1)
    table = np.zeros((logn, n), np.int32)
    table[0] = np.arange(n)
    j = 1
    while (1 << j) <= n:
        span = 1 << (j - 1)
        a = table[j - 1, : n - 2 * span + 1]
        b = table[j - 1, span: n - span + 1]
        table[j, : n - 2 * span + 1] = np.where(dist_c[a] <= dist_c[b], a, b)
        # tail: clamp to previous level
        table[j, n - 2 * span + 1:] = table[j - 1, n - 2 * span + 1:]
        j += 1
    return table


def rmq_query_np(table: np.ndarray, dist_c: np.ndarray, lo, hi):
    """Host range-argmin for [lo, hi] (lo <= hi): an int for ints, an
    array for arrays of intervals."""
    ln = np.asarray(hi) - lo + 1
    j = np.floor(np.log2(ln)).astype(np.int64)
    a = table[j, lo]
    b = table[j, hi - (np.int64(1) << j) + 1]
    out = np.where(dist_c[a] <= dist_c[b], a, b)
    return int(out) if out.ndim == 0 else out


def rmq_query(table: torch.Tensor, dist_c: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """Vectorized O(1) range-argmin (entry node for [lo, hi]); the level is
    floor(log2(float32(len))), as in the reference's ``rmq_query_jax``."""
    lo = lo.long()
    hi = hi.long()
    ln = (hi - lo + 1).to(torch.float32)
    j = torch.floor(torch.log2(torch.clamp_min(ln, 1.0))).long()
    a = table[j, lo].long()
    b = table[j, hi - torch.bitwise_left_shift(torch.ones_like(j), j) + 1].long()
    return torch.where(dist_c[a] <= dist_c[b], a, b)

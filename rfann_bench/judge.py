"""The comparison that decides ``correct``, and the recall of a window.

Every answer the timed path returned is held to what the configuration
guarantees, against the reference:

* each returned id is a corpus row whose attribute lies in the query's
  range, and no id repeats within an answer;
* an answer holds min(k, rows in the range) ids;
* each returned distance is the exact squared L2 of its id (the f32 paths
  score in f32; the quantized paths rerank their survivors in f32);
* where the configuration lists ``topk_gap``: each answer the program routed
  to the exact scan holds the exact top-k of its range.

They fold into two numbers.  ``dist_gap``: the widest relative gap between a
returned distance and the reference's float64 distance of the same id, where
an id that breaks the first two rules reads a gap of 1 (as does a NaN or
infinite distance, and any gap above 1).  ``topk_gap``: over the
scan-routed answers, the widest relative excess of the answer's j-th
smallest exact distance over the reference's j-th (1 where an id is not a
row of the range), so a scan that chose its survivors in too low a
precision, or read part of a window, reads far above rounding.  ``PERF.md``
gives the readings the limits were set from.

``recall_at10`` is the end-to-end metric, not a check: the share of the
reference's exact range-filtered top-k that the answers hold.
"""
from __future__ import annotations

import numpy as np
import torch

from rfann_bench import reference


def gaps(vectors: torch.Tensor, attrs: np.ndarray, pool: np.ndarray,
         ranges: np.ndarray, gt_dists: np.ndarray, q_idx: np.ndarray,
         ids: np.ndarray, dists: np.ndarray):
    """Per answer (A,): (the largest distance gap, the top-k gap).
    ``gt_dists`` (pool, k) are the reference's exact top-k distances of each
    pool query, +inf past the rows its range holds."""
    ids = np.asarray(ids, np.int64)
    n = len(attrs)
    valid = (ids >= 0) & (ids < n)
    a = attrs[np.clip(ids, 0, n - 1)]
    r = ranges[q_idx]
    ok = valid & (a >= r[:, :1]) & (a <= r[:, 1:2])
    srt = np.sort(np.where(valid, ids, -1 - np.arange(ids.shape[1])), 1)
    dup = np.zeros_like(valid)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    repeat = dup.any(1)
    exact = reference.exact_dists(vectors, pool, q_idx, ids)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.abs(np.asarray(dists, np.float64) - exact) / np.maximum(
            exact, np.finfo(np.float32).tiny)
    g = np.where(np.isfinite(g), np.minimum(g, 1.0), 1.0)
    g = np.where(ok, g, np.where(ids < 0, 0.0, 1.0))
    want = gt_dists[q_idx]
    short = ok.sum(1) < np.isfinite(want).sum(1)
    dist_gap = np.where(short | repeat, 1.0, g.max(1))
    got = np.sort(np.where(ok, exact, np.inf), 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (got - want) / np.maximum(want, np.finfo(np.float32).tiny)
    t = np.where(np.isfinite(want), np.where(np.isfinite(t),
                                             np.clip(t, 0.0, 1.0), 1.0), 0.0)
    return dist_gap, t.max(1)


def recall(gt_ids: np.ndarray, q_idx: np.ndarray, ids: np.ndarray,
           block: int = 1 << 18) -> float:
    """|answer ∩ exact top-k| / |exact top-k| summed over the answers."""
    hit = tot = 0
    for s in range(0, len(q_idx), block):
        g = torch.as_tensor(gt_ids[q_idx[s:s + block]])
        f = torch.as_tensor(np.asarray(ids[s:s + block], np.int64))
        gv = g >= 0
        m = (g[:, :, None] == f[:, None, :]).any(2) & gv
        hit += int(m.sum())
        tot += int(gv.sum())
    return hit / max(tot, 1)

"""Resolve stage: rank-interval mapping, RMQ entry selection, and rank ->
original-id remapping.

Ids everywhere in the search path are attribute ranks over the sorted
corpus; raw attribute ranges enter here and leave as inclusive rank
intervals ``[lo, hi]`` (``lo > hi`` = empty).  Interval mapping and id
remapping run on the host (numpy, copied from the reference); entry
selection runs in torch on the index's device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.entry import rmq_query


def rank_interval(attrs_sorted: np.ndarray,
                  attr_ranges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host path: [a_l, a_r] (inclusive) -> rank interval [lo, hi] (inclusive).
    attrs_sorted: (n,) ascending; attr_ranges: (Q, 2)."""
    ar = np.asarray(attr_ranges, np.float32)
    lo = np.searchsorted(attrs_sorted, ar[:, 0], side="left")
    hi = np.searchsorted(attrs_sorted, ar[:, 1], side="right") - 1
    return lo.astype(np.int32), hi.astype(np.int32)


def select_entry(rmq: torch.Tensor, dist_c: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, n: int) -> torch.Tensor:
    """RMQ entry node(s) for [lo, hi]: argmin of centroid distance over the
    interval, with the empty/degenerate clipping every caller needs."""
    return rmq_query(rmq, dist_c, torch.clamp_max(lo, n - 1),
                     torch.clamp(hi, 0, n - 1))


def remap_ids(order: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Stitch stage, host path: attribute-rank ids -> original corpus ids
    (-1 padding preserved)."""
    ids = np.asarray(ids)
    return np.where(ids >= 0, np.asarray(order)[np.maximum(ids, 0)], -1)

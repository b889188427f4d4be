"""Resolve stage: rank-interval mapping, RMQ entry selection, and rank ->
original-id remapping.

Ids everywhere in the search path are attribute ranks over the sorted
corpus; raw attribute ranges enter here and leave as inclusive rank
intervals ``[lo, hi]`` (``lo > hi`` = empty).  Interval mapping and id
remapping run on the host (numpy, copied from the reference); entry
selection runs in torch on the index's device.  A sharded index clips each
global interval to a shard's rank slice (``clip_interval``; the mesh
path's per-shard bodies use the torch twins on the shard's device).
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


def clip_interval(lo: np.ndarray, hi: np.ndarray, rank0: int,
                  n_local: int) -> Tuple[np.ndarray, np.ndarray]:
    """Clip a *global* rank interval to the shard covering global ranks
    [rank0, rank0 + n_local); returns shard-local ranks (empty stays empty).
    Shards are contiguous slices of the sorted corpus, so this equals a
    per-shard ``searchsorted`` (Theorem 4.7 heredity at the resolve layer)."""
    slo = np.maximum(np.asarray(lo, np.int64) - rank0, 0)
    shi = np.minimum(np.asarray(hi, np.int64) - rank0, n_local - 1)
    return slo.astype(np.int32), shi.astype(np.int32)


def clip_interval_torch(lo: torch.Tensor, hi: torch.Tensor, rank0: int,
                        n_local: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``clip_interval`` on the device, for the mesh path's per-shard
    bodies (int32 in and out)."""
    slo = torch.clamp_min(lo.to(torch.int32) - rank0, 0)
    shi = torch.clamp_max(hi.to(torch.int32) - rank0, n_local - 1)
    return slo, shi


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


def remap_ids_torch(order: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``remap_ids`` on the device (the mesh path remaps before it merges)."""
    return torch.where(ids >= 0, order[ids.long().clamp_min(0)], -1)

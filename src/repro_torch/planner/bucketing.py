"""Power-of-two bucketing: a closed set of kernel shapes for dynamic range queries.

Every dynamic quantity that would otherwise leak into a kernel launch shape — slice
length, per-partition batch size, beam ``ef`` — is rounded up to a power of
two, so a mixed stream of queries collapses onto a small, closed set of
launch signatures: ``(bucket, padded_Q, k)`` for the scan kernel and
``(ef_bucket, padded_Q, k)`` for the beam.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.range_scan import window_rows  # noqa: F401  (re-export:
# the kernel owns the scanned-window contract; planner code imports it here)

ROW_TILE = 128          # scan-kernel row tile; window = bucket + one tile


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def bucket_for_len(length: int, *, min_bucket: int = 64,
                   max_bucket: int = 1 << 30) -> int:
    """Slice length -> scan bucket (pow2, clamped)."""
    return int(min(max(next_pow2(max(int(length), 1)), min_bucket), max_bucket))


def ef_bucket(length: int, k: int, ef: int) -> int:
    """Selectivity-scaled beam width: ``ef`` beyond the number of in-range
    nodes is pure waste (the candidate pool only ever holds in-range nodes),
    so cap at next_pow2(len); floor at k; quantize to pow2."""
    cap = next_pow2(max(int(length), 1))
    return int(max(min(next_pow2(ef), cap), next_pow2(k)))


def pad_pow2(count: int, *, floor: int = 8) -> int:
    """Padded per-partition batch size (bounded set of compiled shapes)."""
    return max(next_pow2(max(count, 1)), floor)


def buckets_np(lens: np.ndarray, *, min_bucket: int = 64,
               max_bucket: int = 1 << 30) -> np.ndarray:
    """Vectorized bucket_for_len."""
    ln = np.maximum(lens.astype(np.int64), 1)
    b = 1 << np.ceil(np.log2(ln)).astype(np.int64)
    return np.clip(b, min_bucket, max_bucket).astype(np.int64)


def next_pow2_np(x: np.ndarray) -> np.ndarray:
    """Vectorized next_pow2 (floor 1, like the scalar)."""
    ln = np.maximum(np.asarray(x, np.int64), 1)
    return (1 << np.ceil(np.log2(ln)).astype(np.int64)).astype(np.int64)


def ef_bucket_np(lens: np.ndarray, k: int, ef: int) -> np.ndarray:
    """Vectorized ef_bucket (same cap/floor/quantize contract)."""
    cap = next_pow2_np(lens)
    return np.maximum(np.minimum(next_pow2(int(ef)), cap),
                      next_pow2(int(k))).astype(np.int64)


def window_rows_np(buckets: np.ndarray, tb: int = ROW_TILE) -> np.ndarray:
    """Vectorized window_rows (kernel-owned contract: ceil(b/tb)+1 blocks)."""
    b = np.asarray(buckets, np.int64)
    return ((-(-b // tb) + 1) * tb).astype(np.int64)

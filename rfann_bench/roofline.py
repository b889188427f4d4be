"""Peaks of the card and the least time of the range scan's work.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, 700 W): 3.35 TB/s
of HBM3, 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s bf16 and
1,979 TOP/s int8 on them.

The scan's work is counted from the queries' rank windows and the shapes
alone, never from how a kernel tiles or buckets them, so the count reads
the same whatever implements the scan.  Per search call, the least time is
the larger of

* bytes over the HBM peak: every row of the union of the scan-routed
  queries' windows read once, in the corpus' precision (its d-wide scale
  once, for int8), each query read once, and k (id, distance) pairs of
  4 + 4 bytes written per query;
* operations over the highest peak the operand type allows: 2 per element
  of every (query, row in its window) pair, the multiply-add of the
  expansion form's dot product (row norms can be made once, ahead).
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
BYTES_PER_ELEMENT = {"f32": 4, "bf16": 2, "int8": 1}


def union_rows(lo: np.ndarray, hi: np.ndarray) -> int:
    """Rows covered by the union of inclusive intervals [lo, hi]."""
    keep = hi >= lo
    lo, hi = np.asarray(lo)[keep], np.asarray(hi)[keep]
    if not len(lo):
        return 0
    o = np.argsort(lo, kind="stable")
    lo, hi = lo[o].astype(np.int64), hi[o].astype(np.int64)
    reach = np.maximum.accumulate(hi)
    # an interval starts a new run when it begins past every earlier end
    start = np.ones(len(lo), bool)
    start[1:] = lo[1:] > reach[:-1] + 1
    run = np.cumsum(start) - 1
    first = lo[start]
    last = np.zeros(run[-1] + 1, np.int64)
    np.maximum.at(last, run, hi)
    return int((last - first + 1).sum())


def scan_bytes(lo, hi, d: int, k: int, precision: str) -> int:
    """Least bytes of one call's scan: union rows, queries, outputs."""
    q = int(np.sum(np.asarray(hi) >= np.asarray(lo)))
    rows = union_rows(np.asarray(lo), np.asarray(hi)) * d * \
        BYTES_PER_ELEMENT[precision]
    scale = 4 * d if precision == "int8" else 0
    return rows + scale + q * d * 4 + q * k * 8


def scan_ops(lo, hi, d: int) -> int:
    """Operations of one call's scan: 2 per element of each pair."""
    w = np.clip(np.asarray(hi, np.int64) - np.asarray(lo, np.int64) + 1,
                0, None)
    return int(2 * d * w.sum())


def scan_least_s(lo, hi, d: int, k: int, precision: str):
    """(least seconds, "bytes" or "operations": which bound it)."""
    tb = scan_bytes(lo, hi, d, k, precision) / HBM_BYTES_PER_S
    to = scan_ops(lo, hi, d) / PEAK_OPS_PER_S[precision]
    return (tb, "bytes") if tb >= to else (to, "operations")

"""Shared benchmark harness of the PyTorch port: datasets, method registry,
timing, CSV and JSON output.

The counterpart of ``benchmarks/common.py`` over ``repro_torch``: the same
datasets (numpy from a seed), workloads, methods and metrics, with every
index built and searched on one ``device`` (default the card).  It imports
neither ``jax`` nor ``repro``, so it runs where only PyTorch is installed.
Tables land in ``results/bench_torch/``; the JSON summaries there as
``BENCH_pt_<stem>.json``."""
from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.rfann import RNSGIndex
from repro_torch.data.ann import (ground_truth, make_attrs, make_vectors,
                                  mixed_workload, selectivity_ranges)
from repro_torch.index.baselines import (BruteForceIndex, MRNGIndex,
                                         SegmentTreeIndex)

ROOT = Path(__file__).resolve().parent.parent
RESULTS = ROOT / "results" / "bench_torch"


def recall_at_k(found: np.ndarray, gt: np.ndarray, *,
                gt_dists: Optional[np.ndarray] = None,
                found_dists: Optional[np.ndarray] = None,
                eps: float = 1e-5) -> float:
    """recall@k = |found ∩ gt| / |gt-valid|, micro-averaged over queries.

    The canonical benchmark/acceptance metric, with two edge rules every
    caller needs:

    * ``k > |interval|`` — ground-truth rows are ``-1``-padded when the rank
      slice holds fewer than k points; the denominator is the count of
      *valid* gt entries per row (fully-empty rows are skipped entirely), so
      an exact method scores 1.0 on sub-k slices instead of being penalized
      for ids that do not exist.
    * tie handling — when both ``gt_dists`` and ``found_dists`` are given, a
      found id outside the gt id set still counts as a hit if its distance
      is within ``eps`` of the row's worst valid gt distance: equidistant
      points at the k-th boundary are interchangeable, and a different
      tie-break order must not read as recall loss.  Per-row hits stay
      capped at the valid-gt count so recall never exceeds 1.0.
    """
    found = np.asarray(found)
    gt = np.asarray(gt)
    tot, hit = 0, 0
    for i in range(len(gt)):
        gs = {int(x) for x in gt[i] if x >= 0}
        if not gs:
            continue
        fs = [int(x) for x in found[i] if x >= 0]
        row_hit = len(gs & set(fs))
        if gt_dists is not None and found_dists is not None:
            kth = max(float(d) for d, g in zip(gt_dists[i], gt[i]) if g >= 0)
            row_hit += sum(
                1 for j, x in enumerate(found[i])
                if x >= 0 and int(x) not in gs
                and float(found_dists[i][j]) <= kth + eps)
            row_hit = min(row_hit, len(gs))
        hit += row_hit
        tot += len(gs)
    return hit / max(tot, 1)


def emit_bench_json(stem: str, summary: dict) -> Path:
    """Write a machine-readable ``BENCH_pt_<stem>.json`` summary under
    results/bench_torch/."""
    RESULTS.mkdir(parents=True, exist_ok=True)
    path = RESULTS / f"BENCH_pt_{stem}.json"
    path.write_text(json.dumps(summary, indent=2, sort_keys=True) + "\n")
    return path


def dataset(n: int, d: int, seed: int = 0):
    vecs = make_vectors(n, d, seed=seed)
    attrs = make_attrs(n, seed=seed)
    return vecs, attrs


def gt_for(vecs, attrs, queries, ranges, k, device=None):
    order = np.argsort(attrs, kind="stable")
    gt_r, _ = ground_truth(vecs[order], attrs[order], queries, ranges, k,
                           device=device)
    return np.where(gt_r >= 0, order[np.maximum(gt_r, 0)], -1)


def workloads(attrs, nq: int, seed: int = 1) -> Dict[str, np.ndarray]:
    """The paper's protocol: mixed 2^0..2^-9 plus fixed 1% / 10% / 25%."""
    mixed, _ = mixed_workload(attrs, nq, seed=seed)
    return {
        "mixed": mixed,
        "sel_1pct": selectivity_ranges(attrs, nq, 0.01, seed=seed + 1),
        "sel_10pct": selectivity_ranges(attrs, nq, 0.10, seed=seed + 2),
        "sel_25pct": selectivity_ranges(attrs, nq, 0.25, seed=seed + 3),
    }


def method_builders(quick: bool = True,
                    device=None) -> Dict[str, Callable]:
    """Each method's constructor, ``(vecs, attrs) -> index``, by name."""
    # paper-proportionate parameters (the paper uses m=150..300,
    # ef_attribute ≈ 5..30× m at n=1M; scaled to CPU-sized n)
    m = 24 if quick else 48
    return {
        "rnsg": lambda v, a: RNSGIndex.build(
            v, a, m=m, ef_spatial=m, ef_attribute=2 * m, device=device),
        "mrng-infilter": lambda v, a: MRNGIndex(
            v, a, m=m, ef_spatial=2 * m, mode="infilter", device=device),
        "mrng-postfilter": lambda v, a: MRNGIndex(
            v, a, m=m, ef_spatial=2 * m, mode="postfilter", device=device),
        "segtree": lambda v, a: SegmentTreeIndex(
            v, a, m=m, ef_spatial=2 * m, device=device),
        "brute": lambda v, a: BruteForceIndex(v, a, device=device),
    }


def build_methods(vecs, attrs, quick: bool = True,
                  device=None) -> Dict[str, object]:
    return {name: make(vecs, attrs)
            for name, make in method_builders(quick, device).items()}


def build_seconds(ix) -> float:
    if hasattr(ix, "g"):
        return ix.g.build_seconds
    return getattr(ix, "build_seconds", 0.0)


def timed_search(ix, qv, ranges, k, ef, repeats: int = 2, warmups: int = 1,
                 **search_kw):
    """Best-of-``repeats`` QPS after ``warmups`` calls.  Every search
    returns host arrays, so each timed call ends after the device's work."""
    for _ in range(max(warmups, 1)):             # planner paths may
        ix.search(qv, ranges, k=k, ef=ef, **search_kw)   # recalibrate
    best = np.inf
    out = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = ix.search(qv, ranges, k=k, ef=ef, **search_kw)
        best = min(best, time.perf_counter() - t0)
    return out, len(qv) / best


def emit(name: str, rows: List[Dict], quiet: bool = False):
    RESULTS.mkdir(parents=True, exist_ok=True)
    path = RESULTS / f"{name}.csv"
    if rows:
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    if not quiet:
        for r in rows:
            print(",".join(str(v) for v in r.values()))
    return path

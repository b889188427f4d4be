"""Selectivity-aware query planner: route each range query to the cheapest
correct strategy.

Given a batch of rank intervals ``[L, R]`` (ranks are free — the index
already computes them), the planner estimates per-query selectivity
``(R−L+1)/n``, prices the two strategies with the online-calibrated
``CostModel``, and partitions the batch:

* ``scan``  — exact fused brute-force over the contiguous rank slice
              (narrow ranges; always used for empty/degenerate intervals),
* ``beam``  — graph beam search with a selectivity-scaled ``ef``
              (wide ranges, where traversal touches a small fraction of the
              slice).

Each partition carries a pow2 bucket signature so the executor dispatches it
as one fixed-shape kernel launch regardless of batch mix.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from repro_torch.planner.bucketing import (buckets_np, bucket_for_len,
                                           ef_bucket, ef_bucket_np,
                                           next_pow2, pad_pow2, window_rows,
                                           window_rows_np)
from repro_torch.planner.cost import CostModel

SCAN, BEAM = 0, 1


@dataclass
class Partition:
    kind: str                 # "scan" | "beam"
    param: int                # scan: bucket; beam: ef
    indices: np.ndarray       # positions in the request batch
    pad_q: int                # padded batch size for this dispatch

    @property
    def signature(self) -> Tuple[str, int, int]:
        return (self.kind, self.param, self.pad_q)


@dataclass
class Plan:
    strategy: np.ndarray                  # (Q,) int8: 0 scan / 1 beam
    partitions: List[Partition] = field(default_factory=list)

    @property
    def scan_frac(self) -> float:
        return float((self.strategy == SCAN).mean()) if len(self.strategy) else 0.0


class QueryPlanner:
    def __init__(self, n: int, mean_degree: float, *,
                 min_bucket: int = 64, max_scan_frac: float = 0.125,
                 scan_unit: float = 0.125, decay: float = 0.9):
        self.n = int(n)
        self.cost = CostModel(mean_degree, scan_unit=scan_unit, decay=decay)
        self.min_bucket = int(min_bucket)
        # hard selectivity ceiling for the scan strategy: above this fraction
        # the slice no longer fits the "few hundred candidates" regime and the
        # graph's sublinear traversal wins asymptotically
        self.max_scan_len = max(self.min_bucket,
                                int(max_scan_frac * self.n))
        self.max_bucket = next_pow2(self.n)
        # bumped by save_calibration: fences auto-routed cache entries (a
        # persisted calibration change may route a repeat query differently,
        # so SearchCache expires auto rows stored under an older epoch)
        self.calibration_epoch = 0

    # ----------------------------------------------------- routing decision
    def choose_strategy(self, length: int, *, k: int, ef: int,
                        beam_width: int = 1, precision: str = "f32") -> int:
        """Per-query cost-based routing for one rank-interval length.

        Scalar reference semantics for ``choose_strategy_batch`` (the unit
        tests hold the two in lockstep): empty and ``len ≤ k`` slices always
        scan (exact and ~free), slices above the selectivity ceiling always
        beam, and in between the calibrated cost model decides —
        ``beam_width`` selects which batched-expansion regime prices the
        beam side."""
        ln = int(length)
        if ln <= 0 or ln <= k:
            return SCAN
        if ln > self.max_scan_len:
            return BEAM
        bucket = bucket_for_len(ln, min_bucket=self.min_bucket,
                                max_bucket=self.max_bucket)
        scan_cost = self.cost.predict_scan_units(window_rows(bucket),
                                                 precision=precision)
        beam_cost = self.cost.predict_beam_units(ef_bucket(ln, k, ef),
                                                 beam_width,
                                                 precision=precision)
        return SCAN if scan_cost <= beam_cost else BEAM

    def predict_costs(self, lens: np.ndarray, *, k: int, ef: int,
                      beam_width: int = 1, precision: str = "f32"
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(Q,) lengths -> per-query (scan_cost, beam_cost) in beam distance
        units, from the current calibrated model.  This is the exact pricing
        ``choose_strategy_batch`` routes on — also recorded into the plan
        span of traced requests so "what did the planner see?" is
        answerable after the fact."""
        lens = np.asarray(lens, np.int64)
        buckets = buckets_np(lens, min_bucket=self.min_bucket,
                             max_bucket=self.max_bucket)
        scan_cost = (self.cost.predict_scan_units(1, precision=precision) *
                     window_rows_np(buckets).astype(np.float64))
        beam_cost = (self.cost.beam_unit *
                     self.cost.ndist_per_ef_at(beam_width) *
                     self.cost.precision_factor("beam", precision) *
                     ef_bucket_np(lens, k, ef).astype(np.float64))
        return scan_cost, beam_cost

    def choose_strategy_batch(self, lens: np.ndarray, *, k: int, ef: int,
                              beam_width: int = 1,
                              precision: str = "f32") -> np.ndarray:
        """Vectorized ``choose_strategy``: (Q,) lengths -> (Q,) int8 strategy
        vector (``SCAN``/``BEAM``).  Pure numpy over the whole batch — this
        is the host-side half of mesh dispatch, where the strategy vector is
        computed once and passed into ``shard_map`` as a replicated operand."""
        lens = np.asarray(lens, np.int64)
        scan_cost, beam_cost = self.predict_costs(lens, k=k, ef=ef,
                                                  beam_width=beam_width,
                                                  precision=precision)
        eligible = lens <= self.max_scan_len
        use_scan = (eligible & (scan_cost <= beam_cost)) | (lens <= 0) \
            | (lens <= k)                  # tiny slices: scan is exact & free
        return np.where(use_scan, SCAN, BEAM).astype(np.int8)

    # ------------------------------------------------------------------
    def plan_batch(self, lo: np.ndarray, hi: np.ndarray, *, k: int, ef: int,
                   mode: str = "auto", beam_width: int = 1,
                   precision: str = "f32") -> Plan:
        """lo/hi: (Q,) int rank intervals (inclusive; lo > hi = empty).
        mode: "auto" (cost-based) | "scan" | "beam" (forced)."""
        lo = np.asarray(lo, np.int64)
        hi = np.asarray(hi, np.int64)
        q = len(lo)
        lens = np.clip(hi - lo + 1, 0, None)
        buckets = buckets_np(lens, min_bucket=self.min_bucket,
                             max_bucket=self.max_bucket)
        if mode == "scan":
            use_scan = np.ones(q, bool)
        elif mode == "beam":
            use_scan = lens <= 0           # beam cannot express empty ranges
        else:
            use_scan = self.choose_strategy_batch(
                lens, k=k, ef=ef, beam_width=beam_width,
                precision=precision) == SCAN
        strategy = np.where(use_scan, SCAN, BEAM).astype(np.int8)

        partitions: List[Partition] = []
        scan_idx = np.flatnonzero(use_scan)
        for b in np.unique(buckets[scan_idx]) if len(scan_idx) else []:
            idx = scan_idx[buckets[scan_idx] == b]
            partitions.append(Partition("scan", int(b), idx,
                                        pad_pow2(len(idx))))
        beam_idx = np.flatnonzero(~use_scan)
        if len(beam_idx):
            efs = np.asarray([ef_bucket(int(lens[i]), k, ef)
                              for i in beam_idx], np.int64)
            for e in np.unique(efs):
                idx = beam_idx[efs == e]
                partitions.append(Partition("beam", int(e), idx,
                                            pad_pow2(len(idx))))
        # a plan never carries an empty partition (beam dispatch pads by
        # duplicating idx[-1], which needs at least one real query)
        return Plan(strategy=strategy,
                    partitions=[p for p in partitions if len(p.indices)])

    # ------------------------------------------------------------------
    def save_calibration(self, path: str) -> None:
        """Persist the online-calibrated cost model (JSON) so a restarted
        server starts from steady-state routing instead of the prior.

        Atomic: the state is written to a sibling temp file, fsynced, and
        renamed over ``path`` — a crash mid-shutdown can never leave a
        truncated file for the next startup's ``load_calibration`` — and
        the parent directory is fsynced after the rename so the rename
        itself is durable (``repro_torch.index.io.fsync_dir``)."""
        from repro_torch.index.io import fsync_dir
        state = dict(version=1, n=self.n, cost=self.cost.state_dict())
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(state, f, indent=2, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")
            # persisted calibration is the fence auto-routed cache rows were
            # stored under; bump so stale routing decisions expire on lookup
            self.calibration_epoch += 1
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def load_calibration(self, path: str) -> None:
        """Raises ValueError on a schema or corpus mismatch — calibration
        units are only meaningful for the index they were measured on."""
        with open(path) as f:
            state = json.load(f)
        if state.get("version") != 1:
            raise ValueError(f"unsupported calibration version "
                             f"{state.get('version')!r} in {path}")
        if state.get("n") != self.n:
            raise ValueError(f"calibration in {path} was measured on a "
                             f"corpus of n={state.get('n')}, this index has "
                             f"n={self.n}")
        self.cost.load_state_dict(state["cost"])

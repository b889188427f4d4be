"""Online-calibrated cost model: fused range scan vs graph beam search.

Costs are expressed in *beam distance units* (one gather-expanded neighbor
distance ≡ 1).  A row scanned inside the fused ``range_scan`` kernel is much
cheaper — it is one row of the fused range_scan kernel's streaming pass rather than a dependent
gather inside a sequential ``while_loop`` — so it is weighted by
``scan_unit`` < 1.

Two quantities are calibrated online:

* ``ndist_per_ef`` — predicted beam distance evaluations per unit of ``ef``,
  an EMA over the ``ndist`` stats every beam batch already returns (prior:
  the graph's mean out-degree, i.e. ndist ≈ ef · m̄).  Calibrated **per
  beam width**: the batched-expansion path (``beam_width > 1``) explores a
  slightly different frontier (speculative multi-node hops plus lossy-
  visited re-scores), so each width keeps its own EMA and unseen widths
  fall back to the nearest calibrated one.
* ``scan_unit`` — refined from observed per-unit wall times of executed scan
  and beam partitions (warm calls only; the executor skips the first call of
  each dispatch signature so kernel build and warm-up time never
  poison the estimate).

Per-precision pricing: quantized corpora (int8/bf16) move fewer bytes per
scored row, so scan and beam units are cheaper under them.  Wall-time EMAs
are kept **per precision** (``{"f32": ..., "int8": ...}``); the predicted
cost of a precision is the f32 cost times a factor — the measured
``us[precision] / us["f32"]`` ratio once both are observed, else a static
bandwidth-derived prior (``PRECISION_PRIOR``).  The routing decision thus
shifts toward scan under quantization exactly as fast as the hardware
actually delivers the bandwidth win.
"""
from __future__ import annotations

from typing import Dict, Optional

#: prior per-unit cost relative to f32, before any wall observation of that
#: precision lands.  int8 moves 4× fewer bytes (≈0.25) plus rerank overhead;
#: bf16 moves 2× fewer (≈0.5) plus rerank overhead.
PRECISION_PRIOR: Dict[str, float] = {"f32": 1.0, "bf16": 0.6, "int8": 0.35}


class CostModel:
    def __init__(self, mean_degree: float, *, scan_unit: float = 0.125,
                 decay: float = 0.9):
        self.scan_unit = float(scan_unit)
        self.beam_unit = 1.0
        self._ndist_per_ef: Dict[int, float] = {1: float(max(mean_degree,
                                                             1.0))}
        self._beam_obs_w: Dict[int, int] = {}   # observations per beam width
        self.decay = float(decay)
        self.beam_obs = 0
        self.scan_wall_obs = 0                  # observe_wall feeds per kind
        self.beam_wall_obs = 0
        # wall us per scanned row / per beam distance, keyed by precision
        self._scan_us_p: Dict[str, float] = {}
        self._beam_us_p: Dict[str, float] = {}

    # f32 scalar view (back-compat: snapshots/state predating precisions)
    @property
    def _scan_us(self) -> Optional[float]:
        return self._scan_us_p.get("f32")

    @property
    def _beam_us(self) -> Optional[float]:
        return self._beam_us_p.get("f32")

    # back-compat scalar view (width-1 regime) -----------------------------
    @property
    def ndist_per_ef(self) -> float:
        return self._ndist_per_ef[1]

    @ndist_per_ef.setter
    def ndist_per_ef(self, value: float) -> None:
        self._ndist_per_ef[1] = float(value)

    def ndist_per_ef_at(self, beam_width: int = 1) -> float:
        """Per-width EMA; an uncalibrated width borrows the nearest
        calibrated width's value (re-score overhead varies smoothly)."""
        w = max(int(beam_width), 1)
        if w in self._ndist_per_ef:
            return self._ndist_per_ef[w]
        nearest = min(self._ndist_per_ef, key=lambda o: abs(o - w))
        return self._ndist_per_ef[nearest]

    # ---------------------------------------------------------- precisions
    def precision_factor(self, kind: str, precision: str = "f32") -> float:
        """Per-unit cost of ``precision`` relative to f32 for one strategy
        (``kind`` in {"scan", "beam"}): the measured wall-us ratio when both
        precisions have been observed, else the bandwidth prior."""
        if precision == "f32":
            return 1.0
        us = self._scan_us_p if kind == "scan" else self._beam_us_p
        f32, this = us.get("f32"), us.get(precision)
        if f32 and this:
            return this / f32
        return PRECISION_PRIOR.get(precision, 1.0)

    # ------------------------------------------------------------- predict
    def predict_beam_units(self, ef: int, beam_width: int = 1,
                           precision: str = "f32") -> float:
        return (self.beam_unit * self.ndist_per_ef_at(beam_width) *
                float(ef) * self.precision_factor("beam", precision))

    def predict_scan_units(self, window_rows: int,
                           precision: str = "f32") -> float:
        return (self.scan_unit * float(window_rows) *
                self.precision_factor("scan", precision))

    # ----------------------------------------------------------- calibrate
    def update_beam(self, ndist_mean: float, ef: int,
                    beam_width: int = 1) -> None:
        """Feed observed per-query distance evaluations from a beam batch.
        The first observation **of this width** replaces its seed (the
        construction prior, or a value borrowed from the nearest calibrated
        width) — measured data for the exact width beats any transfer;
        later observations decay-blend."""
        if ef <= 0 or not (ndist_mean >= 0):
            return
        w = max(int(beam_width), 1)
        r = float(ndist_mean) / float(ef)
        w_obs = self._beam_obs_w.get(w, 0)
        a = self.decay if w_obs else 0.0
        self._ndist_per_ef[w] = a * self.ndist_per_ef_at(w) + (1.0 - a) * r
        self._beam_obs_w[w] = w_obs + 1
        self.beam_obs += 1

    def observe_wall(self, strategy: str, units_per_query: float,
                     seconds: float, nq: int,
                     precision: str = "f32") -> None:
        """Feed measured wall time of one executed (warm) partition.  The
        EMA lands in the ``precision``'s slot; the scan/beam relative weight
        (``scan_unit``) re-anchors on f32 timings only so quantized traffic
        cannot skew the baseline strategy ratio."""
        if nq <= 0 or units_per_query <= 0 or seconds <= 0:
            return
        per_unit = seconds * 1e6 / nq / units_per_query
        us = self._scan_us_p if strategy == "scan" else self._beam_us_p
        if strategy == "scan":
            self.scan_wall_obs += 1
        else:
            self.beam_wall_obs += 1
        prev = us.get(precision)
        us[precision] = per_unit if prev is None else \
            self.decay * prev + (1.0 - self.decay) * per_unit
        if self._scan_us and self._beam_us:
            # re-anchor the relative per-unit weight on real hardware timings
            self.scan_unit = self._scan_us / self._beam_us

    def observe_wall_mixed(self, scan_units_total: float,
                           beam_units_total: float, seconds: float,
                           n_scan: int, n_beam: int,
                           precision: str = "f32") -> None:
        """Feed one **fused** dispatch that executed a scan group and a beam
        group in a single traced call (the mesh path's branchless body) —
        the wall time cannot be measured per group, so it is attributed
        proportionally to each group's *predicted* unit cost and fed through
        ``observe_wall``.  The split self-corrects: if e.g. scan is really
        cheaper than predicted, its attributed share shrinks on the next
        update as ``scan_unit`` re-anchors."""
        if seconds <= 0:
            return
        su = self.scan_unit * float(scan_units_total)
        bu = self.beam_unit * float(beam_units_total)
        tot = su + bu
        if tot <= 0:
            return
        if scan_units_total > 0 and n_scan > 0:
            self.observe_wall("scan", scan_units_total / n_scan,
                              seconds * su / tot, n_scan,
                              precision=precision)
        if beam_units_total > 0 and n_beam > 0:
            self.observe_wall("beam", beam_units_total / n_beam,
                              seconds * bu / tot, n_beam,
                              precision=precision)

    def snapshot(self) -> dict:
        return dict(scan_unit=round(self.scan_unit, 5),
                    ndist_per_ef=round(self.ndist_per_ef, 2),
                    ndist_per_ef_bw={w: round(v, 2)
                                     for w, v in self._ndist_per_ef.items()},
                    beam_obs=self.beam_obs,
                    beam_obs_bw=dict(self._beam_obs_w),
                    scan_wall_obs=self.scan_wall_obs,
                    beam_wall_obs=self.beam_wall_obs,
                    scan_us=self._scan_us, beam_us=self._beam_us,
                    scan_us_p=dict(self._scan_us_p),
                    beam_us_p=dict(self._beam_us_p))

    # -------------------------------------------------------- persistence
    def state_dict(self) -> dict:
        """Full calibration state (JSON-serializable, exact restore).
        ``ndist_per_ef`` stays the width-1 scalar so calibration files
        written before the batched-expansion regime load unchanged; the
        per-width EMAs ride along under ``ndist_per_ef_bw``, and the
        per-precision wall EMAs under ``scan_us_p``/``beam_us_p`` (the old
        scalar ``scan_us``/``beam_us`` keys keep the f32 values, so files
        round-trip across the precision boundary in both directions)."""
        return dict(scan_unit=self.scan_unit, beam_unit=self.beam_unit,
                    ndist_per_ef=self.ndist_per_ef,
                    ndist_per_ef_bw={str(w): v
                                     for w, v in self._ndist_per_ef.items()},
                    beam_obs_bw={str(w): c
                                 for w, c in self._beam_obs_w.items()},
                    decay=self.decay, beam_obs=self.beam_obs,
                    scan_wall_obs=self.scan_wall_obs,
                    beam_wall_obs=self.beam_wall_obs,
                    scan_us=self._scan_us, beam_us=self._beam_us,
                    scan_us_p=dict(self._scan_us_p),
                    beam_us_p=dict(self._beam_us_p))

    def load_state_dict(self, state: dict) -> None:
        self.scan_unit = float(state["scan_unit"])
        self.beam_unit = float(state.get("beam_unit", 1.0))
        self._ndist_per_ef = {1: float(state["ndist_per_ef"])}
        for w, v in state.get("ndist_per_ef_bw", {}).items():
            self._ndist_per_ef[int(w)] = float(v)
        self.decay = float(state.get("decay", self.decay))
        self.beam_obs = int(state["beam_obs"])
        # files from before per-width tracking: all observations were width 1
        obs_bw = state.get("beam_obs_bw")
        if obs_bw is None:
            self._beam_obs_w = {1: self.beam_obs} if self.beam_obs else {}
        else:
            self._beam_obs_w = {int(w): int(c) for w, c in obs_bw.items()}
        # pre-observability files carry no wall-obs counts: default 0
        self.scan_wall_obs = int(state.get("scan_wall_obs", 0))
        self.beam_wall_obs = int(state.get("beam_wall_obs", 0))
        # pre-precision files carry only the f32 scalars: seed the dicts
        self._scan_us_p = {k: float(v) for k, v in
                           state.get("scan_us_p", {}).items()
                           if v is not None}
        self._beam_us_p = {k: float(v) for k, v in
                           state.get("beam_us_p", {}).items()
                           if v is not None}
        if "f32" not in self._scan_us_p and state.get("scan_us") is not None:
            self._scan_us_p["f32"] = float(state["scan_us"])
        if "f32" not in self._beam_us_p and state.get("beam_us") is not None:
            self._beam_us_p["f32"] = float(state["beam_us"])

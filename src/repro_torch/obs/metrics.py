"""Lock-cheap metrics registry: counters, gauges, log-scale histograms
(host numpy, copied from the reference so the metric names, bucket edges
and percentiles are its own).

The registry is the process-wide measurement substrate for the serve path.
It is built to be touched from the engine's resolver/dispatcher threads and
from substrate dispatch without contention:

* every metric owns its **own** small lock (no registry-wide lock on the
  hot path — the registry lock is taken only on first get-or-create);
* critical sections are a handful of arithmetic ops;
* histograms accept **batched** observations (``observe_many``) so one
  engine batch costs one lock acquisition, not one per request.

Histograms use **fixed log-scale buckets**: geometric bucket edges between
``lo`` and ``hi`` (values outside clamp into the first / overflow bucket).
Percentiles are extracted by walking the cumulative counts and
geometrically interpolating inside the landing bucket, so ``percentile(p)``
is exact up to one bucket's relative width (``growth - 1``, ~25% by
default) — tight enough for p50/p90/p99 latency reporting at O(1) memory,
and validated against the ``np.percentile`` oracle in ``tests/test_obs.py``.

Pull-style metrics (cache occupancy, cost-model EMAs, …) register a
**producer** callback: a zero-argument callable returning a flat dict of
scalars, invoked only at snapshot/export time — zero hot-path cost.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class Counter:
    """Monotonic counter.  ``inc`` takes the metric's own lock so concurrent
    writers (resolver/dispatcher threads, test hammers) never lose updates."""
    __slots__ = ("name", "help", "_v", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    """Last-write-wins scalar (queue depths, occupancy, EMAs)."""
    __slots__ = ("name", "help", "_v", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self._v += float(v)

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Fixed-bucket log-scale histogram with percentile extraction.

    Bucket upper edges grow geometrically from ``lo`` by ``growth`` until
    ``hi``; one overflow bucket catches everything above.  Memory is O(#
    buckets) forever — a long-running server never grows it.  ``sum`` /
    ``min`` / ``max`` are tracked exactly, so the mean is exact and only
    the percentiles carry the bucket-resolution error."""
    __slots__ = ("name", "help", "edges", "_counts", "_sum", "_min", "_max",
                 "_count", "_lock")

    def __init__(self, name: str, help: str = "", *, lo: float = 1e-3,
                 hi: float = 6e4, growth: float = 1.25):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError("need lo > 0, hi > lo, growth > 1")
        self.name, self.help = name, help
        n = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        self.edges = lo * np.power(growth, np.arange(n + 1))  # upper edges
        self._counts = np.zeros(n + 2, np.int64)              # +under/overflow
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        self.observe_many((v,))

    def observe_many(self, values: Iterable[float]) -> None:
        vals = np.asarray(list(values) if not isinstance(values, np.ndarray)
                          else values, np.float64).ravel()
        if vals.size == 0:
            return
        # digitize(right=True) == first edge >= v: bucket index by upper edge
        idx = np.digitize(vals, self.edges, right=True)
        with self._lock:
            np.add.at(self._counts, idx, 1)
            self._sum += float(vals.sum())
            self._min = min(self._min, float(vals.min()))
            self._max = max(self._max, float(vals.max()))
            self._count += int(vals.size)

    # ----------------------------------------------------------- read side
    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p: float) -> float:
        """p in [0, 100].  Exact in rank; the returned value geometrically
        interpolates inside the landing bucket (error <= growth - 1
        relative), clamped to the exact observed [min, max]."""
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            counts = self._counts.copy()
            vmin, vmax = self._min, self._max
        rank = max(1, int(math.ceil(p / 100.0 * total)))
        cum = np.cumsum(counts)
        b = int(np.digitize(rank, cum, right=True))  # first cum >= rank
        prev = int(cum[b - 1]) if b else 0
        frac = (rank - prev) / max(int(counts[b]), 1)
        if b == 0:                           # below the first edge
            val = self.edges[0] * frac
        elif b > len(self.edges) - 1:        # overflow bucket
            val = vmax
        else:
            lo_e, hi_e = self.edges[b - 1], self.edges[b]
            val = lo_e * (hi_e / lo_e) ** frac   # geometric interpolation
        return float(min(max(val, vmin), vmax))

    def percentiles(self, ps: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
        return {f"p{g:g}": self.percentile(g) for g in ps}

    def bucket_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """(upper_edges incl. +inf, cumulative counts) — the Prometheus
        exposition shape.  Bucket ``i`` holds ``v <= edges[i]`` (digitize
        index 0 is already the first ``le`` bucket), the trailing +inf
        bucket the overflow, so the last cumulative count is the total."""
        with self._lock:
            counts = self._counts.copy()
        cum = np.cumsum(counts)
        edges = np.concatenate([self.edges, [np.inf]])
        return edges, cum

    def snapshot(self) -> dict:
        with self._lock:
            count, s = self._count, self._sum
            vmin, vmax = self._min, self._max
        out = dict(count=count, sum=s,
                   mean=s / count if count else 0.0,
                   min=vmin if count else 0.0,
                   max=vmax if count else 0.0)
        out.update(self.percentiles())
        return out


class MetricsRegistry:
    """Named get-or-create home for every metric plus pull-side producers.

    ``counter``/``gauge``/``histogram`` return the existing instance when the
    name is already registered (type-checked), so call sites never need to
    coordinate creation.  ``snapshot()`` returns one JSON-able dict;
    Prometheus text exposition lives in ``repro_torch.obs.export``."""

    def __init__(self):
        self._m: Dict[str, object] = {}
        self._producers: Dict[str, Callable[[], dict]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------- get-or-create
    def _get(self, name: str, cls, **kw):
        m = self._m.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                                f"not {cls.__name__}")
            return m
        with self._lock:
            m = self._m.get(name)
            if m is None:
                m = cls(name, **kw)
                self._m[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                                f"not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get(name, Histogram, help=help, **kw)

    def register_producer(self, section: str, fn: Callable[[], dict]) -> None:
        """Pull-side metrics: ``fn`` runs only at snapshot/export time and
        returns a flat-ish dict (nested dicts are flattened with ``_``)."""
        with self._lock:
            self._producers[section] = fn

    # ------------------------------------------------------------ read side
    def metrics(self) -> List[object]:
        with self._lock:
            return list(self._m.values())

    def producer_values(self) -> Dict[str, Dict[str, float]]:
        """{section: {flat_key: numeric_value}} — non-numeric values are
        dropped (export formats are numbers-only)."""
        with self._lock:
            producers = dict(self._producers)
        out: Dict[str, Dict[str, float]] = {}
        for section, fn in producers.items():
            try:
                raw = fn()
            except Exception:           # a dead producer never kills export
                continue
            out[section] = _flatten_numeric(raw)
        return out

    def snapshot(self) -> dict:
        counters, gauges, hists = {}, {}, {}
        for m in self.metrics():
            if isinstance(m, Counter):
                counters[m.name] = m.value
            elif isinstance(m, Gauge):
                gauges[m.name] = m.value
            elif isinstance(m, Histogram):
                hists[m.name] = m.snapshot()
        out = dict(counters=counters, gauges=gauges, histograms=hists)
        for section, vals in self.producer_values().items():
            out[section] = vals
        return out


def _flatten_numeric(d: dict, prefix: str = "") -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_numeric(v, f"{key}_"))
        elif isinstance(v, bool):
            out[key] = float(v)
        elif isinstance(v, (int, float, np.integer, np.floating)) \
                and v is not None and math.isfinite(float(v)):
            out[key] = float(v)
    return out


#: process-wide default registry — library call sites that are not handed an
#: explicit registry (``RFANNEngine`` creates its own) may share this one.
DEFAULT_REGISTRY: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    global DEFAULT_REGISTRY
    if DEFAULT_REGISTRY is None:
        DEFAULT_REGISTRY = MetricsRegistry()
    return DEFAULT_REGISTRY

"""Per-query trace records threaded through the whole query path.

A ``QueryTrace`` rides as the optional ``trace`` field of a
``SearchRequest`` and comes back attached to the ``SearchResult``.  Every
stage that touches the request appends a **span** — a named, wall-timed
segment with free-form attributes:

    resolve   attribute range -> rank interval (interval widths, Q)
    plan      routing decision (strategy vector, predicted costs, beam_width)
    dispatch  device-work enqueue (cache hit/miss/dedup, pad waste,
              kernel vs jnp path, per-shard clip widths on the mesh path)
    stitch    block on device outputs + request-order assembly + id remap

Span attributes hold numpy arrays where the quantity is per-query (e.g.
the strategy vector) and scalars otherwise, nested in dicts and lists
where a stage records several launches (the ``dispatch`` span's ``beam``
list: one record per fused-beam launch, with its blocks' timer stamps and
phase cycles on the card); ``to_dict()`` converts everything to plain
JSON-able Python for logging.

While a ``torch.profiler`` session is active, ``span`` also opens a
``record_function`` named ``rnsg.<span>`` (``rnsg.resolve``, ...), so a
device trace shows the serve path's spans beside the kernels on one
clock; with no session it opens none.  ``add_span``'s spans are measured
beforehand and open none.

Tracing is strictly **opt-in per request**: the hot path pays one
``is None`` check when no trace is attached, which is what keeps the
tracing-disabled QPS unchanged (acceptance criterion on
``make bench-substrate``).

A trace is owned by one request as it moves resolver -> dispatcher ->
finalize; stages run sequentially even when they hop threads, so spans are
a plain list (appends are atomic under the GIL).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.obs.profiler import annotate

SPAN_NAMES = ("resolve", "plan", "dispatch", "stitch")


@dataclass
class Span:
    name: str
    t0: float
    t1: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def wall_ms(self) -> float:
        return max(self.t1 - self.t0, 0.0) * 1e3

    def to_dict(self) -> dict:
        return dict(name=self.name, wall_ms=round(self.wall_ms, 4),
                    attrs={k: _plain(v) for k, v in self.attrs.items()})


class QueryTrace:
    """One request's span list plus request-level metadata."""

    def __init__(self, request_id: Optional[str] = None, **meta):
        self.request_id = request_id
        self.meta: Dict[str, Any] = dict(meta)
        self.spans: List[Span] = []

    # -------------------------------------------------------------- record
    @contextmanager
    def span(self, name: str, **attrs):
        """Time a block as one span; mutate ``sp.attrs`` inside the block to
        attach results discovered while it runs."""
        sp = Span(name, time.perf_counter(), attrs=dict(attrs))
        with annotate(f"rnsg.{name}"):
            try:
                yield sp
            finally:
                sp.t1 = time.perf_counter()
                self.spans.append(sp)

    def add_span(self, name: str, wall_ms: float = 0.0, **attrs) -> Span:
        """Append a pre-measured (or instantaneous) span."""
        now = time.perf_counter()
        sp = Span(name, now - wall_ms / 1e3, now, dict(attrs))
        self.spans.append(sp)
        return sp

    # ---------------------------------------------------------------- read
    def get(self, name: str) -> Optional[Span]:
        """Last span with this name (stages may repeat, e.g. one dispatch
        span per shard on the distributed local path)."""
        for sp in reversed(self.spans):
            if sp.name == name:
                return sp
        return None

    def all(self, name: str) -> List[Span]:
        return [sp for sp in self.spans if sp.name == name]

    def names(self) -> List[str]:
        return [sp.name for sp in self.spans]

    def wall_ms(self, name: str) -> float:
        return sum(sp.wall_ms for sp in self.spans if sp.name == name)

    def to_dict(self) -> dict:
        return dict(request_id=self.request_id,
                    meta={k: _plain(v) for k, v in self.meta.items()},
                    spans=[sp.to_dict() for sp in self.spans])


@contextmanager
def maybe_span(trace: Optional[QueryTrace], name: str, **attrs):
    """``trace.span`` when a trace rides the request, else a no-op whose
    yielded object swallows attr writes — call sites stay branch-free."""
    if trace is None:
        yield _NULL_SPAN
    else:
        with trace.span(name, **attrs) as sp:
            yield sp


class _NullSpan:
    __slots__ = ("attrs",)

    def __init__(self):
        self.attrs = _NullAttrs()


class _NullAttrs(dict):
    def __setitem__(self, k, v):    # drop writes: tracing is off
        pass

    def update(self, *a, **kw):
        pass


_NULL_SPAN = _NullSpan()


def _plain(v):
    """numpy -> JSON-able Python (arrays to lists, scalars unboxed), through
    nested dicts, lists and tuples."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v

"""Search request/result types shared by every query path.

``SearchResult`` intentionally behaves like the historical
``(ids, dists, stats)`` tuple (iteration and indexing) so call sites can
migrate to attribute access incrementally.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.kernels.quantize import PRECISIONS

STRATEGIES = ("graph", "auto", "scan", "beam")


def _invalid(field_name: str, value, requirement: str) -> ValueError:
    """Uniform validation error: names the offending field and the value it
    carried, so a batch producer can map the message back to its input."""
    return ValueError(
        f"SearchRequest: invalid {field_name}={value!r} ({requirement})")


@dataclass(frozen=True)
class SearchRequest:
    """One batched range-filtered kNN request in rank space.

    queries : (Q, d) float32 query vectors.
    lo, hi  : (Q,) inclusive attribute-rank interval per query (lo > hi
              encodes an empty range).  Rank mapping from raw attribute
              ranges lives in ``repro_torch.search.resolve``.
    strategy: "graph" — the paper's pure beam search over the full batch;
              "auto"  — cost-based scan/beam routing per query;
              "scan" / "beam" — forced strategy (tests, benchmarks).
    beam_width: batched-expansion width for every beam dispatch this
              request performs (1 = the legacy single-node expansion; B>1
              expands the best B candidates per hop — see
              ``repro_torch.core.beam``).
    precision: corpus dtype the distance pass scores against — "f32"
              (exact), or "int8"/"bf16" (quantized scan/traversal followed
              by a fused f32 rerank of the survivors, so the returned top-k
              id set matches the f32 path — see the reference's ``repro.kernels.quantize``).
              Non-f32 requires the substrate to have the quantized corpus
              installed (``install_quantized``).
    trace   : optional ``repro_torch.obs.QueryTrace``.  When attached, every
              stage that touches the request appends a wall-timed span
              (resolve / plan / dispatch / stitch) and the trace comes back
              on the ``SearchResult``.  ``None`` (the default) keeps the
              hot path to a single ``is None`` check.
    live    : optional (n,) bool per-**rank** liveness mask (the streaming
              layer's tombstones; ``False`` = deleted).  Dead rows never
              appear in results but stay traversable routing nodes on the
              beam path; the scan path masks them in-kernel.  The mask is
              corpus state, not part of the cache key — a caller that
              mutates it owns invalidating the substrate's cache segment
              (``SearchCache.invalidate_segment``); the streaming layer
              does this on every delete/compaction.
    """
    queries: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    k: int = 10
    ef: int = 64
    strategy: str = "graph"
    use_kernel: bool = False
    beam_width: int = 1
    precision: str = "f32"
    trace: Optional[Any] = None
    live: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.live is not None and np.ndim(self.live) != 1:
            raise _invalid("live", getattr(self.live, "shape", self.live),
                           "expected a 1-D per-rank mask")
        if self.strategy not in STRATEGIES:
            raise _invalid("strategy", self.strategy,
                           f"expected one of {STRATEGIES}")
        if self.precision not in PRECISIONS:
            raise _invalid("precision", self.precision,
                           f"expected one of {PRECISIONS}")
        if self.k < 1:
            raise _invalid("k", self.k, "must be >= 1")
        if self.ef < 1:
            raise _invalid("ef", self.ef, "must be >= 1")
        if self.beam_width < 1:
            raise _invalid("beam_width", self.beam_width, "must be >= 1")


@dataclass
class SearchResult:
    """ids: (Q, k) original corpus ids (-1 padded); dists: (Q, k) squared L2
    (+inf padded); stats: per-query hops/ndist plus routing info; trace:
    the request's ``QueryTrace`` (when one was attached), with every span
    the path recorded."""
    ids: np.ndarray
    dists: np.ndarray
    stats: Dict[str, Any] = field(default_factory=dict)
    trace: Optional[Any] = None

    # tuple compatibility ------------------------------------------------
    def __iter__(self):
        return iter((self.ids, self.dists, self.stats))

    def __getitem__(self, i):
        return (self.ids, self.dists, self.stats)[i]

    def __len__(self):
        return 3

    def row(self, i: int) -> "SearchResult":
        """Per-request slice (engine futures resolve to these).  The batch
        trace rides along on every row — spans are batch-scoped."""
        return SearchResult(self.ids[i], self.dists[i],
                            {k: v[i] for k, v in self.stats.items()
                             if isinstance(v, np.ndarray) and v.ndim >= 1
                             and len(v) == len(self.ids)},
                            trace=self.trace)

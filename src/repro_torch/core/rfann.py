"""High-level RFANN API: build / save / load / batched search on one RNSG
index on one device.  Query execution is delegated to the search substrate
(``repro_torch.search``); this class owns the index lifecycle.

``use_kernel=None`` (the default of ``search`` / ``search_ranks``) means the
fused kernels on a CUDA index and their plain versions on a CPU one, so a
caller that does not choose — the serving engine — serves the card through
its kernels; an explicit ``True`` / ``False`` is honoured."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.construction import RNSGGraph, build_rnsg
from repro_torch.device import resolve_use_kernel
from repro_torch.obs.trace import maybe_span
from repro_torch.search import SearchRequest, SearchSubstrate, rank_interval


class RNSGIndex:
    """The paper's system: one hereditary graph index answering every range."""

    def __init__(self, graph: RNSGGraph):
        self.g = graph
        self._substrate = None        # lazy search substrate
        self._metrics = None          # registry the substrate is built with

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, vectors: np.ndarray, attrs: np.ndarray, *, device=None,
              **kw) -> "RNSGIndex":
        """Build on ``device`` (default the card; raises without one)."""
        return cls(build_rnsg(vectors, attrs, device=device, **kw))

    @classmethod
    def build_sharded(cls, vectors: np.ndarray, attrs: np.ndarray, *,
                      device=None, **kw) -> "RNSGIndex":
        """Sharded construction (``core.build_sharded``) — bit-identical to
        :meth:`build` with exact KNN.  ``n_shards=`` picks the slab count
        (default one per visible card), placed round-robin over ``device``
        (default every visible card) or over a ``mesh=``."""
        from repro_torch.core.build_sharded import build_rnsg_sharded
        return cls(build_rnsg_sharded(vectors, attrs, device=device, **kw))

    def save(self, path: str, *, shards: int = 0) -> None:
        """``shards=0``: atomic single-npz save in the reference's layout
        (graph only).  ``shards>=1``: the sharded directory format
        (``repro_torch.index.io``), which also captures installed quantized
        corpora and restores by mmap and parallel reads."""
        if shards:
            from repro_torch.index import io
            io.save_index(self, path, shards=shards)
        else:
            self.g.save(path)

    @classmethod
    def load(cls, path: str, device=None) -> "RNSGIndex":
        """Load an npz index or an index directory written by either
        package onto ``device`` (default the card)."""
        from repro_torch.index import io
        if io.is_index_dir(path):
            idx = io.load_index(path, device=device)
            if not isinstance(idx, cls):
                raise TypeError(f"index at {path} is "
                                f"{type(idx).__name__}, not RNSGIndex — "
                                f"load it with repro_torch.index.io."
                                f"load_index")
            return idx
        return cls(RNSGGraph.load(path, device=device))

    # ------------------------------------------------------------------
    @property
    def substrate(self) -> SearchSubstrate:
        """Lazily-built search substrate (resolve/dispatch/stitch)."""
        if self._substrate is None:
            self._substrate = SearchSubstrate.from_graph(
                self.g, metrics=self._metrics)
        return self._substrate

    @property
    def executor(self):
        return self.substrate

    @property
    def planner(self):
        return self.substrate.planner

    def install_cache(self, cache) -> None:
        """Install (or remove, with ``None``) a ``SearchCache`` at the
        substrate choke point (``repro_torch.search.cache``)."""
        self.substrate.cache = cache

    def install_metrics(self, metrics) -> None:
        """Install (or remove, with ``None``) a ``MetricsRegistry`` on the
        substrate, so substrate counters and histograms land in the
        engine's registry."""
        self._metrics = metrics
        self.substrate.metrics = metrics

    def install_quantized(self, precision: str) -> None:
        """Pre-build the quantized corpus copies for one precision (int8 /
        bf16) so the first ``precision=`` search pays no build cost."""
        self.substrate.install_quantized(precision)

    def rank_range(self, attr_ranges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[a_l, a_r] (inclusive) -> rank interval [L, R] (inclusive), on
        the host."""
        return rank_interval(self.substrate.attrs,
                             np.asarray(attr_ranges, np.float32))

    def search(self, queries: np.ndarray, attr_ranges: np.ndarray, *,
               k: int = 10, ef: int = 64, use_kernel: Optional[bool] = None,
               plan: str = "graph", beam_width: int = 1,
               precision: str = "f32", trace=None, live=None):
        """queries:(Q,d); attr_ranges:(Q,2) attribute values (inclusive).
        plan: "graph" (pure beam search) | "auto" (cost-based scan/beam
        routing) | "scan" / "beam" (forced strategy).
        beam_width: batched-expansion width for beam dispatches (1 = the
        single-node hop; B>1 fuses B node expansions per hop).
        use_kernel: run each beam dispatch's hop loop in one fused kernel
        (``ops.beam_single`` / ``ops.beam_batched``) and the quantized
        rerank in ``gather_rerank``; ``None`` resolves by the index's
        device (``True`` on the card, ``False`` on the CPU).
        precision: "f32" | "int8" | "bf16" — quantized scoring (scan and
        traversal against the int8/bf16 corpus copy, ``install_quantized``)
        with an exact f32 rerank of the survivors (same top-k ids as f32
        whenever the survivors hold them).
        trace: optional ``repro_torch.obs.QueryTrace``.
        Returns a ``SearchResult`` (tuple-compatible: ids, dists, stats)."""
        with maybe_span(trace, "resolve") as sp:
            lo, hi = self.rank_range(attr_ranges)
            sp.attrs.update(
                q=len(np.atleast_2d(queries)), n=self.g.n,
                interval_widths=np.clip(
                    np.asarray(hi, np.int64) - np.asarray(lo, np.int64) + 1,
                    0, None) if trace is not None else None)
        return self.search_ranks(queries, lo, hi, k=k, ef=ef,
                                 use_kernel=use_kernel, plan=plan,
                                 beam_width=beam_width, precision=precision,
                                 trace=trace, live=live)

    def search_ranks(self, queries, lo, hi, *, k=10, ef=64, use_kernel=None,
                     plan="graph", beam_width=1, precision="f32", trace=None,
                     live=None):
        return self.substrate.run(SearchRequest(
            queries=np.asarray(queries, np.float32), lo=lo, hi=hi,
            k=k, ef=ef, strategy=plan,
            use_kernel=resolve_use_kernel(use_kernel, self.g.device),
            beam_width=beam_width, precision=precision, trace=trace,
            live=live))

    # ------------------------------------------------------------------
    @property
    def index_bytes(self) -> int:
        return self.g.index_bytes

    @property
    def n_edges(self) -> int:
        return self.g.n_edges

    def stats(self) -> Dict:
        deg = (self.g.nbrs >= 0).sum(1)
        return dict(n=self.g.n, m=self.g.m, edges=self.g.n_edges,
                    mean_degree=float(deg.float().mean()),
                    max_degree=int(deg.max()),
                    index_mb=self.index_bytes / 2**20,
                    build_seconds=self.g.build_seconds)

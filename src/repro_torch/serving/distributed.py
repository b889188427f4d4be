"""Distributed RFANN serving: range-partitioned shards over a ``ShardMesh``.

The scale-out design falls directly out of Theorem 4.7 (structural heredity):
an attribute-contiguous shard's induced subgraph *is* the RNSG built on that
shard, so

  * shards can be **constructed independently** (provably equivalent to
    slicing a global build, up to KNN approximation noise), and
  * a query with range ``q.I`` only needs the shards whose attribute span
    intersects ``q.I``; per-shard searches are exact RNSG searches on their
    sub-ranges, and a top-k merge of shard results equals the global search.

Resolution happens **once**, globally: the query's attribute range maps to a
global rank interval (``repro_torch.search.resolve``), which each shard
*clips* to its contiguous rank slice.  Execution then routes through the
search substrate, and ``plan="auto"`` works on **both** paths:

  * local path (``mesh=None``): one ``SearchSubstrate`` per shard, so each
    shard runs the full strategy router with its own calibration, followed
    by a top-k merge on the host.  By default the per-shard dispatches are
    **asynchronous**: every shard's device work is enqueued
    (``SearchSubstrate.dispatch(defer=True)``, whose uploads do not block)
    before any shard's result is copied back, so shard N+1's planning and
    upload overlap shard N's kernels; ``async_dispatch=False`` restores the
    sequential dispatch+block loop, whose per-shard wall times feed the
    wall-clock calibration;
  * mesh path (``mesh=ShardMesh``): one ``MeshSubstrate`` — the strategy
    vector is planned on the host from the shard-clipped global intervals,
    each shard's body runs on its own device (at most one scan and one beam
    dispatch per shard), and the shards' results are gathered onto the
    mesh's first device and merged there.

Shards live on ``mesh.devices`` (the mesh path; S shards may share one
card) or all on ``device`` (the local path; default the card).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.construction import build_rnsg
from repro_torch.device import resolve_device, resolve_use_kernel
from repro_torch.obs.trace import maybe_span
from repro_torch.parallel.sharding import ShardMesh, on_device
from repro_torch.search import (MeshSubstrate, SearchCache, SearchRequest,
                                SearchResult, SearchSubstrate, clip_interval,
                                merge_topk, rank_interval)


class DistributedRFANN:
    """Attribute-range-partitioned RNSG serving across a mesh's shards.

    ``vecs``, ``nbrs``, ``attrs``, ``rmq``, ``dist_c`` and ``order`` hold one
    tensor per shard, on the shard's device (``order``: each shard rank's
    original corpus id)."""

    def __init__(self, vectors: np.ndarray, attrs: np.ndarray, *,
                 n_shards: int, mesh: Optional[ShardMesh] = None,
                 async_dispatch: bool = True, device=None, **build_kw):
        order = np.argsort(attrs, kind="stable")
        vs = np.asarray(vectors, np.float32)[order]
        as_ = np.asarray(attrs, np.float32)[order]
        n = len(as_)
        per = n // n_shards
        if per * n_shards != n:
            raise ValueError(f"DistributedRFANN: n={n} is not a multiple of "
                             f"n_shards={n_shards}; pad the corpus to a "
                             f"shard multiple")
        if mesh is not None and mesh.size != n_shards:
            raise ValueError(f"DistributedRFANN: n_shards={n_shards} != mesh "
                             f"size {mesh.size}")
        self.mesh = mesh
        self.devices = (mesh.devices if mesh is not None
                        else (resolve_device(device),) * n_shards)
        self.n_shards = n_shards
        self.per = per
        self.attrs_sorted = as_       # global resolve happens over this
        graphs = []
        for s, dev in enumerate(self.devices):   # independently buildable
            sl = slice(s * per, (s + 1) * per)
            with on_device(dev):
                g = build_rnsg(vs[sl], as_[sl], device=dev, **build_kw)
            graphs.append((g, order[sl]))
        self.vecs = [g.vecs for g, _ in graphs]
        self.nbrs = [g.nbrs for g, _ in graphs]
        self.attrs = [g.attrs for g, _ in graphs]
        self.rmq = [g.rmq for g, _ in graphs]
        self.dist_c = [g.dist_c for g, _ in graphs]
        self._order_host = [o[g.order.cpu().numpy()].astype(np.int32)
                            for g, o in graphs]
        self.order = [torch.as_tensor(o, device=g.device)
                      for (g, _), o in zip(graphs, self._order_host)]
        self.async_dispatch = async_dispatch
        self._subs: Optional[list] = None
        self._mesh_sub: Optional[MeshSubstrate] = None
        self._cache: Optional[SearchCache] = None
        self._metrics = None

    @property
    def index_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for ts in (self.nbrs, self.rmq, self.dist_c) for t in ts)

    # ------------------------------------------------------------------
    @property
    def substrates(self):
        """One search substrate per shard (local execution path)."""
        if self._subs is None:
            self._subs = [
                SearchSubstrate(self.vecs[s], self.nbrs[s], self.rmq[s],
                                self.dist_c[s], self._order_host[s],
                                self.attrs[s], device=self.devices[s],
                                cache=self._cache, cache_ns=s,
                                metrics=self._metrics)
                for s in range(self.n_shards)]
        return self._subs

    @property
    def mesh_substrate(self) -> MeshSubstrate:
        """The mesh execution path (lazy; requires ``mesh``)."""
        if self._mesh_sub is None:
            if self.mesh is None:
                raise ValueError("DistributedRFANN: mesh execution needs "
                                 "mesh=")
            self._mesh_sub = MeshSubstrate(
                self.mesh, self.vecs, self.nbrs, self.rmq, self.dist_c,
                self.order, cache=self._cache, metrics=self._metrics)
        return self._mesh_sub

    def install_cache(self, cache: Optional[SearchCache]) -> None:
        """Install one shared result cache on every execution path.  On the
        local path each shard substrate keys its own shard-clipped interval,
        so shards share the byte budget without colliding."""
        self._cache = cache
        if self._subs is not None:
            for sub in self._subs:
                sub.cache = cache
        if self._mesh_sub is not None:
            self._mesh_sub.cache = cache

    def install_metrics(self, metrics) -> None:
        """Install (or remove, with ``None``) a ``MetricsRegistry`` on every
        execution path — already-built shard substrates and the mesh
        substrate pick it up immediately, lazy ones at construction."""
        self._metrics = metrics
        if self._subs is not None:
            for sub in self._subs:
                sub.metrics = metrics
        if self._mesh_sub is not None:
            self._mesh_sub.metrics = metrics

    def install_quantized(self, precision: str) -> None:
        """Pre-build the quantized corpus copies on the execution path."""
        if precision == "f32":
            return
        if self.mesh is not None:
            self.mesh_substrate.install_quantized(precision)
        else:
            for sub in self.substrates:
                with on_device(sub.device):
                    sub.install_quantized(precision)

    def _search_local(self, qv, lo, hi, *, k: int, ef: int, plan: str,
                      use_kernel: bool, beam_width: int = 1,
                      precision: str = "f32", trace=None, live=None):
        """Per-shard substrate dispatch, merged by the same ``merge_topk``
        the mesh path uses.  With ``async_dispatch`` every shard's work is
        enqueued before any result is copied back (the merge is the single
        synchronization point); otherwise shards run the sequential
        dispatch+block loop with wall calibration.

        Returns ``(ids, dists, stats)`` — ``cache_hits`` is total shard hits
        normalized by the shard count (≈ fully-cached queries),
        ``scan_frac`` the mean routed scan fraction across shards."""
        q = len(qv)
        all_i = np.full((self.n_shards, q, k), -1, np.int32)
        all_d = np.full((self.n_shards, q, k), np.inf, np.float32)
        digests = None
        if self._cache is not None and q:       # hash each query ONCE, not
            from repro_torch.search.cache import hash_query   # per shard
            digests = [hash_query(qv[i]) for i in range(q)]
        pending = []
        for s, sub in enumerate(self.substrates):
            slo, shi = clip_interval(lo, hi, s * self.per, self.per)
            # every shard shares the one trace; its spans are tagged by the
            # substrate with ns=<shard>
            req = SearchRequest(queries=qv, lo=slo, hi=shi, k=k, ef=ef,
                                strategy=plan, use_kernel=use_kernel,
                                beam_width=beam_width, precision=precision,
                                trace=trace,
                                live=None if live is None
                                else live[s * self.per:(s + 1) * self.per])
            with on_device(sub.device):
                p = sub.dispatch(req, defer=self.async_dispatch,
                                 q_digests=digests)
                if not self.async_dispatch:
                    p.result()          # block before the next shard starts
            pending.append(p)
        hits = 0
        scan_fracs = []
        for s, p in enumerate(pending):
            res = p.result()
            all_i[s] = res.ids
            all_d[s] = np.where(res.ids >= 0, res.dists, np.inf)
            hits += int(res.stats.get("cache_hits", 0))
            if "scan_frac" in res.stats:
                scan_fracs.append(float(res.stats["scan_frac"]))
        with maybe_span(trace, "stitch", ns="merge",
                        n_shards=self.n_shards) as sp:
            ids, dists = merge_topk(torch.from_numpy(all_i),
                                    torch.from_numpy(all_d), k)
            ids, dists = ids.numpy(), dists.numpy()
            sp.attrs["q"] = q
        stats = {}
        if scan_fracs:
            stats["scan_frac"] = float(np.mean(scan_fracs))
        if self._cache is not None:
            stats["cache_hits"] = int(round(hits / self.n_shards))
        return ids, dists, stats

    # ------------------------------------------------------------------
    def rank_range(self, attr_ranges: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """[a_l, a_r] (inclusive) -> *global* rank interval [L, R] over the
        attribute-sorted corpus (host-side resolve)."""
        return rank_interval(self.attrs_sorted,
                             np.asarray(attr_ranges, np.float32))

    def search_ranks(self, queries, lo, hi, *, k: int = 10, ef: int = 64,
                     plan: str = "graph", beam_width: int = 1,
                     precision: str = "f32", trace=None, live=None,
                     use_kernel: Optional[bool] = None) -> SearchResult:
        """Rank-space entry point (resolve already done): dispatch on the
        mesh path when a mesh is attached, else the (async) local path.
        ``live`` is the *global* (n,) per-rank liveness mask; the local
        path slices it per shard, the mesh path splits it across the
        shards.  ``use_kernel=None`` means the kernels on a CUDA shard and
        their plain versions on a CPU one."""
        qv = np.asarray(queries, np.float32)
        ef = max(ef, k)
        uk = resolve_use_kernel(use_kernel, self.devices[0])
        if self.mesh is None:
            ids, dists, stats = self._search_local(
                qv, lo, hi, k=k, ef=ef, plan=plan, use_kernel=uk,
                beam_width=beam_width, precision=precision, trace=trace,
                live=live)
            return SearchResult(ids, dists, stats, trace=trace)
        return self.mesh_substrate.run(SearchRequest(
            queries=qv, lo=lo, hi=hi, k=k, ef=ef, strategy=plan,
            use_kernel=uk, beam_width=beam_width, precision=precision,
            trace=trace, live=live))

    def search(self, queries: np.ndarray, attr_ranges: np.ndarray, *,
               k: int = 10, ef: int = 64, plan: str = "graph",
               beam_width: int = 1, precision: str = "f32", trace=None,
               live=None, use_kernel: Optional[bool] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        with maybe_span(trace, "resolve") as sp:
            lo, hi = self.rank_range(attr_ranges)
            sp.attrs.update(
                q=len(np.atleast_2d(queries)), n=len(self.attrs_sorted),
                interval_widths=np.clip(
                    np.asarray(hi, np.int64) - np.asarray(lo, np.int64) + 1,
                    0, None) if trace is not None else None)
        res = self.search_ranks(queries, lo, hi, k=k, ef=ef, plan=plan,
                                beam_width=beam_width, precision=precision,
                                trace=trace, live=live,
                                use_kernel=use_kernel)
        return res.ids, res.dists

"""Dispatch + stitch stages: one strategy-routed execution layer.

``SearchSubstrate`` owns the query path for one attribute-sorted corpus on
one device:

* ``resolve``  — attribute ranges -> rank intervals
                 (``repro_torch.search.resolve``);
* cache        — when a ``SearchCache`` is installed, each request is split
                 into hit rows (served from memory, no device work), unique
                 miss rows (executed), and intra-batch duplicates of a miss
                 (executed once, fanned back out), stitched in request
                 order;
* dispatch     — ``graph`` runs the paper's beam search over the full batch;
                 ``auto``/``scan``/``beam`` go through the adaptive planner,
                 which partitions the batch into fixed-shape dispatches
                 (the ``range_scan`` kernel | bucketed beam search).  A
                 quantized ``precision`` scores against the int8/bf16 corpus
                 copy and reranks the survivors in f32;
* stitch       — partition results land back in request order, rank ids are
                 remapped to original corpus ids, and per-query stats
                 (hops / ndist / strategy) are assembled.

``dispatch(req)`` enqueues the device work and returns a ``PendingSearch``
whose ``result()`` copies results to the host and stitches; ``run`` is the
synchronous spelling.  Deferred dispatches skip wall-time calibration.
After every planned synchronous dispatch the substrate feeds the cost
model: observed ``ndist`` from beam stats and warm-call wall times per work
unit (the first call of each signature is excluded, so the kernels' build
never enters calibration).

An installed ``MetricsRegistry`` counts routed queries, cache outcomes,
pad waste and rerank rows and observes dispatch wall histograms under the
reference's names; the dispatch sites carry the reference's profiler span
names (``rnsg.scan_dispatch``, ``rnsg.beam_dispatch``,
``rnsg.graph_beam_dispatch``).  Not ported yet: the mesh substrate.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.beam import beam_search_batch, rerank_pool
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import range_scan
from repro_torch.kernels.quantize import (QuantizedCorpus, quantize_corpus,
                                          rerank_depth)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profiler import annotate
from repro_torch.obs.trace import maybe_span
from repro_torch.planner.bucketing import ROW_TILE, window_rows
from repro_torch.planner.planner import SCAN, QueryPlanner
from repro_torch.search import resolve
from repro_torch.search.cache import SearchCache
from repro_torch.search.request import SearchRequest, SearchResult

INF = np.float32(np.inf)


def merge_topk(ids: torch.Tensor, dists: torch.Tensor, k: int):
    """(S,Q,k) per-shard results -> (Q,k) global top-k, ties toward the
    lower flattened position (shard-major within a query), as the
    reference's ``lax.top_k`` merge."""
    s, q, kk = ids.shape
    flat_i = ids.movedim(0, 1).reshape(q, s * kk)
    flat_d = dists.movedim(0, 1).reshape(q, s * kk)
    o = torch.argsort(flat_d, dim=1, stable=True)[:, :k]
    d = flat_d.gather(1, o)
    return torch.where(torch.isfinite(d), flat_i.gather(1, o), -1), d


class PendingSearch:
    """Handle for an in-flight substrate dispatch: ``result()`` blocks on
    the outputs, stitches, feeds the cost model, and returns the
    ``SearchResult``.  Idempotent."""
    __slots__ = ("_finalize", "_result")

    def __init__(self, finalize: Callable[[], SearchResult]):
        self._finalize: Optional[Callable[[], SearchResult]] = finalize
        self._result: Optional[SearchResult] = None

    def result(self) -> SearchResult:
        if self._finalize is not None:
            self._result = self._finalize()
            self._finalize = None
        return self._result


class SearchSubstrate:
    def __init__(self, vecs, nbrs, rmq, dist_c, order, attrs, *,
                 device=None, cache: Optional[SearchCache] = None,
                 cache_ns=None, metrics: Optional[MetricsRegistry] = None):
        dev = resolve_device(device)
        self.device = dev
        self._vecs = torch.as_tensor(vecs, dtype=torch.float32, device=dev)
        self._nbrs = torch.as_tensor(nbrs, device=dev)
        self._rmq = torch.as_tensor(rmq, device=dev)
        self._dist_c = torch.as_tensor(dist_c, device=dev)
        self.order = _host(order)
        self.attrs = _host(attrs)
        self.cache = cache
        self.cache_ns = cache_ns    # distinguishes segments sharing one cache
        self.metrics = metrics      # optional MetricsRegistry (obs layer)
        n, d = self._vecs.shape
        self.n, self.d = n, d
        self.tb = ROW_TILE          # must match the range_scan kernel tile
        self.d_pad = -(-d // 128) * 128
        deg = float((self._nbrs >= 0).sum(1).float().mean()) if n else 1.0
        self.planner = QueryPlanner(max(n, 1), deg)
        self._x_pad = None          # padded scan copy, built on first scan
        self._quant: Dict[str, dict] = {}   # precision -> quantized slots
        self._live_memo = None      # (mask, (n,) bool dev, (1,n_pad) i32 dev)
        self._warm: Set[Tuple] = set()

    @classmethod
    def from_graph(cls, g, **kw) -> "SearchSubstrate":
        """Build over one ``RNSGGraph``, on the graph's device."""
        kw.setdefault("device", g.device)
        return cls(g.vecs, g.nbrs, g.rmq, g.dist_c, g.order, g.attrs, **kw)

    # ------------------------------------------------------------ resolve
    def resolve(self, attr_ranges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Attribute ranges (Q,2) -> inclusive rank intervals (lo, hi)."""
        return resolve.rank_interval(self.attrs, attr_ranges)

    # ---------------------------------------------------------------- run
    def run(self, req: SearchRequest) -> SearchResult:
        """Dispatch one request synchronously and stitch the result."""
        return self.dispatch(req, defer=False).result()

    def dispatch(self, req: SearchRequest, *,
                 defer: bool = True) -> PendingSearch:
        """Enqueue one request's device work and return a ``PendingSearch``.
        ``defer=False`` blocks each planned partition before dispatching the
        next and calibrates on its wall time.  Cache hits are resolved here
        — a fully-hit request performs no device work at all.  A
        ``req.trace`` collects plan / dispatch / stitch spans; the installed
        ``MetricsRegistry`` (when any) counts routed queries, cache
        outcomes and pad waste, and observes dispatch wall histograms."""
        qv = np.asarray(req.queries, np.float32)
        lo = np.asarray(req.lo, np.int64)
        hi = np.asarray(req.hi, np.int64)
        k, ef, bw = int(req.k), int(req.ef), int(req.beam_width)
        prec = req.precision
        tr = req.trace
        met = self.metrics
        nq = len(qv)
        if met is not None and nq:
            met.counter("queries_total").inc(nq)
            met.counter(f"queries_{prec}_total").inc(nq)
        live = req.live
        cache = self.cache
        cache_info = dict(cache_enabled=cache is not None,
                          cache_hits=0, cache_misses=nq, batch_dedup=0)
        if cache is None or nq == 0:
            fin = self._dispatch_all(qv, lo, hi, k, ef, req.strategy,
                                     req.use_kernel, defer, bw, prec,
                                     trace=tr, cache_info=cache_info,
                                     live=live)
            return PendingSearch(self._stitched(fin, tr))
        # (global, segment) epoch pair: fences stores against invalidate()
        # and invalidate_segment(self.cache_ns), which the streaming layer
        # bumps on every tombstone change and compaction
        epoch = cache.epoch_for(self.cache_ns)
        cal_epoch = (self.planner.calibration_epoch
                     if req.strategy == "auto" else None)
        keys, hit_rows, miss, dups = cache.split(
            qv, lo, hi, k, ef, req.strategy, req.use_kernel,
            ns=self.cache_ns, beam_width=bw,
            precision=prec, cal_epoch=cal_epoch)
        cache_info.update(cache_hits=len(hit_rows), cache_misses=len(miss),
                          batch_dedup=len(dups))
        if met is not None:
            met.counter("cache_hit_rows_total").inc(len(hit_rows))
            met.counter("cache_miss_rows_total").inc(len(miss))
            if dups:
                met.counter("cache_dedup_rows_total").inc(len(dups))
        if len(miss) == 0:
            if tr is not None:          # fully hit: no device work at all
                tr.add_span("dispatch", dispatched=0, ns=self.cache_ns,
                            **cache_info)
            return PendingSearch(self._stitched(
                lambda: cache.assemble(nq, k, hit_rows, None, miss), tr))
        fin = self._dispatch_all(qv[miss], lo[miss], hi[miss], k, ef,
                                 req.strategy, req.use_kernel, defer, bw,
                                 prec, trace=tr, cache_info=cache_info,
                                 live=live)
        miss_keys = [keys[i] for i in miss]

        def finalize() -> SearchResult:
            miss_res = fin()
            cache.store_batch(miss_keys, miss_res, epoch=epoch,
                              cal_epoch=cal_epoch)
            if not hit_rows and not dups:
                miss_res.stats["cache_hits"] = 0
                return miss_res
            return cache.assemble(nq, k, hit_rows, miss_res, miss, dups)
        return PendingSearch(self._stitched(finalize, tr))

    def _stitched(self, fin: Callable[[], SearchResult],
                  tr) -> Callable[[], SearchResult]:
        """Wrap a finalize closure with the stitch span (block + assembly +
        id remap) and the ``stitch_ms`` histogram, and attach the trace to
        the result.  Identity when neither tracing nor metrics are on."""
        met = self.metrics
        if tr is None and met is None:
            return fin

        def finalize() -> SearchResult:
            t0 = time.perf_counter()
            with maybe_span(tr, "stitch", ns=self.cache_ns):
                res = fin()
            if met is not None:
                met.histogram("stitch_ms").observe(
                    (time.perf_counter() - t0) * 1e3)
            if tr is not None:
                res.trace = tr
            return res
        return finalize

    # ----------------------------------------------------------- dispatch
    def _dispatch_all(self, qv, lo, hi, k, ef, strategy, use_kernel,
                      defer: bool, beam_width: int = 1,
                      precision: str = "f32", trace=None,
                      cache_info=None, live=None) -> Callable[[], SearchResult]:
        """Enqueue the uncached work for one (sub-)batch; the returned
        closure blocks, stitches, and remaps rank ids to original ids."""
        met = self.metrics
        with maybe_span(trace, "dispatch") as sp:
            sp.attrs.update(cache_info or {})
            sp.attrs.update(strategy_mode=strategy, use_kernel=use_kernel,
                            beam_width=beam_width, ns=self.cache_ns,
                            precision=precision,
                            dispatched=len(qv), deferred=defer)
            if strategy == "graph":
                if trace is not None:
                    trace.add_span("plan", strategy_mode="graph",
                                   chosen="graph", beam_width=beam_width)
                if met is not None and len(qv):
                    met.counter("graph_queries_total").inc(len(qv))
                fin = self._dispatch_graph(qv, lo, hi, k, ef, use_kernel,
                                           beam_width, precision, live=live)
            else:
                fin = self._dispatch_planned(qv, lo, hi, k, ef, strategy,
                                             use_kernel, defer, beam_width,
                                             precision, trace=trace, span=sp,
                                             live=live)

        def finalize() -> SearchResult:
            ids, dists, stats = fin()
            return SearchResult(resolve.remap_ids(self.order, ids), dists,
                                stats)
        return finalize

    # ------------------------------------------------------ graph strategy
    def _dispatch_graph(self, qv, lo, hi, k, ef, use_kernel, beam_width=1,
                        precision="f32", live=None):
        """The paper's path: one beam-search dispatch over the full batch.
        Non-f32 precisions score the traversal against the quantized corpus
        and rerank the final pool in f32 inside ``beam_search_batch``."""
        dev = self.device
        qj = torch.as_tensor(qv, device=dev)
        lo_j = torch.as_tensor(lo, device=dev)
        hi_j = torch.as_tensor(hi, device=dev)
        entry = resolve.select_entry(self._rmq, self._dist_c, lo_j, hi_j,
                                     self.n)
        live_b, _ = self._live_ops(live)
        t0 = time.perf_counter()
        with annotate("rnsg.graph_beam_dispatch"):
            ids, dists, st = beam_search_batch(
                self._vecs, self._nbrs, qj, lo_j, hi_j, entry,
                k=k, ef=max(ef, k), use_kernel=use_kernel,
                beam_width=beam_width, quant=self._quant_ops(precision),
                live=live_b)
        met = self.metrics

        def finalize():
            st_h = {kk: vv.cpu().numpy() for kk, vv in st.items()}
            st_h["strategy"] = np.ones(len(qv), np.int8)     # all graph/beam
            st_h["scan_frac"] = 0.0
            ids_h, d_h = ids.cpu().numpy(), dists.cpu().numpy()
            if met is not None:
                met.histogram("graph_dispatch_ms").observe(
                    (time.perf_counter() - t0) * 1e3)
            return ids_h, d_h, st_h
        return finalize

    # ---------------------------------------------------- planned strategies
    def _dispatch_planned(self, qv, lo, hi, k, ef, mode, use_kernel,
                          defer: bool, beam_width: int = 1,
                          precision: str = "f32", trace=None,
                          span=None, live=None):
        """Routing policy: plan the batch, dispatch each fixed-shape
        partition, stitch back in request order."""
        q = len(qv)
        met = self.metrics
        if trace is None:
            plan = self.planner.plan_batch(lo, hi, k=k, ef=ef, mode=mode,
                                           beam_width=beam_width,
                                           precision=precision)
        else:
            with trace.span("plan") as psp:
                plan = self.planner.plan_batch(lo, hi, k=k, ef=ef,
                                               mode=mode,
                                               beam_width=beam_width,
                                               precision=precision)
                lens = np.clip(hi - lo + 1, 0, None)
                sc, bc = self.planner.predict_costs(lens, k=k, ef=ef,
                                                    beam_width=beam_width,
                                                    precision=precision)
                psp.attrs.update(
                    strategy_mode=mode, strategy=plan.strategy.copy(),
                    scan_frac=plan.scan_frac, beam_width=beam_width,
                    precision=precision,
                    partitions=[p.signature for p in plan.partitions],
                    predicted_scan_units=sc, predicted_beam_units=bc)
        pad_rows = sum(p.pad_q - len(p.indices) for p in plan.partitions)
        if met is not None and q:
            n_scan = int((plan.strategy == SCAN).sum())
            met.counter("scan_routed_total").inc(n_scan)
            met.counter("beam_routed_total").inc(q - n_scan)
            if pad_rows:
                met.counter("pad_rows_total").inc(pad_rows)
        if span is not None:
            span.attrs["pad_rows"] = pad_rows
        fins = []
        for part in plan.partitions:
            if part.kind == "scan":
                fin = self._dispatch_scan(qv, lo, hi, part.indices,
                                          part.param, part.pad_q, k, ef,
                                          calibrate_wall=not defer,
                                          precision=precision, trace=trace,
                                          live=live)
            else:
                fin = self._dispatch_beam(qv, lo, hi, part.indices,
                                          part.param, part.pad_q, k,
                                          calibrate=(mode == "auto"),
                                          calibrate_wall=not defer,
                                          use_kernel=use_kernel,
                                          beam_width=beam_width,
                                          precision=precision, live=live)
            if not defer:
                val = fin()
                fin = (lambda v: lambda: v)(val)
            fins.append(fin)

        def finalize():
            out_ids = np.full((q, k), -1, np.int32)
            out_d = np.full((q, k), INF, np.float32)
            hops = np.zeros(q, np.int32)
            ndist = np.zeros(q, np.int32)
            for part, fin in zip(plan.partitions, fins):
                idx = part.indices  # never empty (guarded at plan time)
                if part.kind == "scan":
                    ids_p, d_p, units = fin()
                    ndist[idx] = units
                else:
                    ids_p, d_p, st = fin()
                    hops[idx] = st["hops"]
                    ndist[idx] = st["ndist"]
                out_ids[idx] = ids_p
                out_d[idx] = d_p
            stats = {"hops": hops, "ndist": ndist,
                     "strategy": plan.strategy, "scan_frac": plan.scan_frac}
            return out_ids, out_d, stats
        return finalize

    # ------------------------------------------------------------------
    def _scan_corpus(self) -> torch.Tensor:
        """Row/lane-padded corpus copy for the scan kernel (lazy: a corpus
        that never routes to scan skips the duplicate)."""
        if self._x_pad is None:
            n_pad = -(-self.n // self.tb) * self.tb
            self._x_pad = torch.nn.functional.pad(
                self._vecs, (0, self.d_pad - self.d, 0, n_pad - self.n))
        return self._x_pad

    # ------------------------------------------------------- liveness mask
    def _live_ops(self, live):
        """Device forms of a per-rank liveness mask: ((n,) bool for the beam
        paths, (1, n_pad) i32 row for the scan kernel).  Memoized by object
        identity (a publisher hands out one immutable mask per version)."""
        if live is None:
            return None, None
        memo = self._live_memo
        if memo is not None and memo[0] is live:
            return memo[1], memo[2]
        lv = np.asarray(live, bool)
        if lv.shape != (self.n,):
            raise ValueError(
                f"live mask shape {lv.shape} does not match corpus ({self.n},)")
        n_pad = -(-self.n // self.tb) * self.tb
        row = np.zeros((1, n_pad), np.int32)
        row[0, :self.n] = lv
        out = (torch.as_tensor(lv, device=self.device),
               torch.as_tensor(row, device=self.device))
        self._live_memo = (live,) + out
        return out

    # --------------------------------------------------- quantized corpus
    def install_quantized(self, precision: str) -> None:
        """Build (or rebuild) the quantized corpus copies for one precision
        ahead of serving, so the first quantized request pays no build
        cost.  The lazy build happens anyway on first use
        (``_quant_for``).  The scored corpus changed, so this substrate's
        cache segment goes cold."""
        if precision != "f32":
            self._quant.pop(precision, None)
            self._quant_for(precision)
            if self.cache is not None:
                self.cache.invalidate_segment(self.cache_ns)

    def _quant_for(self, precision: str) -> Optional[dict]:
        """Quantized scoring slots for one precision (lazy, cached):
        ``data`` (n,d) for the beam's gathered rows, ``data_pad``
        (n_pad,d_pad) rank-ordered for the scan kernel, ``scale`` /
        ``scale_pad`` ((d,)/(d_pad,) f32, int8 only; padding the scale with
        1.0 is inert because padded query and corpus lanes are zero)."""
        if precision == "f32":
            return None
        slot = self._quant.get(precision)
        if slot is None:
            slot = self._slot_of(quantize_corpus(self._vecs, precision))
            self._quant[precision] = slot
        return slot

    def _quant_ops(self, precision: str):
        """The beam's ``quant`` operand, (data, scale), or None for f32."""
        slot = self._quant_for(precision)
        return None if slot is None else (slot["data"], slot["scale"])

    def _slot_of(self, qc: QuantizedCorpus) -> dict:
        """Scoring slots from one quantized corpus copy (shared by the lazy
        quantize path and the preload path)."""
        n_pad = -(-self.n // self.tb) * self.tb
        data_pad = torch.nn.functional.pad(
            qc.data, (0, self.d_pad - self.d, 0, n_pad - self.n))
        scale_pad = None if qc.scale is None else torch.nn.functional.pad(
            qc.scale, (0, self.d_pad - self.d), value=1.0)
        return dict(data=qc.data, data_pad=data_pad,
                    scale=qc.scale, scale_pad=scale_pad,
                    bytes_per_vector=qc.bytes_per_vector)

    def preload_quantized(self, precision: str, data, scale=None) -> None:
        """Attach a prebuilt quantized corpus copy (the index-restore path,
        ``repro_torch.index.io``) without re-quantizing.  ``data`` may
        arrive as an exact f32 upcast; it is narrowed back to the
        precision's dtype here, which round-trips bit-exactly.  Same cache
        rule as :meth:`install_quantized`."""
        if precision == "f32":
            return
        dt = torch.bfloat16 if precision == "bf16" else torch.int8
        qc = QuantizedCorpus(
            precision, torch.as_tensor(data, device=self.device).to(dt),
            None if scale is None else
            torch.as_tensor(scale, dtype=torch.float32, device=self.device))
        self._quant[precision] = self._slot_of(qc)
        if self.cache is not None:
            self.cache.invalidate_segment(self.cache_ns)

    def _dispatch_scan(self, qv, lo, hi, idx, bucket: int, pad_q: int,
                       k: int, ef: int, *, calibrate_wall: bool,
                       precision: str = "f32", trace=None, live=None):
        nq = len(idx)
        starts = np.zeros(pad_q, np.int32)
        lens = np.zeros(pad_q, np.int32)
        starts[:nq] = lo[idx]
        lens[:nq] = np.clip(hi[idx] - lo[idx] + 1, 0, bucket)
        qp = np.zeros((pad_q, self.d_pad), np.float32)
        qp[:nq, :self.d] = qv[idx]
        slot = self._quant_for(precision)
        _, live_row = self._live_ops(live)
        sig = ("scan", bucket, pad_q, k, precision, live is not None)
        warm = sig in self._warm
        self._warm.add(sig)
        dev = self.device
        t0 = time.perf_counter()
        rq = 0
        with annotate("rnsg.scan_dispatch"):
            st_j = torch.as_tensor(starts, device=dev)
            ln_j = torch.as_tensor(lens, device=dev)
            qp_j = torch.as_tensor(qp, device=dev)
            if slot is None:
                ids, d = range_scan(self._scan_corpus(), st_j, ln_j, qp_j,
                                    bucket=bucket, k=k, live=live_row)
            else:
                # the quantized scan keeps rerank_depth survivors
                # (tombstoned rows are masked in the kernel, so the pool is
                # live-only) ...
                rq = rerank_depth(k, ef, cap=self.tb)
                ids_q, _ = range_scan(slot["data_pad"], st_j, ln_j, qp_j,
                                      bucket=bucket, k=rq,
                                      scale=slot["scale_pad"], live=live_row)
                # ... and an f32 rescore of those ids restores the exact
                # top-k
                with maybe_span(trace, "rerank", precision=precision,
                                rows=pad_q * rq, k=k):
                    ids, d = rerank_pool(self._vecs, ids_q,
                                         qp_j[:, :self.d], k, use_kernel=True)
        units = window_rows(bucket, self.tb)
        met = self.metrics

        def finalize():
            ids_h = ids.cpu().numpy()[:nq]
            d_h = d.cpu().numpy()[:nq]
            dt = time.perf_counter() - t0
            if met is not None:
                met.histogram("scan_dispatch_ms").observe(dt * 1e3)
                if rq:
                    met.counter("rerank_rows_total").inc(pad_q * rq)
            if calibrate_wall and warm:
                # pad_q windows of work were done, not nq
                self.planner.cost.observe_wall("scan", units, dt, pad_q,
                                               precision=precision)
            return ids_h, d_h, units
        return finalize

    def _dispatch_beam(self, qv, lo, hi, idx, ef: int, pad_q: int, k: int, *,
                       calibrate: bool, calibrate_wall: bool = True,
                       use_kernel: bool = False, beam_width: int = 1,
                       precision: str = "f32", live=None):
        nq = len(idx)
        if nq == 0:                 # empty partition: nothing to dispatch
            empty = np.zeros(0, np.int32)
            return lambda: (np.zeros((0, k), np.int32),
                            np.zeros((0, k), np.float32),
                            {"hops": empty, "ndist": empty})
        dev = self.device
        pad = np.concatenate([idx, np.repeat(idx[-1:], pad_q - nq)])
        lo_j = torch.as_tensor(np.clip(lo[pad], 0, self.n - 1), device=dev)
        hi_j = torch.as_tensor(np.clip(hi[pad], 0, self.n - 1), device=dev)
        entry = resolve.select_entry(self._rmq, self._dist_c, lo_j, hi_j,
                                     self.n)
        live_b, _ = self._live_ops(live)
        quant = self._quant_ops(precision)
        sig = ("beam", ef, pad_q, k, beam_width, precision, live is not None)
        warm = sig in self._warm
        self._warm.add(sig)
        t0 = time.perf_counter()
        with annotate("rnsg.beam_dispatch"):
            ids, d, st = beam_search_batch(
                self._vecs, self._nbrs, torch.as_tensor(qv[pad], device=dev),
                torch.as_tensor(lo[pad], device=dev),
                torch.as_tensor(hi[pad], device=dev),
                entry, k=k, ef=max(ef, k), use_kernel=use_kernel,
                beam_width=beam_width, quant=quant, live=live_b)
        met = self.metrics

        def finalize():
            ids_h = ids.cpu().numpy()[:nq]
            d_h = d.cpu().numpy()[:nq]
            st_h = {kk: vv.cpu().numpy()[:nq] for kk, vv in st.items()}
            dt = time.perf_counter() - t0
            if met is not None:
                met.histogram("beam_dispatch_ms").observe(dt * 1e3)
            if calibrate:
                self.planner.cost.update_beam(float(st_h["ndist"].mean()), ef,
                                              beam_width=beam_width)
                if calibrate_wall and warm:
                    # pad lanes duplicate the last real query: normalize by
                    # pad_q lanes of ~ndist work each
                    self.planner.cost.observe_wall(
                        "beam", max(float(st_h["ndist"].mean()), 1.0), dt,
                        pad_q, precision=precision)
            return ids_h, d_h, st_h
        return finalize


def _host(a) -> np.ndarray:
    """A host numpy view of a tensor or array."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


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
synchronous spelling.  A deferred dispatch uploads each partition's host
operands in one pinned copy that does not block (``device.upload``), so it
waits on the card nowhere before its ``result()``: the distributed local
path enqueues every shard before the first block.
Deferred dispatches skip wall-time calibration.
After every planned synchronous dispatch the substrate feeds the cost
model: observed ``ndist`` from beam stats and warm-call wall times per work
unit (the first call of each signature is excluded, so the kernels' build
never enters calibration).

An installed ``MetricsRegistry`` counts routed queries, cache outcomes,
pad waste and rerank rows and observes dispatch wall histograms under the
reference's names; the dispatch sites carry the reference's profiler span
names (``rnsg.scan_dispatch``, ``rnsg.beam_dispatch``,
``rnsg.graph_beam_dispatch``).

``MeshSubstrate`` is the multi-device twin over a ``ShardMesh``
(``repro_torch.parallel.sharding``): the planner runs on the host over the
globally resolved rank intervals (one decision per query, from its widest
shard-local clip), each shard's body runs on its shard's device — the
``range_scan`` kernel and the beam search at most once each per shard —
scatters both groups back to request order, and the shards' (Q, k) results
are gathered onto the mesh's first device and merged there
(``merge_topk``), with one host copy per batch.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.beam import beam_search_batch, rerank_pool
from repro_torch.device import resolve_device, upload
from repro_torch.kernels.ops import range_scan
from repro_torch.kernels.quantize import (QuantizedCorpus, quantize_corpus,
                                          rerank_depth)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profiler import annotate
from repro_torch.obs.trace import maybe_span
from repro_torch.parallel.sharding import ShardMesh, all_gather, shard_map
from repro_torch.planner.bucketing import (ROW_TILE, bucket_for_len,
                                           next_pow2, pad_pow2, window_rows)
from repro_torch.planner.planner import BEAM, SCAN, QueryPlanner
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

    def dispatch(self, req: SearchRequest, *, defer: bool = True,
                 q_digests=None) -> PendingSearch:
        """Enqueue one request's device work and return a ``PendingSearch``.
        ``defer=False`` blocks each planned partition before dispatching the
        next and calibrates on its wall time.  Cache hits are resolved here
        — a fully-hit request performs no device work at all.
        ``q_digests`` are optional precomputed ``hash_query`` values (the
        distributed local path hashes each query once, not once per
        shard).  A
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
            ns=self.cache_ns, digests=q_digests, beam_width=bw,
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
                                           beam_width, precision, live=live,
                                           defer=defer)
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
                        precision="f32", live=None, defer=False):
        """The paper's path: one beam-search dispatch over the full batch.
        Non-f32 precisions score the traversal against the quantized corpus
        and rerank the final pool in f32 inside ``beam_search_batch``."""
        qj, lo_j, hi_j = upload([qv, lo.astype(np.int32),
                                 hi.astype(np.int32)], self.device,
                                pinned=defer)
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
                                          defer=defer,
                                          precision=precision, trace=trace,
                                          live=live)
            else:
                fin = self._dispatch_beam(qv, lo, hi, part.indices,
                                          part.param, part.pad_q, k,
                                          calibrate=(mode == "auto"),
                                          defer=defer,
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
                       k: int, ef: int, *, defer: bool,
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
        t0 = time.perf_counter()
        rq = 0
        with annotate("rnsg.scan_dispatch"):
            st_j, ln_j, qp_j = upload([starts, lens, qp], self.device,
                                      pinned=defer)
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
            if not defer and warm:
                # pad_q windows of work were done, not nq
                self.planner.cost.observe_wall("scan", units, dt, pad_q,
                                               precision=precision)
            return ids_h, d_h, units
        return finalize

    def _dispatch_beam(self, qv, lo, hi, idx, ef: int, pad_q: int, k: int, *,
                       calibrate: bool, defer: bool = False,
                       use_kernel: bool = False, beam_width: int = 1,
                       precision: str = "f32", live=None):
        nq = len(idx)
        if nq == 0:                 # empty partition: nothing to dispatch
            empty = np.zeros(0, np.int32)
            return lambda: (np.zeros((0, k), np.int32),
                            np.zeros((0, k), np.float32),
                            {"hops": empty, "ndist": empty})
        pad = np.concatenate([idx, np.repeat(idx[-1:], pad_q - nq)])
        lo_p, hi_p = lo[pad].astype(np.int32), hi[pad].astype(np.int32)
        q_j, lo_j, hi_j, lo_c, hi_c = upload(
            [qv[pad], lo_p, hi_p, np.clip(lo_p, 0, self.n - 1),
             np.clip(hi_p, 0, self.n - 1)], self.device, pinned=defer)
        entry = resolve.select_entry(self._rmq, self._dist_c, lo_c, hi_c,
                                     self.n)
        live_b, _ = self._live_ops(live)
        quant = self._quant_ops(precision)
        sig = ("beam", ef, pad_q, k, beam_width, precision, live is not None)
        warm = sig in self._warm
        self._warm.add(sig)
        t0 = time.perf_counter()
        with annotate("rnsg.beam_dispatch"):
            ids, d, st = beam_search_batch(
                self._vecs, self._nbrs, q_j, lo_j, hi_j, entry, k=k,
                ef=max(ef, k), use_kernel=use_kernel, beam_width=beam_width,
                quant=quant, live=live_b)
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
                if not defer and warm:
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


# ======================================================================
# Mesh path: per-shard bodies + the host-planned mesh substrate.
# ======================================================================
class _Shard:
    """One shard's index arrays on its device, and where its rank slice
    starts in the global rank space."""
    __slots__ = ("vecs", "nbrs", "rmq", "dist_c", "order", "rank0", "n",
                 "device")

    def __init__(self, vecs, nbrs, rmq, dist_c, order, rank0: int, dev):
        self.vecs = torch.as_tensor(vecs, dtype=torch.float32, device=dev)
        self.nbrs = torch.as_tensor(nbrs, device=dev)
        self.rmq = torch.as_tensor(rmq, device=dev)
        self.dist_c = torch.as_tensor(dist_c, device=dev)
        self.order = torch.as_tensor(order, device=dev)
        self.rank0 = int(rank0)
        self.n = self.vecs.shape[0]
        self.device = dev


def _shard_graph(sh: _Shard, qv, lo, hi, *, k: int, ef: int,
                 use_kernel: bool, beam_width: int = 1, quant=None,
                 live=None):
    """Per-shard graph body (the paper's mesh path): clip the global rank
    interval to this shard, one beam dispatch over the full batch, remap to
    original ids.  Returns ((Q, k) ids with -1 pads, (Q, k) dists with +inf
    pads, this shard's summed ndist) on the shard's device."""
    slo, shi = resolve.clip_interval_torch(lo, hi, sh.rank0, sh.n)
    entry = resolve.select_entry(sh.rmq, sh.dist_c, slo, shi, sh.n)
    ids, dists, st = beam_search_batch(sh.vecs, sh.nbrs, qv, slo, shi, entry,
                                       k=k, ef=ef, use_kernel=use_kernel,
                                       beam_width=beam_width, quant=quant,
                                       live=live)
    dists = torch.where(ids >= 0, dists, INF)
    return (resolve.remap_ids_torch(sh.order, ids), dists,
            st["ndist"].sum())


def _shard_planned(sh: _Shard, x_scan, scale_pad, scan_ops, beam_ops, *,
                   k: int, ef: int, bucket: int, nq: int, has_beam: bool,
                   use_kernel: bool, beam_width: int = 1,
                   precision: str = "f32", quant=None, live_row=None,
                   live_beam=None):
    """Per-shard planned body: the host already split the batch into a scan
    group and a beam group (pow2-padded with empty windows), so the shard
    runs the ``range_scan`` kernel and the beam search at most once each.
    Each group's results scatter into an (nq + 1, k) buffer at their request
    positions (pads land in the sink row ``nq``, dropped), restoring request
    order before the cross-shard merge.

    Quantized precisions: ``x_scan`` is this shard's padded quantized scan
    corpus and ``scale_pad`` its (d_pad,) dequant row (int8); the scan keeps
    ``rerank_depth`` survivors and rescores them in f32 (``rerank_pool``),
    so scan rows leave exact; the beam reranks inside ``beam_search_batch``.
    ``live_row`` / ``live_beam`` are this shard's tombstone mask forms."""
    dev = sh.device
    out_i = torch.full((nq + 1, k), -1, dtype=torch.int32, device=dev)
    out_d = torch.full((nq + 1, k), INF, dtype=torch.float32, device=dev)
    scan_q, scan_lo, scan_hi, scan_dst = scan_ops
    slo, shi = resolve.clip_interval_torch(scan_lo, scan_hi, sh.rank0, sh.n)
    lens = torch.clamp(shi - slo + 1, 0, bucket)       # shard-local window
    starts = torch.clamp(slo, 0, sh.n - 1)             # (len 0 when empty)
    if precision == "f32":
        ids_s, d_s = range_scan(x_scan, starts, lens, scan_q, bucket=bucket,
                                k=k, n_valid=sh.n, live=live_row)
    else:
        rq = rerank_depth(k, ef, cap=ROW_TILE)
        ids_q, _ = range_scan(x_scan, starts, lens, scan_q, bucket=bucket,
                              k=rq, n_valid=sh.n, scale=scale_pad,
                              live=live_row)
        ids_s, d_s = rerank_pool(sh.vecs, ids_q, scan_q[:, :sh.vecs.shape[1]],
                                 k, use_kernel=True)
    dst = scan_dst.long()
    out_i[dst] = resolve.remap_ids_torch(sh.order, ids_s).to(torch.int32)
    out_d[dst] = torch.where(ids_s >= 0, d_s, INF)
    nd = torch.zeros((), dtype=torch.int64, device=dev)
    if has_beam:
        beam_q, beam_lo, beam_hi, beam_dst = beam_ops
        slo, shi = resolve.clip_interval_torch(beam_lo, beam_hi, sh.rank0,
                                               sh.n)
        entry = resolve.select_entry(sh.rmq, sh.dist_c, slo, shi, sh.n)
        ids_b, d_b, st = beam_search_batch(
            sh.vecs, sh.nbrs, beam_q, slo, shi, entry, k=k, ef=ef,
            use_kernel=use_kernel, beam_width=beam_width, quant=quant,
            live=live_beam)
        dst = beam_dst.long()
        out_i[dst] = resolve.remap_ids_torch(sh.order, ids_b).to(torch.int32)
        out_d[dst] = torch.where(ids_b >= 0, d_b, INF)
        nd = st["ndist"].sum()      # pad lanes: empty windows, ndist 0
    return out_i[:nq], out_d[:nq], nd


class MeshSubstrate:
    """Mesh-path twin of ``SearchSubstrate``: host planning, per-shard
    bodies on each shard's device, a merge on the mesh's first device.

    * plan     — ``QueryPlanner.choose_strategy_batch`` over each query's
                 widest shard-local clip of the globally resolved rank
                 interval (one decision per query, shared by every shard);
    * dispatch — the strategy vector splits the batch on the host into a
                 scan group (one shared pow2 ``bucket``) and a beam group;
                 their operands go to each distinct device in one copy, and
                 ``_shard_planned`` runs each kernel at most once per shard;
                 a batch with no scan-routed query takes the graph body
                 (``_shard_graph``), as does ``plan="graph"``;
    * stitch   — scatter back to request order on each shard, then
                 ``all_gather`` + ``merge_topk`` on the first device and one
                 host copy of the merged ids, distances and per-shard ndist.

    Calibration feedback, as in the reference: routed dispatches whose key
    (the reference's compiled-signature key, kept here only as warm-call
    bookkeeping) was seen before feed their wall time to the cost model —
    pure-beam calls ``observe_wall``, mixed calls ``observe_wall_mixed``
    (attributed by predicted unit costs) — and the per-shard ndist sums move
    the ``ndist_per_ef`` EMA.  ``plan="graph"`` never calibrates.

    ``vecs``, ``nbrs``, ``rmq``, ``dist_c`` and ``order`` hold one entry per
    shard, the shards in rank order, each with the same number of rows
    (each shard's arrays, or a stacked array with a leading shard axis);
    ``order`` maps a shard's ranks to original corpus ids.  Each shard's
    tensors live on ``mesh.devices[s]``.
    """

    def __init__(self, mesh: ShardMesh, vecs, nbrs, rmq, dist_c, order, *,
                 cache: Optional[SearchCache] = None,
                 metrics: Optional[MetricsRegistry] = None):
        s_count = mesh.size
        if len(vecs) != s_count:
            raise ValueError(f"MeshSubstrate: {len(vecs)} shards of vectors "
                             f"for a mesh of {s_count}")
        self.mesh = mesh
        self._shards = [_Shard(vecs[s], nbrs[s], rmq[s], dist_c[s], order[s],
                               s * len(vecs[0]), dev)
                        for s, dev in enumerate(mesh.devices)]
        per, d = self._shards[0].vecs.shape
        if any(sh.vecs.shape != (per, d) for sh in self._shards):
            raise ValueError("MeshSubstrate: every shard must hold the same "
                             "number of rows")
        self.n_shards, self.per, self.d = s_count, per, d
        self.tb = ROW_TILE
        self.d_pad = -(-d // 128) * 128
        edges = sum(int((sh.nbrs >= 0).sum()) for sh in self._shards)
        self.planner = QueryPlanner(max(per, 1),
                                    edges / (s_count * per) if per else 1.0)
        self.cache = cache
        self.metrics = metrics      # optional MetricsRegistry (obs layer)
        self._x_pad = None          # per-shard padded scan corpora
        self._quant: Dict[str, dict] = {}   # precision -> per-shard slots
        self._live_memo = None      # (mask, per-shard (beam, row) forms)
        self._warm: Set[Tuple] = set()

    @property
    def index_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for sh in self._shards
                   for t in (sh.nbrs, sh.rmq, sh.dist_c))

    # --------------------------------------------------- quantized corpus
    def install_quantized(self, precision: str) -> None:
        """Eagerly build the per-shard quantized corpus copies (lazy build
        on first quantized request otherwise).  Rebuilding changes what
        non-f32 requests score against, so the mesh cache segment goes
        cold."""
        if precision != "f32":
            self._quant.pop(precision, None)
            self._quant_for(precision)
            if self.cache is not None:
                self.cache.invalidate_segment("mesh")

    def _quant_for(self, precision: str) -> Optional[dict]:
        """Per-shard quantized slots (lazy, cached): ``data`` (per, d) for
        the beam, ``data_pad`` (per_pad, d_pad) for the scan, and the int8
        ``scale`` / ``scale_pad`` rows.  The int8 scale is computed over the
        **whole** corpus (all shards jointly), so every shard dequantizes
        with the same row and merged distances compare across shards."""
        if precision == "f32":
            return None
        slot = self._quant.get(precision)
        if slot is None:
            dev0 = self.mesh.devices[0]
            qc = quantize_corpus(torch.cat([sh.vecs.to(dev0)
                                            for sh in self._shards]),
                                 precision)
            per_pad = -(-self.per // self.tb) * self.tb
            slot = dict(data=[], data_pad=[], scale=[], scale_pad=[],
                        bytes_per_vector=qc.bytes_per_vector)
            for s, sh in enumerate(self._shards):
                data = qc.data[s * self.per:(s + 1) * self.per].to(
                    sh.device).clone()
                slot["data"].append(data)
                slot["data_pad"].append(torch.nn.functional.pad(
                    data, (0, self.d_pad - self.d, 0, per_pad - self.per)))
                scale = None if qc.scale is None else qc.scale.to(sh.device)
                slot["scale"].append(scale)
                slot["scale_pad"].append(
                    None if scale is None else torch.nn.functional.pad(
                        scale, (0, self.d_pad - self.d), value=1.0))
            self._quant[precision] = slot
        return slot

    def _quant_ops(self, precision: str, s: int):
        """Shard ``s``'s beam ``quant`` operand, or None for f32."""
        slot = self._quant_for(precision)
        return None if slot is None else (slot["data"][s], slot["scale"][s])

    # ------------------------------------------------------- liveness mask
    def _live_shards(self, live):
        """(n,) global rank-space mask -> per shard ((per,) bool for the
        beam, (1, per_pad) int32 row for the scan) on its device, memoized
        by object identity (one immutable array per corpus version)."""
        if live is None:
            return [(None, None)] * self.n_shards
        memo = self._live_memo
        if memo is not None and memo[0] is live:
            return memo[1]
        lv = np.asarray(live, bool)
        if lv.shape != (self.n_shards * self.per,):
            raise ValueError(
                f"live mask shape {lv.shape} does not match corpus "
                f"({self.n_shards * self.per},)")
        lv = lv.reshape(self.n_shards, self.per)
        per_pad = -(-self.per // self.tb) * self.tb
        forms = []
        for s, sh in enumerate(self._shards):
            row = np.zeros((1, per_pad), np.int32)
            row[0, :self.per] = lv[s]
            forms.append((torch.as_tensor(lv[s], device=sh.device),
                          torch.as_tensor(row, device=sh.device)))
        self._live_memo = (live, forms)
        return forms

    def _scan_corpus(self):
        """Row/lane-padded per-shard corpora for the scan kernel (lazy: a
        mesh that never routes to scan skips the copies)."""
        if self._x_pad is None:
            per_pad = -(-self.per // self.tb) * self.tb
            self._x_pad = [torch.nn.functional.pad(
                sh.vecs, (0, self.d_pad - self.d, 0, per_pad - self.per))
                for sh in self._shards]
        return self._x_pad

    # ------------------------------------------------------------- planning
    def _clip_widths(self, lo, hi) -> np.ndarray:
        """(S, Q) shard-local clipped interval widths."""
        w = []
        for sh in self._shards:
            slo, shi = resolve.clip_interval(lo, hi, sh.rank0, self.per)
            w.append(np.clip(shi.astype(np.int64) - slo + 1, 0, None))
        return np.stack(w)

    def plan_strategies(self, lo: np.ndarray, hi: np.ndarray, *, k: int,
                        ef: int, mode: str, beam_width: int = 1,
                        precision: str = "f32"
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Host half of mesh dispatch: (strategy (Q,) int8, lens_eff (Q,)).

        ``lens_eff`` is each query's **widest shard-local clip** of its
        global rank interval: the decision is one per query, shared by
        every shard, and the widest shard is the one whose scan cost the
        dispatch pays."""
        lo = np.asarray(lo, np.int64)
        hi = np.asarray(hi, np.int64)
        lens_eff = (self._clip_widths(lo, hi).max(0) if len(lo)
                    else np.zeros(0, np.int64))
        if mode == "scan":
            return np.full(len(lo), SCAN, np.int8), lens_eff
        if mode == "beam":
            return np.full(len(lo), BEAM, np.int8), lens_eff
        return (self.planner.choose_strategy_batch(lens_eff, k=k, ef=ef,
                                                   beam_width=beam_width,
                                                   precision=precision),
                lens_eff)

    # ---------------------------------------------------------------- run
    def run(self, req: SearchRequest) -> SearchResult:
        """Dispatch one request on the mesh; result ids are original corpus
        ids, merged across shards.  With a cache installed, hit rows skip
        the mesh dispatch entirely.  A ``req.trace`` collects plan /
        dispatch / stitch spans with ``ns="mesh"``."""
        qv = np.asarray(req.queries, np.float32)
        lo = np.asarray(req.lo, np.int64)
        hi = np.asarray(req.hi, np.int64)
        k, ef = int(req.k), max(int(req.ef), int(req.k))
        bw = int(req.beam_width)
        prec = req.precision
        uk = bool(req.use_kernel)
        tr = req.trace
        met = self.metrics
        nq = len(qv)
        if nq == 0:
            return SearchResult(np.zeros((0, k), np.int32),
                                np.zeros((0, k), np.float32),
                                {"strategy": np.zeros(0, np.int8),
                                 "scan_frac": 0.0}, trace=tr)
        if met is not None:
            met.counter("queries_total").inc(nq)
            met.counter("mesh_queries_total").inc(nq)
            met.counter(f"queries_{prec}_total").inc(nq)
        live = req.live
        cache = self.cache
        cache_info = dict(cache_enabled=cache is not None,
                          cache_hits=0, cache_misses=nq, batch_dedup=0)
        if cache is None:
            res = self._run_uncached(qv, lo, hi, k, ef, req.strategy, uk,
                                     bw, prec, trace=tr,
                                     cache_info=cache_info, live=live)
            res.trace = tr
            return res
        # fences stores against invalidate() / invalidate_segment("mesh")
        epoch = cache.epoch_for("mesh")
        cal_epoch = (self.planner.calibration_epoch
                     if req.strategy == "auto" else None)
        keys, hit_rows, miss, dups = cache.split(qv, lo, hi, k, ef,
                                                 req.strategy, uk, ns="mesh",
                                                 beam_width=bw,
                                                 precision=prec,
                                                 cal_epoch=cal_epoch)
        cache_info.update(cache_hits=len(hit_rows), cache_misses=len(miss),
                          batch_dedup=len(dups))
        if met is not None:
            met.counter("cache_hit_rows_total").inc(len(hit_rows))
            met.counter("cache_miss_rows_total").inc(len(miss))
            if dups:
                met.counter("cache_dedup_rows_total").inc(len(dups))
        if len(miss) == 0:
            if tr is not None:          # fully hit: no mesh dispatch at all
                tr.add_span("dispatch", dispatched=0, ns="mesh",
                            **cache_info)
            with maybe_span(tr, "stitch", ns="mesh"):
                res = cache.assemble(nq, k, hit_rows, None, miss)
            res.trace = tr
            return res
        miss_res = self._run_uncached(qv[miss], lo[miss], hi[miss], k, ef,
                                      req.strategy, uk, bw, prec, trace=tr,
                                      cache_info=cache_info, live=live)
        cache.store_batch([keys[i] for i in miss], miss_res, epoch=epoch,
                          cal_epoch=cal_epoch)
        if not hit_rows and not dups:
            miss_res.stats["cache_hits"] = 0
            miss_res.trace = tr
            return miss_res
        with maybe_span(tr, "stitch", ns="mesh"):
            res = cache.assemble(nq, k, hit_rows, miss_res, miss, dups)
        res.trace = tr
        return res

    def _run_uncached(self, qv, lo, hi, k: int, ef: int, mode: str,
                      use_kernel: bool, beam_width: int = 1,
                      precision: str = "f32", trace=None, cache_info=None,
                      live=None) -> SearchResult:
        nq = len(qv)
        met = self.metrics
        widths = (lambda: self._clip_widths(lo, hi)) if trace is not None \
            else (lambda: None)
        if mode == "graph":
            if trace is not None:
                trace.add_span("plan", strategy_mode="graph", chosen="graph",
                               beam_width=beam_width)
            if met is not None:
                met.counter("graph_queries_total").inc(nq)
            with maybe_span(trace, "dispatch") as sp:
                sp.attrs.update(cache_info or {})
                sp.attrs.update(strategy_mode=mode, ns="mesh",
                                dispatched=nq, beam_width=beam_width,
                                precision=precision,
                                shard_clip_widths=widths())
                ids, dists = self._call_graph(qv, lo, hi, k, ef,
                                              calibrate=False,
                                              use_kernel=use_kernel,
                                              beam_width=beam_width,
                                              precision=precision, live=live)
            with maybe_span(trace, "stitch", ns="mesh"):
                res = SearchResult(ids, dists,
                                   {"strategy": np.ones(nq, np.int8),
                                    "scan_frac": 0.0})
            return res
        if trace is None:
            strategy, lens_eff = self.plan_strategies(lo, hi, k=k, ef=ef,
                                                      mode=mode,
                                                      beam_width=beam_width,
                                                      precision=precision)
        else:
            with trace.span("plan") as psp:
                strategy, lens_eff = self.plan_strategies(
                    lo, hi, k=k, ef=ef, mode=mode, beam_width=beam_width,
                    precision=precision)
                sc, bc = self.planner.predict_costs(lens_eff, k=k, ef=ef,
                                                    beam_width=beam_width,
                                                    precision=precision)
                psp.attrs.update(strategy_mode=mode,
                                 strategy=strategy.copy(),
                                 lens_eff=lens_eff.copy(),
                                 beam_width=beam_width, precision=precision,
                                 scan_frac=float((strategy == SCAN).mean()),
                                 predicted_scan_units=sc,
                                 predicted_beam_units=bc)
        scan_idx = np.flatnonzero(strategy == SCAN)
        beam_idx = np.flatnonzero(strategy == BEAM)
        if met is not None:
            met.counter("scan_routed_total").inc(len(scan_idx))
            met.counter("beam_routed_total").inc(len(beam_idx))
        if len(scan_idx) == 0:
            # uniform-beam batch: the planned body would be the graph body
            # plus pow2 padding and a scatter — take the graph body (same
            # ef, same merge, the same results)
            with maybe_span(trace, "dispatch") as sp:
                sp.attrs.update(cache_info or {})
                sp.attrs.update(strategy_mode=mode, ns="mesh",
                                dispatched=nq, beam_width=beam_width,
                                precision=precision,
                                uniform_beam_fast_path=True,
                                shard_clip_widths=widths())
                ids, dists = self._call_graph(qv, lo, hi, k, ef,
                                              calibrate=True,
                                              use_kernel=use_kernel,
                                              beam_width=beam_width,
                                              precision=precision, live=live)
            with maybe_span(trace, "stitch", ns="mesh"):
                res = SearchResult(ids, dists,
                                   {"strategy": strategy, "scan_frac": 0.0})
            return res
        # one shared bucket covers every scan query's widest shard-local
        # clip (never truncates)
        cap = next_pow2(self.per)
        bucket = max(bucket_for_len(
            int(ln), min_bucket=self.planner.min_bucket, max_bucket=cap)
            for ln in lens_eff[scan_idx])
        pad_s = pad_pow2(len(scan_idx))
        pad_b = pad_pow2(len(beam_idx)) if len(beam_idx) else 0
        use_live = live is not None
        key = ("planned", k, ef, bucket, pad_s, pad_b, nq, beam_width,
               precision, use_live)
        warm = key in self._warm
        self._warm.add(key)
        slot = self._quant_for(precision)
        if slot is None:
            x_scan, scale_pad = self._scan_corpus(), [None] * self.n_shards
        else:
            x_scan, scale_pad = slot["data_pad"], slot["scale_pad"]
        host_ops = (self._group_operands(qv, lo, hi, scan_idx, pad_s, nq,
                                         lane_pad=True)
                    + self._group_operands(qv, lo, hi, beam_idx, pad_b, nq,
                                           lane_pad=False))
        pad_rows = (pad_s - len(scan_idx)) + (pad_b - len(beam_idx))
        if met is not None and pad_rows:
            met.counter("pad_rows_total").inc(pad_rows)
        t0 = time.perf_counter()
        with maybe_span(trace, "dispatch") as sp:
            sp.attrs.update(cache_info or {})
            sp.attrs.update(strategy_mode=mode, ns="mesh", dispatched=nq,
                            beam_width=beam_width, warm=warm, bucket=bucket,
                            precision=precision, pad_scan=pad_s,
                            pad_beam=pad_b, pad_rows=pad_rows,
                            shard_clip_widths=widths())
            with annotate("rnsg.mesh_planned_dispatch"):
                dev_ops = {dev: upload(host_ops, dev, pinned=True)
                           for dev in self.mesh.distinct}
                lives = self._live_shards(live)

                def body(s, dev):
                    ops = dev_ops[dev]
                    return _shard_planned(
                        self._shards[s], x_scan[s], scale_pad[s], ops[:4],
                        ops[4:], k=k, ef=ef, bucket=bucket, nq=nq,
                        has_beam=pad_b > 0, use_kernel=use_kernel,
                        beam_width=beam_width, precision=precision,
                        quant=self._quant_ops(precision, s),
                        live_row=lives[s][1], live_beam=lives[s][0])
                ids, dists, nd_g = self._merge(shard_map(body, self.mesh), k)
        dt = time.perf_counter() - t0
        if met is not None:
            met.histogram("mesh_dispatch_ms").observe(dt * 1e3)
        if warm:
            # one dispatch over both groups: attribute the wall time across
            # them by their predicted unit costs.  Scan lanes count the
            # pow2 padding (empty windows still scan their fixed-shape
            # blocks); beam lanes only the real queries (pad lanes carry
            # empty windows and stop at once)
            n_beam = len(beam_idx)
            self.planner.cost.observe_wall_mixed(
                window_rows(bucket, self.tb) * pad_s,
                self.planner.cost.ndist_per_ef_at(beam_width) * ef * n_beam,
                dt, pad_s, n_beam, precision=precision)
            if n_beam:
                # per-shard ndist sums (pad lanes 0): the signal that moves
                # the mesh path's ndist EMA
                self.planner.cost.update_beam(float(nd_g.mean()) / n_beam,
                                              ef, beam_width=beam_width)
        with maybe_span(trace, "stitch", ns="mesh"):
            res = SearchResult(ids, dists, {"strategy": strategy,
                                            "scan_frac": len(scan_idx) / nq})
        return res

    def _call_graph(self, qv, lo, hi, k: int, ef: int, *, calibrate: bool,
                    use_kernel: bool, beam_width: int = 1,
                    precision: str = "f32", live=None):
        """One graph-body mesh dispatch (+ warm-call beam calibration for
        routed uniform-beam batches: wall time and the per-shard ndist feed
        the cost model)."""
        use_live = live is not None
        key = ("graph", k, max(ef, k), beam_width, precision, use_live)
        warm = key in self._warm
        self._warm.add(key)
        t0 = time.perf_counter()
        with annotate("rnsg.mesh_graph_dispatch"):
            host_ops = [qv, np.asarray(lo).astype(np.int32),
                        np.asarray(hi).astype(np.int32)]
            dev_ops = {dev: upload(host_ops, dev, pinned=True)
                       for dev in self.mesh.distinct}
            lives = self._live_shards(live)

            def body(s, dev):
                q_j, lo_j, hi_j = dev_ops[dev]
                return _shard_graph(self._shards[s], q_j, lo_j, hi_j, k=k,
                                    ef=max(ef, k), use_kernel=use_kernel,
                                    beam_width=beam_width,
                                    quant=self._quant_ops(precision, s),
                                    live=lives[s][0])
            ids, dists, nd_g = self._merge(shard_map(body, self.mesh), k)
        dt = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.histogram("mesh_dispatch_ms").observe(dt * 1e3)
        if calibrate and warm:
            # both feeds normalize by the NON-EMPTY row count: forced-beam
            # batches may carry empty intervals, which stop at once and
            # would bias the wall-per-unit estimate and the ndist EMA
            n_real = int((np.asarray(lo) <= np.asarray(hi)).sum())
            if n_real:
                self.planner.cost.observe_wall(
                    "beam",
                    max(self.planner.cost.ndist_per_ef_at(beam_width) * ef,
                        1.0), dt, n_real, precision=precision)
                self.planner.cost.update_beam(float(nd_g.mean()) / n_real,
                                              ef, beam_width=beam_width)
        return ids, dists

    def _merge(self, parts, k: int):
        """Per-shard (ids, dists, ndist) -> the merged (Q, k) ids and
        distances and the (S,) ndist sums, gathered and merged on the
        mesh's first device, then brought to the host in one copy."""
        ids_g = all_gather([p[0] for p in parts], self.mesh)   # (S, Q, k)
        ds_g = all_gather([p[1] for p in parts], self.mesh)
        nd_g = all_gather([p[2] for p in parts], self.mesh)    # (S,)
        ids, dists = merge_topk(ids_g, ds_g, k)
        q = ids.shape[0]
        packed = torch.cat([ids.reshape(-1).to(torch.int32),
                            dists.reshape(-1).view(torch.int32),
                            nd_g.to(torch.int32)]).cpu().numpy()
        return (packed[:q * k].reshape(q, k),
                packed[q * k:2 * q * k].view(np.float32).reshape(q, k),
                packed[2 * q * k:].astype(np.int64))

    # ------------------------------------------------------------ operands
    def _group_operands(self, qv, lo, hi, idx, pad: int, nq: int, *,
                        lane_pad: bool):
        """One strategy group's host operands: queries (pow2-padded),
        global rank interval, and scatter destinations.  Pads carry empty
        windows (lo=1 > hi=0 — masked in the scan, an immediate stop in the
        beam) and scatter into the sink row ``nq``."""
        m = len(idx)
        qd = self.d_pad if lane_pad else self.d
        g_q = np.zeros((pad, qd), np.float32)
        g_lo = np.ones(pad, np.int32)
        g_hi = np.zeros(pad, np.int32)
        dst = np.full(pad, nq, np.int32)
        if m:
            g_q[:m, :self.d] = qv[idx]
            g_lo[:m] = lo[idx]
            g_hi[:m] = hi[idx]
            dst[:m] = idx
        return [g_q, g_lo, g_hi, dst]

"""Batched RFANN serving engine: dynamic batching over a request queue,
with a pipelined resolve/dispatch pair and an optional shared result cache
(host code, the reference's ``repro.serving.engine``).  The dispatch thread
runs each batch through the index's ``search_ranks`` without a
``use_kernel``, which the index resolves by its device: the fused kernels
on the card, their plain versions on the CPU.

Requests (query vector + attribute range) are coalesced into batches of up to
``max_batch`` or ``max_wait_ms`` and flow through a **two-stage pipeline**:

* resolver stage — forms the dynamic batch and runs the host-side resolve
  (attribute ranges -> global rank intervals, a ``searchsorted`` over the
  sorted attribute array) on its own thread;
* dispatch stage — executes the resolved batch through the unified search
  substrate (``index.search_ranks``; under ``plan="auto"`` each batch is
  partitioned into fused range-scan and beam-search dispatches by
  selectivity — see ``repro_torch.planner``) and resolves the per-request futures.

The stages overlap: while batch N occupies the device, batch N+1 is already
batched and resolved, so resolve latency is off the critical path under
load.  A bounded hand-off queue provides backpressure (the resolver stalls
rather than racing ahead of the device).

``cache_bytes > 0`` installs a shared ``SearchCache`` at the substrate choke
point: repeat (query, range, k, ef, strategy) rows are served from memory
with no device work.  ``swap_index`` hot-swaps the served index and
invalidates the cache in the same lock — cached rows reference the old
corpus and must never survive a swap.

If ``calibration_path`` is given, the planner's online-calibrated cost model
is restored from it at startup and persisted (atomically: temp file +
rename) at ``close()`` — a restarted server starts from steady-state
routing instead of the prior, and a crash mid-shutdown can never leave a
truncated file behind.  ``index_path`` does the same for the index itself:
``close()`` writes the served index (graph + quantized corpora + streaming
segment state) to the sharded directory format (``repro_torch.index.io``), which
``launch/serve --index-path`` restores at the next startup instead of
rebuilding.

Observability: the engine owns a ``MetricsRegistry`` (``repro_torch.obs``) —
pass one in to share it, or read the default via :meth:`metrics`.  It is
installed on the index (and re-installed on ``swap_index``) so substrate
counters/histograms land in the same snapshot, and the engine itself
records end-to-end latency/batch-size histograms, queue-depth gauges, and
pull-side producers for the cache, the cost model, and its own summary.
``trace_sample_every=N`` attaches a ``QueryTrace`` to every Nth batch
(resolver times the resolve span, the substrate fills plan/dispatch/stitch)
and parks the finished trace on :attr:`last_trace`; ``log_interval_s > 0``
prints a one-line stats summary from the dispatch thread at that cadence.
"""
from __future__ import annotations

import os
import queue
import random
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.obs import MetricsRegistry, QueryTrace, format_stats_line


@dataclass
class EngineStats:
    """Bounded: latencies are a fixed-size uniform reservoir (Vitter's
    Algorithm R), so a long-running server keeps O(1) memory while the
    percentile summary stays an unbiased estimate of the full stream."""
    served: int = 0
    batches: int = 0
    scan_routed: int = 0
    cache_hits: int = 0
    dedup_hits: int = 0     # intra-batch duplicate rows served by one dispatch
    reservoir_size: int = 4096
    latencies_ms: List[float] = field(default_factory=list)
    lat_seen: int = 0
    _rng: random.Random = field(default_factory=lambda: random.Random(0),
                                repr=False)

    def record_latency(self, ms: float) -> None:
        self.lat_seen += 1
        if len(self.latencies_ms) < self.reservoir_size:
            self.latencies_ms.append(ms)
        else:
            j = self._rng.randrange(self.lat_seen)
            if j < self.reservoir_size:
                self.latencies_ms[j] = ms

    def summary(self) -> dict:
        # percentiles from an EMPTY reservoir are reported as 0.0, not a
        # percentile of a fake zero sample — lat_seen disambiguates
        lat = np.asarray(self.latencies_ms) if self.latencies_ms else np.zeros(1)
        return dict(served=self.served, batches=self.batches,
                    mean_batch=self.served / max(self.batches, 1),
                    scan_frac=self.scan_routed / max(self.served, 1),
                    cache_hit_frac=self.cache_hits / max(self.served, 1),
                    dedup_hits=self.dedup_hits,
                    dedup_frac=self.dedup_hits / max(self.served, 1),
                    lat_seen=self.lat_seen,
                    p50_ms=float(np.percentile(lat, 50)),
                    p90_ms=float(np.percentile(lat, 90)),
                    p95_ms=float(np.percentile(lat, 95)),
                    p99_ms=float(np.percentile(lat, 99)))


class RFANNEngine:
    def __init__(self, index, *, k: int = 10, ef: int = 64,
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 plan: str = "auto", beam_width: int = 1,
                 precision: str = "f32",
                 calibration_path: Optional[str] = None,
                 cache_bytes: int = 0,
                 pipeline_depth: int = 2,
                 metrics: Optional[MetricsRegistry] = None,
                 log_interval_s: float = 0.0,
                 trace_sample_every: int = 0,
                 max_delta: Optional[int] = None,
                 compact_every: Optional[int] = None,
                 index_path: Optional[str] = None,
                 index_save_shards: int = 1,
                 wal_dir: Optional[str] = None,
                 wal_sync: str = "batch"):
        self.index = index
        self.k, self.ef = k, ef
        self.plan = plan
        self.index_path = index_path
        self.index_save_shards = int(index_save_shards)
        self.beam_width = int(beam_width)
        self.precision = str(precision)
        if self.precision != "f32" and hasattr(index, "install_quantized"):
            index.install_quantized(self.precision)   # pay build cost once
        if ((max_delta is not None or compact_every is not None)
                and hasattr(index, "set_compaction_policy")):
            index.set_compaction_policy(max_delta=max_delta,
                                        compact_every=compact_every)
        if wal_dir and hasattr(index, "attach_wal"):
            # append-before-apply durability for every mutation delegated
            # through insert()/delete(); a no-op when the caller already
            # attached (e.g. StreamingRFANN.recover on the same directory)
            index.attach_wal(wal_dir, sync=wal_sync)
            if index_path and hasattr(index, "set_checkpoint_path"):
                # register (and ensure) the checkpoint the WAL replays onto
                # — compactions auto-checkpoint + GC the log behind it
                index.set_checkpoint_path(index_path,
                                          shards=self.index_save_shards)
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.calibration_path = calibration_path
        self.registry = metrics if metrics is not None else MetricsRegistry()
        self.log_interval = float(log_interval_s)
        self.trace_sample_every = int(trace_sample_every)
        self.last_trace: Optional[QueryTrace] = None
        self._batch_seq = 0
        self._last_log = time.perf_counter()
        if calibration_path and os.path.exists(calibration_path):
            planner = getattr(index, "planner", None)
            if planner is not None:
                try:
                    planner.load_calibration(calibration_path)
                except ValueError as e:     # stale schema / wrong corpus:
                    import warnings         # serve from the prior instead
                    warnings.warn(f"ignoring calibration: {e}")
        self.cache = None
        if cache_bytes:
            from repro_torch.search import SearchCache
            self.cache = SearchCache(max_bytes=cache_bytes)
            if hasattr(index, "install_cache"):
                index.install_cache(self.cache)
        self._q: queue.Queue = queue.Queue()
        # bounded hand-off between the two stages: the resolver pre-resolves
        # at most `pipeline_depth` batches ahead of the device
        self._dq: queue.Queue = queue.Queue(maxsize=max(pipeline_depth, 1))
        self._stop = threading.Event()
        self._index_lock = threading.Lock()
        self.stats = EngineStats()
        # bound the hot-path metric handles once (get-or-create is locked;
        # the loops below only touch per-metric locks)
        reg = self.registry
        self._m_requests = reg.counter("engine_requests_total",
                                       "requests served end to end")
        self._m_batches = reg.counter("engine_batches_total",
                                      "dynamic batches dispatched")
        self._m_e2e = reg.histogram("engine_e2e_ms",
                                    "submit -> result wall time (ms)")
        self._m_batch_size = reg.histogram("engine_batch_size",
                                           "dynamic batch sizes",
                                           lo=1.0, hi=8192.0, growth=1.25)
        self._m_resolve = reg.histogram("engine_resolve_ms",
                                        "host-side resolve wall time (ms)")
        self._m_qdepth = reg.gauge("engine_queue_depth",
                                   "requests waiting to be batched")
        self._m_hdepth = reg.gauge("engine_handoff_depth",
                                   "resolved batches waiting for dispatch")
        if hasattr(index, "install_metrics"):
            index.install_metrics(reg)
        if self.cache is not None:
            reg.register_producer("cache", self.cache.snapshot)
        reg.register_producer("cost_model", self._cost_snapshot)
        reg.register_producer("engine", self.stats.summary)
        self._resolver = threading.Thread(target=self._resolve_loop,
                                          daemon=True)
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._resolver.start()
        self._dispatcher.start()

    # ------------------------------------------------------------------
    def _cost_snapshot(self) -> dict:
        """Pull-side cost-model producer — reads the *live* index so a
        ``swap_index`` transparently switches whose calibration is exported."""
        planner = getattr(self.index, "planner", None)
        return planner.cost.snapshot() if planner is not None else {}

    def metrics(self) -> dict:
        """One JSON-able snapshot: every counter/gauge/histogram (with
        p50/p90/p99) plus the pull-side sections (``engine``, ``cache``,
        ``cost_model``).  Prometheus text comes from
        ``repro_torch.obs.to_prometheus(engine.registry)``."""
        return self.registry.snapshot()

    # ------------------------------------------------------------------
    def submit(self, query: np.ndarray, attr_range: Tuple[float, float]) -> Future:
        fut: Future = Future()
        self._q.put((np.asarray(query, np.float32),
                     np.asarray(attr_range, np.float32), time.perf_counter(), fut))
        return fut

    def swap_index(self, new_index, *, segment=None) -> None:
        """Hot-swap the served index.  The result cache is detached from the
        old index, invalidated, and installed on the new one — cached rows
        hold corpus ids of the *old* index and must never be served
        afterwards.  A dispatch already in flight on the old index is fenced
        by the cache's epoch (captured at its hit/miss split, checked under
        the store lock), so its late stores are dropped rather than
        repopulating the cache with old-corpus rows.

        ``segment=<ns>`` scopes the invalidation to one cache namespace
        (``SearchCache.invalidate_segment``): a streaming compaction swaps
        only the base segment, so only base-keyed rows go cold — any other
        namespace sharing the cache keeps its rows."""
        with self._index_lock:
            old = self.index
            if self.cache is not None:
                if old is not new_index and hasattr(old, "install_cache"):
                    old.install_cache(None)     # old index: cache off
                if segment is None:
                    self.cache.invalidate()
                else:
                    self.cache.invalidate_segment(segment)
            self.index = new_index
            if self.cache is not None and hasattr(new_index, "install_cache"):
                new_index.install_cache(self.cache)
            if old is not new_index:
                if hasattr(old, "install_metrics"):
                    old.install_metrics(None)
                if hasattr(new_index, "install_metrics"):
                    new_index.install_metrics(self.registry)

    # ------------------------------------------------- streaming delegation
    def insert(self, vector: np.ndarray, attr: float, ext_id=None) -> int:
        """Delegate one insert to a streaming index (``StreamingRFANN``).
        The index publishes a new snapshot atomically, so in-flight batches
        keep their captured view; no cache action is needed (delta results
        are never cached)."""
        with self._index_lock:
            index = self.index
        return index.insert(vector, attr, ext_id)

    def delete(self, ext_id: int) -> None:
        """Delegate one delete to a streaming index.  The index owns the
        base-segment cache invalidation (per-segment epoch bump)."""
        with self._index_lock:
            index = self.index
        index.delete(ext_id)

    # ------------------------------------------------------- stage 1: batch+resolve
    def _resolve_loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            qv = np.stack([b[0] for b in batch])
            rg = np.stack([b[1] for b in batch])
            self._m_qdepth.set(self._q.qsize())
            with self._index_lock:          # only the reference needs the
                index = self.index          # lock — never resolve under it,
            # the dispatcher takes it per batch and would stall behind us
            self._batch_seq += 1
            trace = (QueryTrace()
                     if self.trace_sample_every
                     and self._batch_seq % self.trace_sample_every == 0
                     else None)
            t_res = time.perf_counter()
            lo, hi = (index.rank_range(rg)
                      if hasattr(index, "rank_range") else (None, None))
            resolve_ms = (time.perf_counter() - t_res) * 1e3
            self._m_resolve.observe(resolve_ms)
            if trace is not None:
                trace.add_span("resolve", wall_ms=resolve_ms, q=len(batch),
                               stage="engine_resolver")
            item = (batch, qv, rg, lo, hi, index, trace)
            enqueued = False
            while not self._stop.is_set():  # bounded queue: backpressure
                try:
                    self._dq.put(item, timeout=0.05)
                    enqueued = True
                    break
                except queue.Full:
                    continue
            if not enqueued:                # shutdown raced the hand-off:
                self._fail_batch(batch)     # never leave futures hanging

    # ------------------------------------------------------- stage 2: dispatch
    def _dispatch_loop(self):
        while not self._stop.is_set() or not self._dq.empty():
            try:
                batch, qv, rg, lo, hi, r_index, trace = \
                    self._dq.get(timeout=0.05)
            except queue.Empty:
                continue
            self._m_hdepth.set(self._dq.qsize())
            with self._index_lock:
                index = self.index
            # beam_width=1 is omitted so indexes predating the batched-
            # expansion API (baselines, external wrappers) keep working
            kw = dict(k=self.k, ef=self.ef, plan=self.plan)
            if self.beam_width != 1:
                kw["beam_width"] = self.beam_width
            if self.precision != "f32":     # same omission back-compat rule
                kw["precision"] = self.precision
            if trace is not None:
                kw["trace"] = trace
            try:
                res = self._run_search(index, qv, rg, lo, hi, r_index, kw)
            except TypeError:
                if "trace" not in kw:       # genuine signature error
                    raise
                kw.pop("trace")             # index predates the trace API
                res = self._run_search(index, qv, rg, lo, hi, r_index, kw)
            if not hasattr(res, "row"):     # tuple-returning index
                from repro_torch.search import SearchResult
                res = SearchResult(np.asarray(res[0]), np.asarray(res[1]), {})
            if "strategy" in res.stats:
                from repro_torch.planner import SCAN
                self.stats.scan_routed += int(
                    (np.asarray(res.stats["strategy"]) == SCAN).sum())
            self.stats.cache_hits += int(res.stats.get("cache_hits", 0))
            self.stats.dedup_hits += int(res.stats.get("batch_dedup", 0))
            now = time.perf_counter()
            lats = [(now - t0) * 1e3 for (_, _, t0, _) in batch]
            # account BEFORE resolving futures: a client that holds its
            # result must see the stats/metrics that include its request
            for ms in lats:
                self.stats.record_latency(ms)
            self.stats.served += len(batch)
            self.stats.batches += 1
            self._m_e2e.observe_many(lats)
            self._m_batch_size.observe(len(batch))
            self._m_requests.inc(len(batch))
            self._m_batches.inc()
            if trace is not None:
                self.last_trace = trace
            for i, (_, _, _, fut) in enumerate(batch):
                fut.set_result(res.row(i))
            if self.log_interval and now - self._last_log >= self.log_interval:
                self._last_log = now
                print(format_stats_line(self.metrics()), flush=True)

    def _run_search(self, index, qv, rg, lo, hi, r_index, kw):
        if index is not r_index or lo is None:
            # swapped between the stages (or no rank-space entry point):
            # re-resolve against the live index
            return index.search(qv, rg, **kw)
        return index.search_ranks(qv, lo, hi, **kw)

    @staticmethod
    def _fail_batch(batch) -> None:
        for _, _, _, fut in batch:
            if not fut.done():
                fut.set_exception(RuntimeError("engine closed before "
                                               "this request was served"))

    def close(self):
        self._stop.set()
        self._resolver.join(timeout=2.0)
        self._dispatcher.join(timeout=2.0)
        # fail anything still queued (a blocked ``Future.result()`` with no
        # timeout must never hang on a closed engine)
        while True:
            try:
                batch, *_ = self._dq.get_nowait()
            except queue.Empty:
                break
            self._fail_batch(batch)
        while True:
            try:
                q_, rg_, t0_, fut = self._q.get_nowait()
            except queue.Empty:
                break
            self._fail_batch([(q_, rg_, t0_, fut)])
        if self.calibration_path:
            planner = getattr(self.index, "planner", None)
            if planner is not None:
                planner.save_calibration(self.calibration_path)
        if self.index_path:
            # persist the served index (sharded directory format) so the
            # next startup restores in seconds instead of rebuilding —
            # save_index snapshots under the index lock, so a streaming
            # index racing mutations/compaction saves a consistent view.
            # A WAL-attached streaming index goes through checkpoint()
            # instead, which also writes the barrier record and GCs log
            # segments the snapshot covers.
            if hasattr(self.index, "checkpoint"):
                self.index.checkpoint(self.index_path,
                                      shards=self.index_save_shards)
            else:
                from repro_torch.index import io
                io.save_index(self.index, self.index_path,
                              shards=self.index_save_shards)

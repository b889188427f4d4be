"""Streaming RFANN: a mutable delta segment layered over the immutable
attribute-sorted RNSG base, with tombstoned deletes and background
compaction — the reference's ``repro.streaming.streaming`` on one device.

The segments' rows live on the host (numpy, as in the reference, so the
checkpoint's arrays and ``live_items()`` are its own); the base's graph and
corpus live on the index's device in its ``SearchSubstrate``, and the
delta's padded copy in its ``DeltaView``.  The compaction worker rebuilds
the base with ``build_rnsg`` on that device.

Segment lifecycle (FreshDiskANN-style window-to-window):

* **base** — an RNSG graph over a frozen snapshot, served through the
  unified ``SearchSubstrate``.  Deletes of base points flip a per-rank
  ``live`` bit (copy-on-write mask, threaded into the kernels as an
  operand): dead nodes remain *traversable* routing nodes for the beam —
  the graph stays navigable — but never leave a search.
* **delta** — a brute-force attribute-sorted buffer (``DeltaView``)
  absorbing inserts, searched exactly via the ``range_scan`` kernel.
  Delta deletes remove the row physically.
* **compaction** — when the delta or the tombstone count outgrows policy,
  a worker thread rebuilds the base from the live set (``build_rnsg`` is
  deterministic: stable attribute argsort over ``live_items()`` order), and
  a short locked swap publishes it.  Mutations that landed during the
  rebuild survive: inserts stay in a residual delta, deletes become
  tombstones on the new base.

Consistency: every search captures one immutable ``SegmentView`` — base
substrate, live mask, delta snapshot — so queries racing mutations or the
compaction swap see a point-in-time corpus, never a torn one.  Per-query
results from both segments combine through the shared ``merge_topk``.

Cache invariant: the live mask is **corpus state, not cache-key state**.
The streaming layer owns a ``SearchCache`` segment (namespace ``"base"``)
and bumps its per-segment epoch (``invalidate_segment``) on every
base-tombstone change and on every compaction; delta results are never
cached.  A compaction therefore invalidates *only* base-keyed rows — other
namespaces sharing the cache (e.g. a co-served static index) keep theirs.

Durability: with ``wal_dir`` set (constructor
kwarg or :meth:`attach_wal`) every mutation is appended to a checksummed
write-ahead log *before* it is applied, so
:meth:`StreamingRFANN.recover` can restore the last checkpoint
(``repro_torch.index.io``) and replay the uncompacted tail after a crash.
:meth:`checkpoint` persists a snapshot, writes a ``BARRIER`` record after
the manifest-last commit, and garbage-collects WAL segments the
checkpoint covers; a WAL append failure flips the index to **read-only**
(mutations raise :class:`ReadOnlyIndexError`, the ``stream_read_only``
gauge goes to 1) instead of acknowledging writes it cannot recover.
"""
from __future__ import annotations

import threading
import time
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.construction import build_rnsg
from repro_torch.device import resolve_device, resolve_use_kernel
from repro_torch.search import (SearchRequest, SearchResult, SearchSubstrate,
                                merge_topk)
from repro_torch.streaming import wal as walmod
from repro_torch.streaming.delta import DeltaView
from repro_torch.streaming.wal import WALError, WriteAheadLog

BASE_NS = "base"        # the cache namespace every base dispatch keys under


class ReadOnlyIndexError(RuntimeError):
    """A mutation was rejected because the index degraded to read-only
    serving (its WAL could no longer make writes durable).  Searches keep
    working; the serve loop reports the error instead of crashing."""


class SegmentView:
    """One immutable published snapshot of the two-segment corpus."""

    __slots__ = ("sub", "base_vecs", "base_attrs", "base_ids", "base_live",
                 "n_tombstones", "delta", "version")

    def __init__(self, sub: SearchSubstrate, base_vecs, base_attrs, base_ids,
                 base_live, n_tombstones: int, delta: DeltaView,
                 version: int):
        self.sub = sub
        self.base_vecs = base_vecs      # (nb, d) f32, rank order
        self.base_attrs = base_attrs    # (nb,) f32 ascending
        self.base_ids = base_ids        # (nb,) int32 external ids
        self.base_live = base_live      # (nb,) bool — False = tombstoned
        self.n_tombstones = n_tombstones
        self.delta = delta
        self.version = version

    @property
    def n_live(self) -> int:
        return int(len(self.base_ids)) - self.n_tombstones + self.delta.count


class StreamingRFANN:
    """Streaming wrapper: RNSG base + brute-force delta + compaction.

    Deliberately exposes **no** ``rank_range`` — ranks shift with every
    mutation, so the engine's pipelined resolver must not resolve ahead of
    the snapshot; ``RFANNEngine`` detects this and falls back to
    ``search(queries, attr_ranges)``, which resolves both segments
    atomically under one captured view.
    """

    def __init__(self, vectors: np.ndarray, attrs: np.ndarray, *,
                 ids: Optional[np.ndarray] = None,
                 max_delta: int = 1024, compact_every: int = 0,
                 wal_dir: Optional[str] = None, wal_sync: str = "batch",
                 wal_fsync_every_n: int = 64,
                 wal_fsync_interval_s: float = 0.05, device=None,
                 **build_kw):
        """Build the base on ``device`` (default the card) with
        ``build_rnsg``'s ``build_kw``."""
        vectors = np.asarray(vectors, np.float32)
        attrs = np.asarray(attrs, np.float32)
        n, d = vectors.shape
        ext = (np.arange(n, dtype=np.int32) if ids is None
               else np.asarray(ids, np.int32))
        self.d = d
        self.device = resolve_device(device)
        self._build_kw = dict(build_kw)
        self._lock = threading.RLock()
        self._cache = None
        self._metrics = None
        self._precisions: set = set()
        self._init_mutable_defaults()
        self.set_compaction_policy(max_delta=max_delta,
                                   compact_every=compact_every)
        self._next_id = int(ext.max()) + 1 if n else 0
        self._view = self._build_view(vectors, attrs, ext,
                                      DeltaView.empty(d, self.device),
                                      version=0)
        self._id_loc: Dict[int, int] = {}   # ext id -> base rank | -1 (delta)
        self._reindex(self._view)
        if wal_dir is not None:
            self.attach_wal(wal_dir, sync=wal_sync,
                            fsync_every_n=wal_fsync_every_n,
                            fsync_interval_s=wal_fsync_interval_s)

    def _init_mutable_defaults(self) -> None:
        """State shared by ``__init__`` and ``from_state``."""
        self.max_delta = 1024
        self.compact_every = 0
        self._ops_since_compact = 0
        self._compacting = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self.compactions = 0
        self.build_seconds = 0.0
        self._wal: Optional[WriteAheadLog] = None
        self._ckpt_path: Optional[str] = None
        self._ckpt_shards = 1
        self.applied_lsn = 0        # checkpoint watermark: highest applied
        self.read_only = False
        self.read_only_reason = ""
        self._replaying = False

    # ------------------------------------------------------------ restore
    @classmethod
    def from_state(cls, *, base_vecs, base_attrs, base_ids, base_live,
                   base_nbrs, base_rmq, base_dist_c,
                   delta_vecs, delta_attrs, delta_ids,
                   next_id: int, max_delta: int = 1024,
                   compact_every: int = 0, precisions=(),
                   build_kw=None, wal_lsn: int = 0,
                   device=None) -> "StreamingRFANN":
        """Rehydrate from checkpointed segment state
        (``repro_torch.index.io``) onto ``device`` (default the card)
        **without rebuilding the base graph** — the saved adjacency / RMQ /
        entry arrays go straight into a fresh ``SearchSubstrate``, so
        restore cost is array upload, not construction.

        ``precisions`` are recorded for compaction re-install; the caller
        preloads saved quantized corpora via ``sub.preload_quantized`` (or
        first quantized use lazily rebuilds them — identical either way,
        quantization is deterministic in the base vectors).  Tombstones and
        the delta snapshot resume exactly; compaction counters restart at
        zero (they are run-scoped observability, not corpus state)."""
        base_vecs = np.asarray(base_vecs, np.float32)
        self = cls.__new__(cls)
        self.d = int(base_vecs.shape[1])
        self.device = resolve_device(device)
        self._build_kw = dict(build_kw or {})
        self._lock = threading.RLock()
        self._cache = None
        self._metrics = None
        self._precisions = set(precisions)
        self._init_mutable_defaults()
        self.set_compaction_policy(max_delta=max_delta,
                                   compact_every=compact_every)
        self.applied_lsn = int(wal_lsn)
        base_ids = np.asarray(base_ids, np.int32)
        sub = SearchSubstrate(base_vecs, base_nbrs, base_rmq, base_dist_c,
                              order=base_ids, attrs=base_attrs,
                              device=self.device, cache=None,
                              cache_ns=BASE_NS, metrics=None)
        delta = DeltaView(np.asarray(delta_vecs, np.float32),
                          np.asarray(delta_attrs, np.float32),
                          np.asarray(delta_ids, np.int32), self.device)
        live = np.asarray(base_live, bool)
        self._view = SegmentView(sub, base_vecs,
                                 np.asarray(base_attrs, np.float32),
                                 base_ids, live, int((~live).sum()),
                                 delta, version=0)
        self._next_id = int(next_id)
        self._id_loc = {}
        self._reindex(self._view)
        return self

    # ------------------------------------------------------------ builders
    def _build_view(self, vectors, attrs, ext_ids, delta: DeltaView, *,
                    version: int, old_sub: Optional[SearchSubstrate] = None,
                    base_live: Optional[np.ndarray] = None) -> SegmentView:
        """Build an RNSG base over (vectors, attrs) and wrap it in a view.
        ``build_rnsg`` stable-sorts by attribute, so the result — and every
        search over it — is a deterministic function of the input order."""
        g = build_rnsg(vectors, attrs, device=self.device, **self._build_kw)
        self.build_seconds += g.build_seconds
        base_ids = np.asarray(ext_ids, np.int32)[g.order.cpu().numpy()]
        sub = SearchSubstrate(g.vecs, g.nbrs, g.rmq, g.dist_c,
                              order=base_ids, attrs=g.attrs,
                              device=self.device, cache=self._cache,
                              cache_ns=BASE_NS, metrics=self._metrics)
        if old_sub is not None:     # carry the calibrated cost model across
            sub.planner.cost = old_sub.planner.cost
            sub.planner.calibration_epoch = old_sub.planner.calibration_epoch
        for prec in self._precisions:
            sub.install_quantized(prec)
        if base_live is None:
            base_live = np.ones(len(base_ids), bool)
        return SegmentView(sub, g.vecs.cpu().numpy(), g.attrs.cpu().numpy(),
                           base_ids, base_live, int((~base_live).sum()),
                           delta, version)

    def _reindex(self, v: SegmentView) -> None:
        loc = {int(e): r for r, e in enumerate(v.base_ids)
               if v.base_live[r]}
        for e in v.delta.ids:
            loc[int(e)] = -1
        self._id_loc = loc

    # ----------------------------------------------------------- plumbing
    @property
    def planner(self):
        return self._view.sub.planner

    def install_cache(self, cache) -> None:
        with self._lock:
            self._cache = cache
            self._view.sub.cache = cache

    def install_metrics(self, metrics) -> None:
        with self._lock:
            self._metrics = metrics
            self._view.sub.metrics = metrics
            if metrics is not None:
                m = metrics
                self._m_ins = m.counter("stream_inserts_total",
                                        "streaming inserts")
                self._m_del = m.counter("stream_deletes_total",
                                        "streaming deletes")
                self._m_comp = m.counter("stream_compactions_total",
                                         "delta->base compactions")
                self._m_dsize = m.gauge("stream_delta_size",
                                        "rows in the delta segment")
                self._m_tomb = m.gauge("stream_tombstones",
                                       "tombstoned base rows")
                self._m_dfrac = m.histogram(
                    "stream_delta_frac",
                    "delta fraction of the live corpus at search time",
                    lo=1e-4, hi=1.0, growth=1.5)
                self._m_pause = m.histogram(
                    "stream_compaction_pause_ms",
                    "locked swap pause per compaction (ms)")
                self._m_build = m.histogram(
                    "stream_compaction_build_ms",
                    "off-lock rebuild wall per compaction (ms)")
                self._m_ro = m.gauge(
                    "stream_read_only",
                    "1 when mutations are rejected (WAL append failed)")
                self._m_ro.set(1 if self.read_only else 0)
                m.register_producer("streaming", self.stats)
                if self._wal is not None:
                    m.register_producer("wal", self._wal.stats)

    def install_quantized(self, precision: str) -> None:
        """Record the precision (compaction re-installs it on every rebuilt
        base) and build the quantized corpus on the current base."""
        if precision == "f32":
            return
        with self._lock:
            self._precisions.add(precision)
            self._view.sub.install_quantized(precision)

    def set_compaction_policy(self, max_delta: Optional[int] = None,
                              compact_every: Optional[int] = None) -> None:
        """Validated: ``max_delta`` must be a positive int (a value <= 0
        would make every insert immediately compaction-due, wedging
        ``_maybe_compact`` into a compact-per-op loop) and
        ``compact_every`` must be >= 0 (0 disables the every-N-ops
        trigger)."""
        if max_delta is not None:
            max_delta = int(max_delta)
            if max_delta <= 0:
                raise ValueError(f"set_compaction_policy: invalid "
                                 f"max_delta={max_delta} (must be a "
                                 f"positive int)")
            self.max_delta = max_delta
        if compact_every is not None:
            compact_every = int(compact_every)
            if compact_every < 0:
                raise ValueError(f"set_compaction_policy: invalid "
                                 f"compact_every={compact_every} (must be "
                                 f">= 0; 0 disables the every-N trigger)")
            self.compact_every = compact_every

    # ------------------------------------------------------------ WAL
    def attach_wal(self, wal_dir, *, sync: str = "batch",
                   fsync_every_n: int = 64, fsync_interval_s: float = 0.05,
                   segment_bytes: int = 4 << 20, ops=None) -> None:
        """Open (or resume) the write-ahead log at ``wal_dir``.  From this
        point every mutation is appended — and made durable per the sync
        policy — *before* it is applied in memory.  Attaching the same
        directory twice is a no-op; attaching a different one while a WAL
        is open is an error (two logs cannot both be the truth)."""
        with self._lock:
            if self._wal is not None:
                if Path(wal_dir).resolve() == self._wal.dir.resolve():
                    return
                raise ValueError(f"attach_wal: a WAL is already attached "
                                 f"at {self._wal.dir}; refusing to switch "
                                 f"to {wal_dir}")
            w = WriteAheadLog(wal_dir, sync=sync,
                              fsync_every_n=fsync_every_n,
                              fsync_interval_s=fsync_interval_s,
                              segment_bytes=segment_bytes, ops=ops)
            # an attach over an existing log resumes after its tail: the
            # caller is expected to have replayed it (recover); appending
            # below the tail would fork LSN history
            if w.next_lsn - 1 > self.applied_lsn and self._id_loc:
                warnings.warn(
                    f"attach_wal: {wal_dir} already holds records up to "
                    f"lsn {w.next_lsn - 1} but only {self.applied_lsn} "
                    f"were applied — did you mean StreamingRFANN.recover?")
            self._wal = w
            self.applied_lsn = max(self.applied_lsn, w.next_lsn - 1)
        if self._metrics is not None:
            self._metrics.register_producer("wal", self._wal.stats)

    def set_checkpoint_path(self, path, *, shards: int = 1,
                            ensure: bool = True) -> None:
        """Register where :meth:`checkpoint` (and the automatic one after
        every compaction) persists the index.  With ``ensure=True`` a
        baseline checkpoint is written immediately when none exists yet —
        recovery needs *some* checkpoint to replay the WAL onto, so a
        crash before the first compaction/shutdown must still find one."""
        from repro_torch.index import io
        self._ckpt_path = str(path)
        self._ckpt_shards = int(shards)
        if ensure and not io.is_index_dir(self._ckpt_path):
            self.checkpoint()

    def checkpoint(self, path=None, *, shards: Optional[int] = None) -> dict:
        """Persist a crash-consistent snapshot and advance the WAL.

        Order matters and is the whole point:

        1. ``save_index`` — array files first, ``manifest.json`` last
           (the atomic commit point), every rename fsynced into its
           directory.  The manifest carries the snapshot's WAL watermark.
        2. ``BARRIER(generation, watermark)`` appended (fsynced) — only a
           *committed* checkpoint may authorize dropping log history.
        3. WAL segments entirely at or below the watermark are
           garbage-collected.

        A crash between any two steps is safe: recovery either replays a
        longer tail onto the previous checkpoint (idempotent via the
        watermark) or finds the new checkpoint with a tail that is merely
        shorter than the log's retained history."""
        path = path if path is not None else self._ckpt_path
        if path is None:
            raise ValueError("checkpoint: no path given and no "
                             "set_checkpoint_path registered")
        shards = int(shards) if shards is not None else self._ckpt_shards
        from repro_torch.index import io
        man = io.save_index(self, path, shards=shards)
        wal = self._wal
        if wal is not None:
            watermark = int(man["index"]["streaming"]["wal_lsn"])
            wal.rotate()        # seal the tail so covered segments free up
            wal.append_barrier(int(man.get("gen", 0)), watermark)
            wal.gc(watermark)
        return man

    @classmethod
    def recover(cls, index_path, wal_dir, *, sync: str = "batch",
                fsync_every_n: int = 64, fsync_interval_s: float = 0.05,
                ops=None, attach: bool = True,
                **load_kw) -> "StreamingRFANN":
        """Crash-consistent restart: restore the checkpoint at
        ``index_path`` (``repro_torch.index.io`` directory format; pass
        ``device=`` through ``load_kw``), replay the WAL tail past the
        checkpoint's watermark (idempotently — records at or below it are
        skipped; a torn tail record truncates the log there), then
        re-attach the WAL so serving continues appending where the crashed
        process stopped."""
        from repro_torch.index import io
        idx = io.load_index(index_path, **load_kw)
        if not isinstance(idx, cls):
            raise TypeError(f"recover: index at {index_path} is "
                            f"{type(idx).__name__}, not StreamingRFANN — "
                            f"only streaming indexes have a WAL to replay")
        idx.replay_wal(wal_dir, ops=ops)
        if attach:
            idx.attach_wal(wal_dir, sync=sync, fsync_every_n=fsync_every_n,
                           fsync_interval_s=fsync_interval_s, ops=ops)
            idx._ckpt_path = str(index_path)
        return idx

    def replay_wal(self, wal_dir, *, ops=None) -> int:
        """Apply every intact WAL record with ``lsn > applied_lsn``;
        returns the number of mutations applied.  Idempotent on top of
        the watermark too (an insert whose id is already live / a delete
        of a non-live id is skipped, so a double replay cannot corrupt).
        Torn tail records truncate the log at the last good byte.
        Compaction is suppressed during replay and re-evaluated once at
        the end — replay is state reconstruction, not load."""
        applied = 0
        with self._lock:
            self._replaying = True
            try:
                for rec in walmod.replay(wal_dir, truncate=True, ops=ops):
                    if rec.lsn <= self.applied_lsn:
                        continue            # already inside the checkpoint
                    if rec.op == walmod.OP_INSERT:
                        ext = int(rec.ext_id)
                        # next_id must advance even over skipped records:
                        # the original run acknowledged this id
                        self._next_id = max(self._next_id, ext + 1)
                        if ext not in self._id_loc:
                            self._apply_insert(rec.vector, float(rec.attr),
                                               ext)
                        applied += 1
                    elif rec.op == walmod.OP_DELETE:
                        ext = int(rec.ext_id)
                        if ext in self._id_loc:
                            self._apply_delete(ext)
                        applied += 1
                    # BARRIER / SEAL: bookkeeping only
                    self.applied_lsn = rec.lsn
            finally:
                self._replaying = False
        self._maybe_compact()
        return applied

    def _wal_append(self, append_fn) -> None:
        """Append one mutation record (called under the index lock, so
        LSN order == apply order — replay reproduces the live sequence
        exactly).  A failed append flips the index read-only *before*
        raising: a mutation that cannot be made recoverable must never be
        acknowledged."""
        if self._wal is None or self._replaying:
            return
        try:
            lsn = append_fn()
        except WALError as e:
            self._enter_read_only(str(e))
            raise ReadOnlyIndexError(
                f"index is read-only: WAL append failed ({e}); serving "
                f"continues, mutations are rejected") from e
        self.applied_lsn = lsn

    def _enter_read_only(self, reason: str) -> None:
        self.read_only = True
        self.read_only_reason = reason
        if self._metrics is not None:
            self._m_ro.set(1)
        warnings.warn(f"StreamingRFANN degraded to read-only: {reason}")

    def _check_writable(self) -> None:
        if self.read_only:
            raise ReadOnlyIndexError(
                f"index is read-only ({self.read_only_reason}); mutations "
                f"are rejected until the WAL is writable again")

    # ---------------------------------------------------------- mutations
    def insert(self, vector: np.ndarray, attr: float,
               ext_id: Optional[int] = None) -> int:
        """Append one point to the delta segment; returns its external id.
        O(delta) host work (stable re-sort); no base cache invalidation —
        delta results are never cached.  With a WAL attached the record is
        logged *before* the in-memory apply — returning from this method
        means the insert is recoverable (to the attached sync policy)."""
        with self._lock:
            self._check_writable()
            if ext_id is None:
                ext_id = self._next_id
            ext_id = int(ext_id)
            if ext_id in self._id_loc:
                raise ValueError(f"id {ext_id} is already live")
            vec = np.asarray(vector, np.float32)
            self._wal_append(lambda: self._wal.append_insert(
                ext_id, float(attr), vec))
            self._next_id = max(self._next_id, ext_id + 1)
            self._apply_insert(vec, float(attr), ext_id)
        self._maybe_compact()
        return ext_id

    def delete(self, ext_id: int) -> None:
        """Remove one live point.  Base points tombstone (the node stays a
        routing node until the next compaction) and invalidate the base
        cache segment; delta points vanish physically.  WAL-logged before
        apply, like :meth:`insert`."""
        with self._lock:
            self._check_writable()
            ext_id = int(ext_id)
            if ext_id not in self._id_loc:
                raise KeyError(f"id {ext_id} is not live")
            self._wal_append(lambda: self._wal.append_delete(ext_id))
            self._apply_delete(ext_id)
        self._maybe_compact()

    def _apply_insert(self, vector: np.ndarray, attr: float,
                      ext_id: int) -> None:
        """In-memory half of an insert — shared by the live path and WAL
        replay (replay must mutate state identically, minus re-logging).
        Caller holds the lock and has validated/logged."""
        v = self._view
        delta = v.delta.with_inserted(np.asarray(vector, np.float32),
                                      float(attr), ext_id)
        self._view = SegmentView(v.sub, v.base_vecs, v.base_attrs,
                                 v.base_ids, v.base_live,
                                 v.n_tombstones, delta, v.version + 1)
        self._id_loc[ext_id] = -1
        self._ops_since_compact += 1
        if self._metrics is not None:
            self._m_ins.inc()
            self._m_dsize.set(delta.count)

    def _apply_delete(self, ext_id: int) -> None:
        """In-memory half of a delete — shared by live path and replay."""
        loc = self._id_loc.pop(ext_id)
        v = self._view
        if loc < 0:             # delta row: physical remove
            delta = v.delta.without(ext_id)
            self._view = SegmentView(v.sub, v.base_vecs, v.base_attrs,
                                     v.base_ids, v.base_live,
                                     v.n_tombstones, delta,
                                     v.version + 1)
            if self._metrics is not None:
                self._m_dsize.set(delta.count)
        else:                   # base rank: copy-on-write tombstone
            live = v.base_live.copy()
            live[loc] = False
            self._view = SegmentView(v.sub, v.base_vecs, v.base_attrs,
                                     v.base_ids, live,
                                     v.n_tombstones + 1, v.delta,
                                     v.version + 1)
            if self._cache is not None:
                self._cache.invalidate_segment(BASE_NS)
            if self._metrics is not None:
                self._m_tomb.set(v.n_tombstones + 1)
        self._ops_since_compact += 1
        if self._metrics is not None:
            self._m_del.inc()

    # ------------------------------------------------------------- search
    def search(self, queries: np.ndarray, attr_ranges: np.ndarray, *,
               k: int = 10, ef: int = 64, plan: str = "auto",
               beam_width: int = 1, precision: str = "f32",
               use_kernel: Optional[bool] = None, trace=None) -> SearchResult:
        """Range-filtered kNN over base ∪ delta at one captured snapshot.
        Returns external ids.  Resolve happens per segment *inside* the
        snapshot (this is why there is no ``rank_range``).  ``use_kernel``
        ``None`` resolves by the index's device, as in ``RNSGIndex``."""
        v = self._view                      # lock-free snapshot capture
        qv = np.atleast_2d(np.asarray(queries, np.float32))
        ar = np.atleast_2d(np.asarray(attr_ranges, np.float32))
        ef = max(ef, k)
        lo, hi = v.sub.resolve(ar)
        req = SearchRequest(
            queries=qv, lo=lo, hi=hi, k=k, ef=ef, strategy=plan,
            use_kernel=resolve_use_kernel(use_kernel, self.device),
            beam_width=beam_width,
            precision=precision, trace=trace,
            live=v.base_live if v.n_tombstones else None)
        pending = v.sub.dispatch(req, defer=True)
        delta_res = v.delta.search(qv, ar, k)
        base = pending.result()
        if self._metrics is not None and v.n_live:
            self._m_dfrac.observe(v.delta.count / v.n_live)
        stats = dict(base.stats)
        stats.update(delta_size=v.delta.count, tombstones=v.n_tombstones,
                     version=v.version)
        if delta_res is None:
            return SearchResult(base.ids, base.dists, stats,
                                trace=base.trace)
        di, dd = delta_res
        all_i = np.stack([np.asarray(base.ids, np.int32), di])
        all_d = np.stack([np.where(base.ids >= 0, base.dists, np.inf), dd])
        ids, dists = merge_topk(torch.from_numpy(all_i),
                                torch.from_numpy(all_d), k)
        return SearchResult(ids.numpy(), dists.numpy(), stats,
                            trace=base.trace)

    # --------------------------------------------------------- compaction
    def _maybe_compact(self) -> None:
        if self._compacting.is_set():
            return
        v = self._view
        due = (v.delta.count >= self.max_delta
               or (self.compact_every
                   and self._ops_since_compact >= self.compact_every))
        if due:
            self.compact(wait=False)

    def compact(self, wait: bool = True) -> bool:
        """Rebuild the base from the live set on a worker thread and
        hot-swap it.  Returns False when a compaction is already running
        or there is nothing to fold in."""
        with self._lock:
            if self._compacting.is_set():
                if wait and self._worker is not None:
                    w = self._worker
                else:
                    return False
            else:
                v = self._view
                if v.delta.count == 0 and v.n_tombstones == 0:
                    return False
                if v.n_live < 8:    # tombstone masks stay correct; a graph
                    return False    # over <8 points is not worth building
                self._compacting.set()
                self._ops_since_compact = 0
                w = threading.Thread(target=self._compact_run, args=(v,),
                                     daemon=True)
                self._worker = w
                w.start()
        if wait:
            w.join()
        return True

    def _compact_run(self, v0: SegmentView) -> None:
        try:
            t0 = time.perf_counter()
            keep = v0.base_live
            cat_vecs = np.concatenate([v0.base_vecs[keep], v0.delta.vecs])
            cat_attrs = np.concatenate([v0.base_attrs[keep],
                                        v0.delta.attrs])
            cat_ids = np.concatenate([v0.base_ids[keep], v0.delta.ids])
            # slow part — entirely off-lock; mutations keep landing on the
            # published view and are reconciled at the swap below
            new = self._build_view(cat_vecs, cat_attrs, cat_ids,
                                   DeltaView.empty(self.d, self.device),
                                   version=0, old_sub=v0.sub)
            build_ms = (time.perf_counter() - t0) * 1e3
            t1 = time.perf_counter()
            with self._lock:
                cur = self._view
                # ids live *now* (deletes during the rebuild win)
                live_now = np.concatenate(
                    [cur.base_ids[cur.base_live], cur.delta.ids])
                base_live = np.isin(new.base_ids, live_now)
                # inserts during the rebuild stay as the residual delta
                folded = np.isin(cur.delta.ids, cat_ids)
                residual = cur.delta.subset(~folded)
                swapped = SegmentView(new.sub, new.base_vecs,
                                      new.base_attrs, new.base_ids,
                                      base_live, int((~base_live).sum()),
                                      residual, cur.version + 1)
                v0.sub.cache = None     # old segment: no new lookups;
                if self._cache is not None:     # late stores are fenced by
                    self._cache.invalidate_segment(BASE_NS)  # the epoch bump
                self._view = swapped
                self._reindex(swapped)
                self.compactions += 1
            pause_ms = (time.perf_counter() - t1) * 1e3
            if self._metrics is not None:
                self._m_comp.inc()
                self._m_pause.observe(pause_ms)
                self._m_build.observe(build_ms)
                self._m_dsize.set(residual.count)
                self._m_tomb.set(swapped.n_tombstones)
            # checkpoint-after-compaction: the folded state is exactly what
            # the WAL no longer needs to retain, so persist it and let
            # checkpoint() write the barrier + GC covered segments.  A
            # failed checkpoint is not fatal — writes stayed durable in the
            # WAL, the log just keeps more history until the next success.
            if self._ckpt_path is not None and self._wal is not None:
                try:
                    self.checkpoint()
                except Exception as e:      # noqa: BLE001 — degrade, log
                    warnings.warn(f"post-compaction checkpoint to "
                                  f"{self._ckpt_path} failed: {e}")
        finally:
            self._compacting.clear()

    def close(self) -> None:
        """Wait out any in-flight compaction to its end (a rebuild at full
        size on the card can run longer than the reference's 30 s wait,
        and its post-compaction checkpoint must not meet a closed WAL),
        then seal and close the WAL (tests and serve teardown).  The SEAL
        record marks a clean shutdown; recovery treats its absence as a
        crash (which is also fine — that is the whole design — it just
        replays more carefully truncating any torn tail)."""
        w = self._worker
        if w is not None and w.is_alive():
            w.join()
        with self._lock:
            if self._wal is not None:
                try:
                    self._wal.seal()
                except WALError:
                    pass        # a dead disk at shutdown changes nothing
                self._wal.close()
                self._wal = None

    # ------------------------------------------------------------- export
    def live_items(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(vecs, attrs, ids) of every live point, in exactly the order a
        compaction would feed ``build_rnsg`` — a fresh offline build on
        this tuple is bit-identical to the post-compaction base."""
        v = self._view
        keep = v.base_live
        return (np.concatenate([v.base_vecs[keep], v.delta.vecs]),
                np.concatenate([v.base_attrs[keep], v.delta.attrs]),
                np.concatenate([v.base_ids[keep], v.delta.ids]))

    def stats(self) -> dict:
        v = self._view
        nb = len(v.base_ids)
        return dict(n_base=nb, n_delta=v.delta.count,
                    tombstones=v.n_tombstones, n_live=v.n_live,
                    delta_frac=v.delta.count / max(v.n_live, 1),
                    version=v.version, compactions=self.compactions,
                    build_seconds=self.build_seconds,
                    wal_lsn=int(self.applied_lsn),
                    read_only=int(self.read_only))

    @property
    def index_bytes(self) -> int:
        v = self._view
        sub = v.sub
        return int(sum(t.numel() * t.element_size()
                       for t in (sub._nbrs, sub._rmq, sub._dist_c))
                   + v.delta.vecs.nbytes)

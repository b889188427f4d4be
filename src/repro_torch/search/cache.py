"""Result cache in front of the substrate dispatch stage (host numpy,
copied from the reference: the keys, the byte accounting and the epochs are
its own, so the same request stream gives the same hits and misses).

``SearchCache`` memoizes **finished per-query results** (original corpus
ids + distances + scalar stats) keyed on everything that determines them:

    (blake2b(query vector), lo, hi, k, ef, strategy, use_kernel,
     beam_width, precision)

The rank interval — not the raw attribute range — is part of the key, so
two different attribute ranges that resolve to the same ranks share one
entry.  Substrates that share a cache (the distributed local path's shard
substrates, the mesh substrate) additionally key a **namespace** (shard
index / ``"mesh"``): different shards routinely see identical
(query, clipped interval) pairs over different vectors, which must never
collide.

Eviction is LRU under an explicit **byte budget** (ids/dists row bytes +
per-entry overhead), so a long-running server holds a bounded working set
regardless of query-stream cardinality.  ``invalidate()`` empties the cache
wholesale — required whenever the index contents or the calibration that
results were computed under change (``RFANNEngine.swap_index`` wires this).
``invalidate_segment(ns)`` is the surgical variant for multi-segment indexes:
it drops only rows whose namespace matches and bumps that namespace's
**segment epoch**, so a streaming compaction that replaces the base segment
leaves every other segment's rows (other shards, the mesh) warm.  Stores made
by dispatches that split before the bump carry the old ``(global, segment)``
epoch pair and are fenced exactly like a wholesale invalidation.

Requests that carry a per-row liveness mask (``SearchRequest.live``) are
cached under the same keys as unmasked ones: the mask is corpus state, not a
request parameter, and the owner of the mask (the streaming layer) must call
``invalidate_segment`` on every mask change — that is the per-segment epoch
invalidation invariant (see docs/streaming.md).

The cache is installed at the single substrate choke point:
``SearchSubstrate.dispatch`` (and the reference's mesh substrate) split
each request into hit/miss rows via :meth:`SearchCache.split`, execute
only the misses,
then :meth:`SearchCache.assemble` stitches the batch back in request order.
Hits therefore skip resolve-entry selection, kernel dispatch, *and* the
rank→id remap — a repeat-query batch performs no device work at all.

Results returned from a hit are the stored bytes verbatim, so a cached
batch is bit-identical to the dispatch that populated it (asserted by the
parity tests).  Under ``strategy="auto"`` a stored row reflects the routing
decision at store time; online calibration may route a later identical
query differently, but both executions are valid results for the same
(query, range, k, ef) contract.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.search.request import SearchResult

#: rough per-entry bookkeeping cost (key tuple, digest, dict slot) charged
#: against the byte budget on top of the payload arrays.
ENTRY_OVERHEAD = 128


def hash_query(q: np.ndarray) -> bytes:
    """Content hash of one query vector.  Callers fanning a batch out to
    several substrates (the distributed local path) hash each row **once**
    and pass the digests through — the key differs per shard only in
    ``ns``/``lo``/``hi``, so re-hashing per shard would be S-fold waste."""
    return hashlib.blake2b(np.ascontiguousarray(q, np.float32).tobytes(),
                           digest_size=16).digest()


def query_key(q: np.ndarray, lo: int, hi: int, k: int, ef: int,
              strategy: str, use_kernel: bool = False, ns=None,
              digest: Optional[bytes] = None, beam_width: int = 1,
              precision: str = "f32") -> Tuple:
    """Cache key for one query row: content hash of the vector plus every
    request parameter that changes the result (``beam_width`` included —
    the batched-expansion frontier may legitimately differ from the
    single-expansion one at sub-exhaustive ``ef``).  ``precision`` is also
    keyed: the quantized paths return the exact f32 top-k id set after
    rerank, but distances/stats and the traversal at sub-exhaustive ``ef``
    are precision-dependent, so rows never cross precisions.

    ``ns`` namespaces the key to one corpus slice.  It is required whenever
    several substrates share a cache: two shards routinely see the *same*
    (query, shard-local interval, k, ef) — e.g. a full-span query clips to
    ``(0, per-1)`` on every shard — but search different vectors, so without
    the namespace their entries would collide and serve wrong rows."""
    h = digest if digest is not None else hash_query(q)
    return (ns, h, int(lo), int(hi), int(k), int(ef), strategy,
            bool(use_kernel), int(beam_width), precision)


@dataclass
class CacheEntry:
    """One finished per-query result (original corpus ids, -1 padded).

    ``stamp``/``cal_epoch`` implement staleness fencing for rows whose
    routing was a *decision*, not part of the request contract:
    ``strategy="auto"`` rows record the planner's calibration epoch at
    store time (``cal_epoch``) and their insertion time (``stamp``).  A
    later lookup re-validates both — see :meth:`SearchCache.lookup`.
    Forced-strategy rows leave ``cal_epoch`` as ``None`` and are never
    age- or epoch-expired (their result is calibration-independent)."""
    ids: np.ndarray                 # (k,) int32
    dists: np.ndarray               # (k,) float32
    stats: Dict[str, np.generic]    # scalar per-query stats (hops/ndist/...)
    stamp: float = 0.0              # clock() at store time
    cal_epoch: Optional[int] = None  # planner calibration epoch (auto rows)

    @property
    def nbytes(self) -> int:
        return (self.ids.nbytes + self.dists.nbytes +
                16 * len(self.stats) + ENTRY_OVERHEAD)


class SearchCache:
    """LRU result cache with a byte budget and explicit invalidation.

    Thread-safe: the engine's dispatch thread and ``swap_index`` callers may
    touch it concurrently (one short lock around every structural op)."""

    def __init__(self, max_bytes: int = 64 << 20, *,
                 ttl_s: Optional[float] = None, clock=time.monotonic):
        """``ttl_s`` bounds the age of ``strategy="auto"`` rows (None = no
        age limit); ``clock`` is injectable for deterministic expiry tests.
        Forced-strategy rows are exempt — their result does not depend on
        planner calibration, so age cannot make them wrong."""
        self.max_bytes = int(max_bytes)
        self.ttl_s = ttl_s
        self.clock = clock
        self._d: "OrderedDict[Tuple, CacheEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.bytes = 0
        self.epoch = 0          # bumped by invalidate(); fences late stores
        self._seg_epochs: Dict[object, int] = {}   # ns -> segment epoch
        self.hits = 0
        self.misses = 0
        self.dedup_hits = 0     # intra-batch duplicates served by one dispatch
        self.evictions = 0
        self.invalidations = 0
        self.seg_invalidations = 0
        self.expired = 0        # TTL / calibration-epoch expiries

    def __len__(self) -> int:
        return len(self._d)

    # ------------------------------------------------------------ core ops
    def lookup(self, key: Tuple,
               cal_epoch: Optional[int] = None) -> Optional[CacheEntry]:
        """``cal_epoch``: the planner's current calibration epoch.  Entries
        stored under ``strategy="auto"`` (``entry.cal_epoch is not None``)
        are re-validated on every hit: a calibration-epoch mismatch (the
        planner persisted new calibration since the row was stored) or an
        age beyond ``ttl_s`` expires the row — it is dropped and the lookup
        counts as a miss, so the caller re-executes under current routing."""
        with self._lock:
            e = self._d.get(key)
            if e is None:
                self.misses += 1
                return None
            if e.cal_epoch is not None:
                stale = (cal_epoch is not None and e.cal_epoch != cal_epoch)
                if not stale and self.ttl_s is not None:
                    stale = (self.clock() - e.stamp) > self.ttl_s
                if stale:
                    del self._d[key]
                    self.bytes -= e.nbytes
                    self.expired += 1
                    self.misses += 1
                    return None
            self._d.move_to_end(key)
            self.hits += 1
            return e

    def store(self, key: Tuple, entry: CacheEntry,
              epoch=None) -> None:
        """Insert one entry.  ``epoch`` (captured at lookup/split time)
        fences stores against a concurrent ``invalidate``: a dispatch that
        was in flight when the cache was invalidated — e.g. a batch still
        executing on a just-swapped-out index — must not repopulate the
        cache with rows of the old corpus.  The check runs under the same
        lock ``invalidate`` takes, so no stale store can slip through.

        ``epoch`` is either the legacy global ``int`` or the
        ``(global, segment)`` pair from :meth:`epoch_for`; the pair
        additionally fences stores against a concurrent
        ``invalidate_segment`` of this key's namespace (``key[0]``)."""
        with self._lock:
            if epoch is not None:
                if isinstance(epoch, tuple):
                    if (epoch[0] != self.epoch or
                            epoch[1] != self._seg_epochs.get(key[0], 0)):
                        return
                elif epoch != self.epoch:
                    return
            entry.stamp = self.clock()
            old = self._d.pop(key, None)
            if old is not None:
                self.bytes -= old.nbytes
            if entry.nbytes > self.max_bytes:
                return                      # larger than the whole budget
            self._d[key] = entry
            self.bytes += entry.nbytes
            while self.bytes > self.max_bytes and self._d:
                _, ev = self._d.popitem(last=False)
                self.bytes -= ev.nbytes
                self.evictions += 1

    def invalidate(self) -> None:
        """Drop everything and bump the epoch.  Must be called when the
        index contents change (cached rows reference the old corpus) — see
        ``swap_index``.  In-flight dispatches that split before the bump
        carry the old epoch and their late ``store_batch`` is dropped."""
        with self._lock:
            self._d.clear()
            self.bytes = 0
            self.epoch += 1
            self.invalidations += 1

    def invalidate_segment(self, ns=None) -> None:
        """Drop only the rows of one namespace and bump its segment epoch.
        The hot-swap primitive for multi-segment indexes: a streaming
        compaction replaces the base segment's corpus, so only base-keyed
        rows (``key[0] == ns``) are wrong — rows of other segments stay
        warm.  In-flight dispatches on the old segment captured the old
        ``(global, segment)`` epoch pair via :meth:`epoch_for` and their
        late stores are dropped by :meth:`store`."""
        with self._lock:
            dead = [k for k in self._d if k[0] == ns]
            for k in dead:
                self.bytes -= self._d.pop(k).nbytes
            self._seg_epochs[ns] = self._seg_epochs.get(ns, 0) + 1
            self.seg_invalidations += 1

    def epoch_for(self, ns=None) -> Tuple[int, int]:
        """The ``(global, segment)`` epoch pair to capture before a dispatch
        whose stores should be fenced against both wholesale and
        per-segment invalidation of ``ns``."""
        with self._lock:
            return (self.epoch, self._seg_epochs.get(ns, 0))

    def snapshot(self) -> dict:
        return dict(entries=len(self._d), bytes=self.bytes,
                    max_bytes=self.max_bytes, hits=self.hits,
                    misses=self.misses, dedup_hits=self.dedup_hits,
                    evictions=self.evictions,
                    invalidations=self.invalidations,
                    seg_invalidations=self.seg_invalidations,
                    expired=self.expired)

    # ------------------------------------------------- batch split / stitch
    def split(self, qv: np.ndarray, lo: np.ndarray, hi: np.ndarray, k: int,
              ef: int, strategy: str, use_kernel: bool = False, ns=None,
              digests: Optional[List[bytes]] = None, beam_width: int = 1,
              precision: str = "f32", cal_epoch: Optional[int] = None):
        """Partition one batch into cache hits, misses, and intra-batch
        duplicates of a miss.

        Returns ``(keys, hit_rows, miss_idx, dups)``: per-row keys, a dict
        ``{row -> CacheEntry}`` for the hits, the *unique* miss positions
        (the only rows the substrate has to execute), and
        ``dups: {row -> position in miss_idx}`` for rows whose key equals
        an earlier miss in the same batch — those dispatch **once** and the
        single result fans back out at assembly (dynamic batches routinely
        coalesce identical requests; without this they execute twice on the
        miss path).  ``digests`` are optional precomputed ``hash_query``
        values (one per row) so multi-substrate callers hash each query
        once, not once per shard."""
        keys = [query_key(qv[i], lo[i], hi[i], k, ef, strategy, use_kernel,
                          ns=ns,
                          digest=digests[i] if digests is not None else None,
                          beam_width=beam_width, precision=precision)
                for i in range(len(qv))]
        hit_rows: Dict[int, CacheEntry] = {}
        miss: List[int] = []
        first_at: Dict[Tuple, int] = {}     # miss key -> its slot in `miss`
        dups: Dict[int, int] = {}
        for i, key in enumerate(keys):
            e = self.lookup(key, cal_epoch=cal_epoch)
            if e is not None:
                hit_rows[i] = e
                continue
            p = first_at.get(key)
            if p is None:
                first_at[key] = len(miss)
                miss.append(i)
            else:
                dups[i] = p
        if dups:                    # engine dispatch + direct callers may
            with self._lock:        # split concurrently: count under lock
                self.dedup_hits += len(dups)
        return keys, hit_rows, np.asarray(miss, np.int64), dups

    def store_batch(self, keys: List[Tuple], res: SearchResult,
                    epoch=None,
                    cal_epoch: Optional[int] = None) -> None:
        """Store every row of a finished miss-batch result (rows are copied
        so the cache never pins the batch arrays).  Pass the ``epoch``
        captured at split time — see :meth:`store`.  ``cal_epoch`` (auto
        rows only) arms the staleness fence on each stored entry."""
        q = len(res.ids)
        per_row = [(n, v) for n, v in res.stats.items()
                   if isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) == q]
        for j, key in enumerate(keys):
            self.store(key, CacheEntry(
                np.array(res.ids[j]), np.array(res.dists[j]),
                {n: v[j] for n, v in per_row},
                cal_epoch=cal_epoch), epoch=epoch)

    def assemble(self, q: int, k: int, hit_rows: Dict[int, CacheEntry],
                 miss_res: Optional[SearchResult],
                 miss_idx: np.ndarray,
                 dups: Optional[Dict[int, int]] = None) -> SearchResult:
        """Stitch hits + executed misses back into request order; ``dups``
        rows copy the executed result of their representative miss."""
        ids = np.full((q, k), -1, np.int32)
        dists = np.full((q, k), np.inf, np.float32)
        per_row: Dict[str, Dict[int, np.generic]] = {}
        for i, e in hit_rows.items():
            ids[i] = e.ids
            dists[i] = e.dists
            for name, v in e.stats.items():
                per_row.setdefault(name, {})[i] = v
        if miss_res is not None and len(miss_idx):
            ids[miss_idx] = miss_res.ids
            dists[miss_idx] = miss_res.dists
            for name, v in miss_res.stats.items():
                if isinstance(v, np.ndarray) and v.ndim >= 1 \
                        and len(v) == len(miss_idx):
                    d = per_row.setdefault(name, {})
                    for j, i in enumerate(miss_idx):
                        d[int(i)] = v[j]
        if dups and miss_res is not None:
            for i, p in dups.items():
                ids[i] = miss_res.ids[p]
                dists[i] = miss_res.dists[p]
                for name, d in per_row.items():
                    if int(miss_idx[p]) in d:
                        d[i] = d[int(miss_idx[p])]
        stats: Dict[str, object] = {}
        for name, vals in per_row.items():
            sample = np.asarray(next(iter(vals.values())))
            arr = np.zeros(q, dtype=sample.dtype)
            for i, v in vals.items():
                arr[i] = v
            stats[name] = arr
        if "strategy" in stats:
            from repro_torch.planner.planner import SCAN
            stats["scan_frac"] = float((stats["strategy"] == SCAN).mean())
        stats["cache_hits"] = len(hit_rows)
        if dups:
            stats["batch_dedup"] = len(dups)
        return SearchResult(ids, dists, stats)

"""Segmented, checksummed write-ahead log for the streaming index (host
only, copied from the reference: its records are byte-identical, so a log
written by either package replays in the other).

Every mutation of a ``StreamingRFANN`` (insert / delete) is appended here
*before* it is applied in memory, so a crashed server replays the
uncompacted tail instead of silently dropping it.  Design points:

* **Record format** — length-prefixed binary records, each protected by a
  CRC32 over its payload::

      u32 payload_len | u32 crc32(payload) | payload
      payload = u64 lsn | u8 op | op body

  Ops: ``INSERT`` (ext id + attr + f32 vector), ``DELETE`` (ext id),
  ``BARRIER`` (checkpoint generation + the LSN watermark that checkpoint
  covers) and ``SEAL`` (clean shutdown marker).  LSNs are assigned by the
  log, start at 1, and increase by exactly 1 per record — the recovery
  watermark (``manifest["streaming"]["wal_lsn"]``) makes replay
  idempotent: a record with ``lsn <= watermark`` is already inside the
  restored checkpoint and is skipped.

* **Segments** — the log is a directory of ``wal-<seq>.log`` files, each
  opened ``O_APPEND`` and rotated once it exceeds ``segment_bytes``.  The
  parent directory is fsynced on every segment create/rotate, so the
  *names* are as durable as the bytes (a rename/create that is never
  fsynced into its directory can vanish on power loss).  Sealed segments
  entirely behind a barrier's watermark are garbage-collected by
  :meth:`WriteAheadLog.gc`.

* **Sync policy** — ``sync="always"`` fsyncs every append (an
  acknowledged mutation is durable, full stop); ``sync="batch"`` group
  commits: an append fsyncs when ``fsync_every_n`` appends have
  accumulated or ``fsync_interval_s`` seconds have passed since the last
  fsync.  The interval is evaluated lazily, on the *next* append — there
  is no background timer — so when traffic pauses, up to
  ``fsync_every_n - 1`` acknowledged mutations can sit unsynced until
  traffic resumes; callers that pause (or shut down) should call
  :meth:`WriteAheadLog.flush` to close the window.  Crash window = the
  unsynced tail of acknowledged mutations.  ``sync="none"`` never fsyncs
  on the hot path (OS page cache only — crash window unbounded, for
  benchmarking).

* **Torn tails** — :func:`replay` verifies every record's length prefix
  and CRC.  A short read or checksum mismatch marks the *torn point*:
  replay stops there, and :meth:`WriteAheadLog.open_for_append` /
  :func:`replay` with ``truncate=True`` physically truncates the segment
  at the last good record so new appends never interleave with garbage.
  Anything after a tear (including later segments) is discarded — records
  are only meaningful in LSN order.

* **Fault injection** — every durability-relevant syscall goes through an
  injectable :class:`FileOps` layer.  The crash harness
  (``tests/test_torch_wal.py``) swaps in a
  :class:`CrashOps` that dies at the N-th operation, sweeping N across
  the whole insert/delete/compact/checkpoint lifecycle and asserting the
  recovered index is bit-identical to a never-crashed oracle.
"""
from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

# record op codes (u8 on the wire)
OP_INSERT = 1
OP_DELETE = 2
OP_BARRIER = 3
OP_SEAL = 4

_HDR = struct.Struct("<II")         # payload_len, crc32(payload)
_LSN_OP = struct.Struct("<QB")      # lsn, op
_INSERT_HDR = struct.Struct("<qfI")  # ext_id, attr, dim
_DELETE_BODY = struct.Struct("<q")   # ext_id
_BARRIER_BODY = struct.Struct("<qQ")  # generation, watermark lsn

SEGMENT_PREFIX = "wal-"
SEGMENT_SUFFIX = ".log"

SYNC_POLICIES = ("always", "batch", "none")


class WALError(RuntimeError):
    """Raised when an append cannot be made durable (disk full, fd gone,
    injected fault, ...).  The streaming layer catches this and degrades
    to read-only serving instead of acknowledging a mutation it cannot
    recover."""


class InjectedCrash(BaseException):
    """Raised by :class:`CrashOps` at its trigger point.  Derives from
    ``BaseException`` so ordinary ``except Exception`` recovery/degrade
    paths in the code under test cannot swallow the simulated crash."""


# --------------------------------------------------------------- file ops
class FileOps:
    """Every syscall the WAL's durability story depends on, in one
    swappable object.  The default is a thin veneer over ``os``; the fault
    harness subclasses it to crash at a chosen operation index."""

    def open_append(self, path: str) -> int:
        return os.open(path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)

    def write(self, fd: int, data: bytes) -> int:
        return os.write(fd, data)

    def fsync(self, fd: int) -> None:
        os.fsync(fd)

    def close(self, fd: int) -> None:
        os.close(fd)

    def fsync_dir(self, path: str) -> None:
        from repro_torch.index.io import fsync_dir
        fsync_dir(path)

    def truncate(self, path: str, length: int) -> None:
        with open(path, "r+b") as f:
            f.truncate(length)
            f.flush()
            os.fsync(f.fileno())

    def unlink(self, path: str) -> None:
        os.unlink(path)


class CrashOps(FileOps):
    """Fault-injection layer: counts durability-relevant operations and
    "crashes" (raises :class:`InjectedCrash`, or SIGKILLs the whole
    process when ``hard=True``) once the counter reaches ``crash_at``.

    ``crash_at < 0`` never fires — useful for counting how many ops a
    scenario performs before sweeping ``crash_at`` over that range.
    """

    #: operations that count toward the crash point
    COUNTED = ("write", "fsync", "fsync_dir", "truncate", "unlink",
               "open_append")

    def __init__(self, crash_at: int = -1, *, hard: bool = False):
        self.crash_at = int(crash_at)
        self.hard = bool(hard)
        self.ops = 0
        self.log: List[str] = []

    def _tick(self, name: str) -> None:
        self.ops += 1
        self.log.append(name)
        if 0 <= self.crash_at < self.ops:
            if self.hard:       # a real process death: SIGKILL ourselves
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            raise InjectedCrash(f"injected crash at op {self.ops} ({name})")

    def open_append(self, path):
        self._tick("open_append")
        return super().open_append(path)

    def write(self, fd, data):
        self._tick("write")
        return super().write(fd, data)

    def fsync(self, fd):
        self._tick("fsync")
        return super().fsync(fd)

    def fsync_dir(self, path):
        self._tick("fsync_dir")
        return super().fsync_dir(path)

    def truncate(self, path, length):
        self._tick("truncate")
        return super().truncate(path, length)

    def unlink(self, path):
        self._tick("unlink")
        return super().unlink(path)


# ---------------------------------------------------------------- records
@dataclass
class WalRecord:
    lsn: int
    op: int
    ext_id: int = -1
    attr: float = 0.0
    vector: Optional[np.ndarray] = None
    generation: int = -1
    watermark: int = 0

    @property
    def op_name(self) -> str:
        return {OP_INSERT: "insert", OP_DELETE: "delete",
                OP_BARRIER: "barrier", OP_SEAL: "seal"}.get(self.op,
                                                            f"op{self.op}")


def _encode(rec: WalRecord) -> bytes:
    body = _LSN_OP.pack(rec.lsn, rec.op)
    if rec.op == OP_INSERT:
        vec = np.ascontiguousarray(rec.vector, np.float32)
        body += _INSERT_HDR.pack(int(rec.ext_id), float(rec.attr), vec.size)
        body += vec.tobytes()
    elif rec.op == OP_DELETE:
        body += _DELETE_BODY.pack(int(rec.ext_id))
    elif rec.op == OP_BARRIER:
        body += _BARRIER_BODY.pack(int(rec.generation), int(rec.watermark))
    elif rec.op != OP_SEAL:
        raise ValueError(f"unknown WAL op {rec.op}")
    return _HDR.pack(len(body), zlib.crc32(body)) + body


def _decode(payload: bytes) -> WalRecord:
    lsn, op = _LSN_OP.unpack_from(payload, 0)
    off = _LSN_OP.size
    rec = WalRecord(lsn=lsn, op=op)
    if op == OP_INSERT:
        ext_id, attr, dim = _INSERT_HDR.unpack_from(payload, off)
        off += _INSERT_HDR.size
        vec = np.frombuffer(payload, np.float32, count=dim, offset=off)
        rec.ext_id, rec.attr, rec.vector = ext_id, attr, vec.copy()
    elif op == OP_DELETE:
        (rec.ext_id,) = _DELETE_BODY.unpack_from(payload, off)
    elif op == OP_BARRIER:
        rec.generation, rec.watermark = _BARRIER_BODY.unpack_from(payload,
                                                                  off)
    elif op != OP_SEAL:
        raise ValueError(f"unknown WAL op {op} at lsn {lsn}")
    return rec


# --------------------------------------------------------------- segments
def _segment_path(d: Path, seq: int) -> Path:
    return d / f"{SEGMENT_PREFIX}{seq:08d}{SEGMENT_SUFFIX}"


def _segment_seq(p: Path) -> int:
    return int(p.name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)])


def list_segments(wal_dir) -> List[Path]:
    d = Path(wal_dir)
    if not d.is_dir():
        return []
    segs = [p for p in d.iterdir()
            if p.name.startswith(SEGMENT_PREFIX)
            and p.name.endswith(SEGMENT_SUFFIX)]
    return sorted(segs, key=_segment_seq)


def _scan_segment(path: Path) -> Tuple[List[WalRecord], int, bool]:
    """(records, clean_byte_length, torn) for one segment file.  ``torn``
    is True when the file ends in a short/corrupt record — everything up
    to ``clean_byte_length`` parsed fine."""
    recs: List[WalRecord] = []
    data = path.read_bytes()
    off = 0
    n = len(data)
    while off < n:
        if off + _HDR.size > n:
            return recs, off, True                      # short header
        length, crc = _HDR.unpack_from(data, off)
        start = off + _HDR.size
        end = start + length
        if length < _LSN_OP.size or end > n:
            return recs, off, True                      # short payload
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            return recs, off, True                      # checksum mismatch
        try:
            recs.append(_decode(payload))
        except (ValueError, struct.error):
            return recs, off, True                      # undecodable body
        off = end
    return recs, off, False


def replay(wal_dir, *, truncate: bool = False,
           ops: Optional[FileOps] = None) -> Iterator[WalRecord]:
    """Yield every intact record in LSN order.  A torn record (bad CRC /
    short read) ends the replay at that point; with ``truncate=True`` the
    torn segment is physically truncated at the last good byte and any
    later segments are removed — the log then ends exactly where replay
    ended, so a reopened WAL appends from the torn point."""
    ops = ops or FileOps()
    segs = list_segments(wal_dir)
    for i, seg in enumerate(segs):
        recs, clean_len, torn = _scan_segment(seg)
        yield from recs
        if torn:
            if truncate:
                ops.truncate(str(seg), clean_len)
                for later in segs[i + 1:]:
                    ops.unlink(str(later))
                ops.fsync_dir(str(wal_dir))
            return


def last_lsn(wal_dir) -> int:
    """Highest intact LSN in the log (0 when empty)."""
    lsn = 0
    for rec in replay(wal_dir):
        lsn = max(lsn, rec.lsn)
    return lsn


# -------------------------------------------------------------------- WAL
class WriteAheadLog:
    """Appender half of the log.  One writer per directory; thread-safe
    (appends from the mutation path and barriers from the compaction
    worker share ``_lock``)."""

    def __init__(self, wal_dir, *, sync: str = "batch",
                 fsync_every_n: int = 64, fsync_interval_s: float = 0.05,
                 segment_bytes: int = 4 << 20,
                 ops: Optional[FileOps] = None):
        if sync not in SYNC_POLICIES:
            raise ValueError(f"WriteAheadLog: invalid sync={sync!r} "
                             f"(expected one of {SYNC_POLICIES})")
        if int(fsync_every_n) <= 0:
            raise ValueError(f"WriteAheadLog: invalid "
                             f"fsync_every_n={fsync_every_n} "
                             f"(must be a positive int)")
        self.dir = Path(wal_dir)
        self.sync = sync
        self.fsync_every_n = int(fsync_every_n)
        self.fsync_interval_s = float(fsync_interval_s)
        self.segment_bytes = int(segment_bytes)
        self.ops = ops or FileOps()
        self._lock = threading.Lock()
        self._fd: Optional[int] = None
        self._seg_len = 0
        self._unsynced = 0
        self._last_fsync = time.monotonic()
        self.appends = 0
        self.fsyncs = 0
        self.bytes_written = 0

        created = not self.dir.is_dir()
        self.dir.mkdir(parents=True, exist_ok=True)
        if created:
            parent = self.dir.resolve().parent
            self.ops.fsync_dir(str(parent))     # the dir itself must survive
        # resume after the existing intact tail (truncating any torn one)
        self.next_lsn = 1
        for rec in replay(self.dir, truncate=True, ops=self.ops):
            self.next_lsn = rec.lsn + 1
        segs = list_segments(self.dir)
        self._seq = _segment_seq(segs[-1]) if segs else 0
        if segs:
            self._fd = self.ops.open_append(str(segs[-1]))
            self._seg_len = segs[-1].stat().st_size
        else:
            self._open_segment(0)

    # ------------------------------------------------------------- plumbing
    def _open_segment(self, seq: int) -> None:
        if self._fd is not None:
            self.ops.fsync(self._fd)
            self.ops.close(self._fd)
        self._seq = seq
        self._fd = self.ops.open_append(str(_segment_path(self.dir, seq)))
        self._seg_len = 0
        # a created file name is only durable once its directory is synced
        self.ops.fsync_dir(str(self.dir))

    def _append(self, rec: WalRecord, *, force_sync: bool = False) -> int:
        with self._lock:
            if self._fd is None:
                raise WALError("WriteAheadLog is closed")
            # LSN assignment must share the lock with the write: mutation
            # appends and compaction-thread barriers would otherwise race,
            # producing duplicate LSNs or LSNs out of file order — and
            # replay (file order, skip lsn <= watermark) silently drops a
            # record written after a higher LSN.
            rec.lsn = self.next_lsn
            self.next_lsn += 1
            blob = _encode(rec)
            if self._seg_len and self._seg_len + len(blob) > self.segment_bytes:
                self._open_segment(self._seq + 1)
            try:
                off = 0
                while off < len(blob):
                    n = self.ops.write(self._fd, blob[off:])
                    if n is None or n <= 0:
                        raise WALError(
                            f"WAL short write on segment {self._seq}: "
                            f"{off}/{len(blob)} bytes written")
                    off += n
            except OSError as e:
                raise WALError(f"WAL append failed on segment "
                               f"{self._seq}: {e}") from e
            self._seg_len += len(blob)
            self.appends += 1
            self.bytes_written += len(blob)
            self._unsynced += 1
            now = time.monotonic()
            due = (force_sync or self.sync == "always"
                   or (self.sync == "batch"
                       and (self._unsynced >= self.fsync_every_n
                            or now - self._last_fsync
                            >= self.fsync_interval_s)))
            if due and self.sync != "none":
                try:
                    self.ops.fsync(self._fd)
                except OSError as e:
                    raise WALError(f"WAL fsync failed on segment "
                                   f"{self._seq}: {e}") from e
                self.fsyncs += 1
                self._unsynced = 0
                self._last_fsync = now
            return rec.lsn

    # -------------------------------------------------------------- appends
    def append_insert(self, ext_id: int, attr: float,
                      vector: np.ndarray) -> int:
        return self._append(WalRecord(lsn=0, op=OP_INSERT, ext_id=ext_id,
                                      attr=attr, vector=vector))

    def append_delete(self, ext_id: int) -> int:
        return self._append(WalRecord(lsn=0, op=OP_DELETE, ext_id=ext_id))

    def append_barrier(self, generation: int, watermark: int) -> int:
        """A checkpoint at ``generation`` covers every record with
        ``lsn <= watermark`` — appended *after* the checkpoint's
        manifest-last commit, always fsynced (a barrier that is not
        durable must not authorize garbage collection)."""
        return self._append(WalRecord(lsn=0, op=OP_BARRIER,
                                      generation=generation,
                                      watermark=watermark),
                            force_sync=True)

    def flush(self) -> None:
        """Force the group-commit window closed (fsync pending appends)."""
        with self._lock:
            if self._fd is not None and self._unsynced:
                self.ops.fsync(self._fd)
                self.fsyncs += 1
                self._unsynced = 0
                self._last_fsync = time.monotonic()

    def seal(self) -> None:
        """Clean-shutdown marker: append SEAL, fsync, rotate nothing.
        Idempotent; the log can still be appended to afterwards (the
        marker only tells recovery the previous run exited cleanly)."""
        if self._fd is None:
            return
        self._append(WalRecord(lsn=0, op=OP_SEAL), force_sync=True)

    def rotate(self) -> None:
        """Start a new segment (used by gc tests and the compaction path
        so old segments become collectable)."""
        with self._lock:
            self._open_segment(self._seq + 1)

    def gc(self, watermark: int) -> int:
        """Remove whole segments whose every record is covered by a
        durable checkpoint (``lsn <= watermark``).  The live tail segment
        is never removed.  Returns the number of segments collected."""
        removed = 0
        with self._lock:
            for seg in list_segments(self.dir)[:-1]:    # never the tail
                recs, _, torn = _scan_segment(seg)
                if torn:
                    break                   # tears only happen at the end
                if recs and max(r.lsn for r in recs) > watermark:
                    break                   # first uncovered segment: stop
                self.ops.unlink(str(seg))
                removed += 1
            if removed:
                self.ops.fsync_dir(str(self.dir))
        return removed

    @property
    def segment_count(self) -> int:
        return len(list_segments(self.dir))

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    self.ops.fsync(self._fd)
                finally:
                    self.ops.close(self._fd)
                    self._fd = None

    def stats(self) -> dict:
        return dict(next_lsn=self.next_lsn, appends=self.appends,
                    fsyncs=self.fsyncs, bytes_written=self.bytes_written,
                    segments=self.segment_count, sync=self.sync)


def describe(wal_dir) -> dict:
    """Human-oriented summary of a log directory (used by tools/tests)."""
    counts = {"insert": 0, "delete": 0, "barrier": 0, "seal": 0}
    lo = hi = 0
    barrier_watermark = 0
    for rec in replay(wal_dir):
        counts[rec.op_name] = counts.get(rec.op_name, 0) + 1
        lo = lo or rec.lsn
        hi = rec.lsn
        if rec.op == OP_BARRIER:
            barrier_watermark = max(barrier_watermark, rec.watermark)
    return dict(first_lsn=lo, last_lsn=hi, counts=counts,
                barrier_watermark=barrier_watermark,
                segments=len(list_segments(wal_dir)))

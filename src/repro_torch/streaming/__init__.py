"""Streaming ingest over the RNSG index: delta segment + tombstones +
background compaction, made durable by a checksummed write-ahead log."""
from repro_torch.streaming.delta import DeltaView
from repro_torch.streaming.streaming import (BASE_NS, ReadOnlyIndexError,
                                             SegmentView, StreamingRFANN)
from repro_torch.streaming.wal import (CrashOps, FileOps, InjectedCrash,
                                       WALError, WalRecord, WriteAheadLog)

__all__ = ["BASE_NS", "CrashOps", "DeltaView", "FileOps", "InjectedCrash",
           "ReadOnlyIndexError", "SegmentView", "StreamingRFANN",
           "WALError", "WalRecord", "WriteAheadLog"]

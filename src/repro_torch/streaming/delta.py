"""Mutable-delta segment of the streaming index: an attribute-sorted
brute-force buffer searched exactly through the ``range_scan`` kernel.

A ``DeltaView`` is an **immutable snapshot** — every insert/delete produces
a new view (the arrays of the old one are never written), so readers that
captured a view race nothing.  Rows stay attribute-sorted (stable re-sort
on insert: equal attributes keep insertion order, matching the stable
argsort ``build_rnsg`` uses, which is what makes a compacted index
bit-identical to a fresh offline build on the same live set).

Device residency: the rows live on the host; the padded corpus copy on the
view's device is built lazily per view and memoized on it.  Capacity pads
to the next power of two (≥ one row tile), so the scan runs at O(log
capacity) distinct ``bucket`` shapes over the life of a delta, not one per
insert; the pad tail is masked by the kernel's ``live`` row operand.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import range_scan
from repro_torch.planner.bucketing import ROW_TILE
from repro_torch.search.resolve import rank_interval


def _next_pow2(x: int) -> int:
    """The reference delta's pow2 (2 for x <= 2)."""
    return 1 << max(int(x) - 1, 1).bit_length()


class DeltaView:
    """One immutable snapshot of the delta segment.

    vecs : (m, d) f32, attribute-sorted.
    attrs: (m,) f32 ascending.
    ids  : (m,) int32 external ids (the streaming layer's stable ids).
    device: where ``search`` scans (default the card).
    """

    __slots__ = ("vecs", "attrs", "ids", "device", "_dev")

    def __init__(self, vecs: np.ndarray, attrs: np.ndarray, ids: np.ndarray,
                 device=None):
        self.vecs = np.asarray(vecs, np.float32)
        self.attrs = np.asarray(attrs, np.float32)
        self.ids = np.asarray(ids, np.int32)
        self.device = resolve_device(device)
        self._dev = None            # lazy (x_pad, live_row, cap, d_pad)

    # ------------------------------------------------------------ factory
    @classmethod
    def empty(cls, d: int, device=None) -> "DeltaView":
        return cls(np.zeros((0, d), np.float32), np.zeros(0, np.float32),
                   np.zeros(0, np.int32), device)

    @property
    def count(self) -> int:
        return len(self.ids)

    # ------------------------------------------------- derived snapshots
    def with_inserted(self, vec: np.ndarray, attr: float,
                      ext_id: int) -> "DeltaView":
        """New view with one row appended (stable attribute re-sort)."""
        vecs = np.concatenate([self.vecs,
                               np.asarray(vec, np.float32)[None, :]])
        attrs = np.concatenate([self.attrs,
                                np.asarray([attr], np.float32)])
        ids = np.concatenate([self.ids, np.asarray([ext_id], np.int32)])
        o = np.argsort(attrs, kind="stable")
        return DeltaView(vecs[o], attrs[o], ids[o], self.device)

    def without(self, ext_id: int) -> "DeltaView":
        """New view with one row physically removed (delta deletes need no
        tombstone — nothing references delta rows by position)."""
        keep = self.ids != np.int32(ext_id)
        return DeltaView(self.vecs[keep], self.attrs[keep], self.ids[keep],
                         self.device)

    def subset(self, keep: np.ndarray) -> "DeltaView":
        """New view of the rows selected by a boolean mask (compaction's
        residual: rows inserted while the rebuild ran)."""
        return DeltaView(self.vecs[keep], self.attrs[keep], self.ids[keep],
                         self.device)

    # ------------------------------------------------------------- search
    def _device(self):
        if self._dev is None:
            m, d = self.vecs.shape
            cap = _next_pow2(max(m, ROW_TILE))
            d_pad = -(-d // 128) * 128
            x = np.zeros((cap, d_pad), np.float32)
            x[:m, :d] = self.vecs
            live = np.zeros((1, cap), np.int32)
            live[0, :m] = 1         # pad-tail mask
            self._dev = (torch.as_tensor(x, device=self.device),
                         torch.as_tensor(live, device=self.device), cap,
                         d_pad)
        return self._dev

    def search(self, qv: np.ndarray, attr_ranges: np.ndarray,
               k: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Exact per-query range top-k over the delta rows.

        qv: (Q, d); attr_ranges: (Q, 2) inclusive attribute values.
        Returns (ids (Q, k) int32 **external** ids (-1 pad),
        dists (Q, k) f32 squared L2 (+inf pad)), or ``None`` when the
        delta is empty (callers skip the merge entirely — keeps the
        compacted index's results bit-identical to a base-only search).
        """
        m = self.count
        if m == 0:
            return None
        lo, hi = rank_interval(self.attrs, attr_ranges)
        x_pad, live_row, cap, d_pad = self._device()
        nq = len(qv)
        pad_q = _next_pow2(max(nq, 1))
        starts = np.zeros(pad_q, np.int32)
        lens = np.zeros(pad_q, np.int32)
        starts[:nq] = lo
        lens[:nq] = np.clip(hi.astype(np.int64) - lo + 1, 0, cap)
        qp = np.zeros((pad_q, d_pad), np.float32)
        qp[:nq, :qv.shape[1]] = qv
        dev = self.device
        ids_r, dists = range_scan(x_pad, torch.as_tensor(starts, device=dev),
                                  torch.as_tensor(lens, device=dev),
                                  torch.as_tensor(qp, device=dev),
                                  bucket=cap, k=k, live=live_row)
        ids_r = ids_r.cpu().numpy()[:nq]
        dists = dists.cpu().numpy()[:nq]
        ext = np.where(ids_r >= 0, self.ids[np.maximum(ids_r, 0)], -1)
        return ext.astype(np.int32), np.where(ids_r >= 0, dists, np.inf)

"""The one general load generator: it reads a traffic file's parameters.

A traffic file names its ``loop``; the one kind so far is ``"batch"``, a
closed loop in which one client calls ``RNSGIndex.search`` back to back,
each call one block of ``batch`` pool queries, cycling through the pool.  A
request is one call, timed from the call to its results on the host.

Set-up runs one pass over the pool first (every block, so every shape the
window uses).  The window then runs for ``seconds``; with a profiler it is
one ``bench.window`` span.  Every answer is kept, with its pool index, for
the comparison after the window.
"""
from __future__ import annotations

import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from rfann_bench.devtrace import WINDOW


@dataclass
class Window:
    """What the window produced.  Per answered query: ``q_idx`` (pool
    row), ``ids``, ``dists``, ``strategy`` and ``ndist`` (the program's
    per-query stats).  Per request: ``lat_ms``."""
    t0: float
    t1: float
    attempted: int = 0
    failed: int = 0
    q_idx: np.ndarray = None
    ids: np.ndarray = None
    dists: np.ndarray = None
    strategy: np.ndarray = None
    ndist: np.ndarray = None
    lat_ms: np.ndarray = None
    calls: List[np.ndarray] = field(default_factory=list)  # pool rows / call
    call_strategy: List[np.ndarray] = field(default_factory=list)
    traces: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def answered(self) -> int:
        return len(self.q_idx)


def run(kind: str, index, corpus, traffic: dict, precision: str,
        seconds: float, prof=None, traced: bool = False) -> Window:
    if kind != "batch":
        raise ValueError(f"unknown loop kind {kind!r}")
    return batch_loop(index, corpus, traffic, precision, seconds, prof,
                      traced)


def _window_span(prof):
    """The window's span in the profiler, after a pause: kernels launched
    right after a session starts may go unrecorded."""
    if prof is None:
        return nullcontext()
    time.sleep(0.05)
    return torch.profiler.record_function(WINDOW)


def batch_loop(index, corpus, traffic, precision, seconds, prof=None,
               traced=False) -> Window:
    from repro_torch.obs import QueryTrace
    b = int(traffic["batch"])
    pool = len(corpus.queries)
    nb = pool // b
    k = int(traffic["k"])
    kw = dict(k=k, ef=int(traffic["ef"]), plan=traffic["plan"],
              beam_width=int(traffic.get("beam_width", 1)),
              precision=precision)
    for i in range(nb):                       # set-up: every block once
        index.search(corpus.queries[i * b:(i + 1) * b],
                     corpus.ranges[i * b:(i + 1) * b], **kw)
    rows, out_i, out_d, out_s, out_n, lat = [], [], [], [], [], []
    traces, failed, attempted = [], 0, 0
    with _window_span(prof):
        t0 = time.perf_counter()
        i, t = 0, t0
        while t - t0 < seconds:
            sl = slice((i % nb) * b, (i % nb + 1) * b)
            tr = QueryTrace() if traced else None
            attempted += b
            s = time.perf_counter()
            try:
                res = index.search(corpus.queries[sl], corpus.ranges[sl],
                                   trace=tr, **kw)
            except Exception:       # counted as failed; the run goes on
                failed += b
                traceback.print_exc()
                res = None
            t = time.perf_counter()
            i += 1
            if res is None:
                continue
            lat.append((t - s) * 1e3)
            rows.append(np.arange(sl.start, sl.stop))
            out_i.append(np.asarray(res.ids))
            out_d.append(np.asarray(res.dists))
            out_s.append(np.asarray(res.stats["strategy"]))
            out_n.append(np.asarray(res.stats["ndist"]))
            if tr is not None:
                traces.append(tr)
    w = Window(t0, t, attempted=attempted, failed=failed, traces=traces,
               calls=rows, call_strategy=out_s, lat_ms=np.asarray(lat))
    w.q_idx = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    w.ids = np.concatenate(out_i) if out_i else np.zeros((0, k), np.int64)
    w.dists = np.concatenate(out_d) if out_d else np.zeros((0, k))
    w.strategy = np.concatenate(out_s) if out_s else np.zeros(0, np.int8)
    w.ndist = np.concatenate(out_n) if out_n else np.zeros(0, np.int64)
    return w

"""The fused beam's launch records in traced search calls, for the ``beam``
and ``kernels`` readers (``rfann_bench/metrics/``) and for
``benchmarks/hop_profile_torch.py``.

A traced search call's ``dispatch`` span carries, under ``beam``, one
record per fused-beam launch (``repro_torch.search.substrate``): the
launch's rows and their ``hops`` and, from the card's traced
instantiation of ``csrc/beam.cu``, each block's ``t0_ns`` / ``t1_ns``
(``%globaltimer`` at entry and exit), its ``sm``, its hop-loop ``cycles``
by phase (``select``, ``expand``, ``score``, ``fold``) and in all
(``loop``), and the card's SM count ``sms``.  A program without such
records gives none, and every figure here is then None.  Each function
takes the ``QueryTrace`` objects to read (a window's ``traces``).
"""
from __future__ import annotations

from typing import List

import numpy as np


def records(traces, field: str) -> List[dict]:
    """The traces' beam records that carry ``field``."""
    return [rec for tr in traces for sp in tr.all("dispatch")
            for rec in sp.attrs.get("beam", ()) if field in rec]


def hops_per_query(traces):
    """Mean ``hops`` over the records' queries."""
    recs = records(traces, "hops")
    n = sum(len(r["hops"]) for r in recs)
    return sum(int(np.sum(r["hops"])) for r in recs) / n if n else None


def hop_us(traces):
    """One dependent hop's µs inside its block: Σ (t1 − t0) over Σ hops of
    the traced blocks."""
    recs = records(traces, "t0_ns")
    hops = sum(int(np.sum(r["hops"])) for r in recs)
    if not hops:
        return None
    ns = sum(int(np.sum(r["t1_ns"] - r["t0_ns"])) for r in recs)
    return ns / 1e3 / hops


def sm_fill(traces):
    """Per launch, Σ over SMs of the union of its blocks' [t0, t1], over
    ``sms`` × (max t1 − min t0); launches weighted by their span."""
    busy = cover = 0
    for r in records(traces, "t0_ns"):
        t0, t1 = np.asarray(r["t0_ns"]), np.asarray(r["t1_ns"])
        if not len(t0):
            continue
        busy += sm_busy_ns(np.asarray(r["sm"]), t0, t1)
        cover += int(r["sms"]) * int(t1.max() - t0.min())
    return busy / cover if cover else None


def phase_share(traces, phase: str):
    """``phase``'s cycles over the hop loop's, summed over every traced
    block."""
    recs = records(traces, "cycles")
    loop = sum(int(np.sum(r["cycles"]["loop"])) for r in recs)
    if not loop:
        return None
    return sum(int(np.sum(r["cycles"][phase])) for r in recs) / loop


def sm_busy_ns(sm, t0, t1) -> int:
    """Σ over SMs of the union of the [t0, t1] intervals of the blocks that
    ran on each."""
    busy = 0
    order = np.lexsort((t0, sm))
    sm, t0, t1 = sm[order], t0[order], t1[order]
    cur_sm, at = None, 0
    for s, a, b in zip(sm.tolist(), t0.tolist(), t1.tolist()):
        if s != cur_sm:
            cur_sm, at = s, a
        if b > at:
            busy += b - max(a, at)
            at = b
    return busy

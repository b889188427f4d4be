"""Exporters: Prometheus text format, JSON snapshots, one-line stats logs.

Three consumers of the same ``MetricsRegistry``:

* ``engine.metrics()``      — JSON snapshot (``MetricsRegistry.snapshot``
                              plus engine-level sections);
* ``to_prometheus``         — Prometheus text exposition format 0.0.4
                              (counters, gauges, full cumulative-bucket
                              histograms, producer sections as gauges),
                              written by ``launch/serve --metrics-path``;
* ``format_stats_line``     — the periodic one-line operator log the engine
                              emits under ``log_interval_s``.

``parse_prometheus`` is the matching reader used by the CI smoke step and
the tests to assert the dump round-trips.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Tuple

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")
_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")

#: metric families every serve-path export must contain (asserted by the
#: CI obs-smoke step and tests/test_obs.py)
CORE_FAMILIES = ("rnsg_engine_requests_total", "rnsg_engine_e2e_ms",
                 "rnsg_engine_batch_size", "rnsg_queries_total")


def _san(name: str, prefix: str = "rnsg") -> str:
    return f"{prefix}_{_NAME_OK.sub('_', name)}"


def _fmt(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def to_prometheus(reg: MetricsRegistry, prefix: str = "rnsg") -> str:
    """Text exposition format: ``# HELP`` / ``# TYPE`` headers, histograms
    as cumulative ``_bucket{le=...}`` series plus ``_sum`` / ``_count``.
    Histogram values are milliseconds (the ``_ms`` suffix carries the unit,
    diverging from Prometheus' base-seconds convention on purpose — every
    number in this repo's benches and logs is ms)."""
    lines = []
    for m in reg.metrics():
        name = _san(m.name, prefix)
        if isinstance(m, Counter):
            lines += [f"# HELP {name} {m.help}", f"# TYPE {name} counter",
                      f"{name} {_fmt(m.value)}"]
        elif isinstance(m, Gauge):
            lines += [f"# HELP {name} {m.help}", f"# TYPE {name} gauge",
                      f"{name} {_fmt(m.value)}"]
        elif isinstance(m, Histogram):
            lines += [f"# HELP {name} {m.help}", f"# TYPE {name} histogram"]
            edges, cum = m.bucket_counts()
            for e, c in zip(edges, cum):
                lines.append(f'{name}_bucket{{le="{_fmt(float(e))}"}} '
                             f"{_fmt(int(c))}")
            lines.append(f"{name}_sum {_fmt(m.sum)}")
            lines.append(f"{name}_count {_fmt(m.count)}")
    for section, vals in sorted(reg.producer_values().items()):
        for key, v in sorted(vals.items()):
            name = _san(f"{section}_{key}", prefix)
            lines += [f"# TYPE {name} gauge", f"{name} {_fmt(v)}"]
    return "\n".join(lines) + "\n"


def write_prometheus(reg: MetricsRegistry, path: str,
                     prefix: str = "rnsg") -> None:
    with open(path, "w") as f:
        f.write(to_prometheus(reg, prefix))


def parse_prometheus(text: str) -> Dict[Tuple[str, str], float]:
    """{(name, labels): value} for every sample line; raises ``ValueError``
    on a malformed non-comment line — this is the round-trip check the CI
    smoke step runs against the ``--metrics-path`` dump."""
    out: Dict[Tuple[str, str], float] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _LINE.match(line.strip())
        if m is None:
            raise ValueError(f"malformed prometheus line {ln}: {line!r}")
        name, labels, val = m.group(1), m.group(2) or "", m.group(3)
        out[(name, labels)] = float(val.replace("+Inf", "inf"))
    return out


def format_stats_line(snap: dict) -> str:
    """One-line operator summary from an ``engine.metrics()`` snapshot —
    what the engine logs every ``log_interval_s`` seconds."""
    eng = snap.get("engine", {})
    hists = snap.get("histograms", {})
    lat = hists.get("engine_e2e_ms", {})
    cache = snap.get("cache", {})
    parts = [f"served={int(eng.get('served', 0))}",
             f"batches={int(eng.get('batches', 0))}",
             f"mean_batch={eng.get('mean_batch', 0.0):.1f}",
             f"p50={lat.get('p50', 0.0):.2f}ms",
             f"p90={lat.get('p90', 0.0):.2f}ms",
             f"p99={lat.get('p99', 0.0):.2f}ms",
             f"scan_frac={eng.get('scan_frac', 0.0):.2f}",
             f"cache_hit_frac={eng.get('cache_hit_frac', 0.0):.2f}"]
    if cache:
        parts.append(f"cache_bytes={int(cache.get('bytes', 0))}")
    return "[obs] " + " ".join(parts)

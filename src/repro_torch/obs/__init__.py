"""End-to-end query observability for the serve path, as the reference's
``repro.obs``:

* ``repro_torch.obs.metrics``  — lock-cheap ``MetricsRegistry`` (counters,
  gauges, fixed-bucket log-scale latency histograms with p50/p90/p99
  extraction) usable from the engine's resolver/dispatcher threads;
* ``repro_torch.obs.trace``    — opt-in per-query ``QueryTrace`` records
  threaded through ``SearchRequest``/``SearchResult`` with resolve / plan /
  dispatch / stitch spans;
* ``repro_torch.obs.export``   — JSON snapshot, Prometheus text format, and
  the periodic one-line stats log; ``repro_torch.obs.profiler`` adds
  ``torch.profiler.record_function`` spans around kernel dispatch so device
  profiles line up with host spans.
"""
from repro_torch.obs.export import (CORE_FAMILIES, format_stats_line,
                                    parse_prometheus, to_prometheus,
                                    write_prometheus)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry)
from repro_torch.obs.profiler import annotate, device_trace
from repro_torch.obs.trace import SPAN_NAMES, QueryTrace, Span, maybe_span

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "default_registry",
           "QueryTrace", "Span", "maybe_span", "SPAN_NAMES",
           "to_prometheus", "write_prometheus", "parse_prometheus",
           "format_stats_line", "CORE_FAMILIES",
           "annotate", "device_trace"]

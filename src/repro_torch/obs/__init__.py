"""Per-query trace records (``QueryTrace``) threaded through the query path.
The metrics registry, exporters and profiler spans arrive with the serving
slice."""
from repro_torch.obs.trace import SPAN_NAMES, QueryTrace, Span, maybe_span

__all__ = ["QueryTrace", "Span", "maybe_span", "SPAN_NAMES"]

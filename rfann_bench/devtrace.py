"""What a ``torch.profiler`` session of the window says about the card.

The window is marked by the benchmark's own ``bench.window`` span; every
number is read inside it, in the profiler's clock.  Device records are the
kernels, copies and sets the card ran; the device-side copies of host
annotations (the program's ``rnsg.*`` spans, the benchmark's ``bench.*``)
cover the kernels they enclose and are not work.  The records are read raw,
as ``key_averages()`` would sum them, without its parse of every host
event.
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "bench.window"
NOT_WORK = ("rnsg.", "bench.", "ProfilerStep")


@dataclass
class DeviceWindow:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle(self) -> float:
        return 1.0 - self.busy_s / self.window_s if self.window_s else 1.0

    def seconds_of(self, part: str) -> float:
        """Device seconds of every record whose name holds ``part``."""
        return sum(s for n, s in self.kernel_s.items() if part in n)

    def top_ops(self, n: int = 10):
        """The n records that took most device time, each named by its
        signature up to the argument list (at most 80 characters)."""
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        return [(name.split("(")[0][:80] or name[:80], s) for name, s in top]


def read(prof, spans=()) -> DeviceWindow:
    """Busy time, device seconds by record name, and the idle gaps named
    by the innermost host op open at each gap's middle ("no_host_op" where
    none is), all within the ``bench.window`` span.  Host ops are the
    profiler's host records (the profiling thread's ops and the CUDA
    runtime calls of every thread) and ``spans``: (start ns, end ns, name)
    in the profiler's clock, such as the program's trace spans."""
    from torch.autograd import DeviceType
    w0 = w1 = None
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not (name.startswith(NOT_WORK) or e.is_hidden_event()
                    or e.is_user_annotation()):
                dev.append((e.start_ns(), e.end_ns(), name))
        elif name == WINDOW:
            w0, w1 = e.start_ns(), e.end_ns()
        elif e.device_type() == DeviceType.CPU:
            host.append((e.start_ns(), e.end_ns(), name))
    host.extend(spans)
    if w0 is None:
        raise RuntimeError(f"profiler recorded no {WINDOW} span")
    kernel_ns: Dict[str, int] = defaultdict(int)
    spans = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t > s:
            kernel_ns[name] += t - s
            spans.append((s, t))
    busy, gaps = _union(spans, w0, w1)
    named: Dict[str, int] = defaultdict(int)
    for (a, b), who in zip(gaps, _innermost(host, [(a + b) // 2
                                                   for a, b in gaps])):
        named[who] += b - a
    return DeviceWindow(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
        kernel_s={k: v / 1e9 for k, v in kernel_ns.items()},
        idle_gaps=sorted(((k, v / 1e9) for k, v in named.items()),
                         key=lambda kv: -kv[1]))


def _union(spans, w0: int, w1: int):
    """(covered ns, [(gap start, gap end)]) of intervals within [w0, w1]."""
    busy, gaps, at = 0, [], w0
    for s, t in sorted(spans):
        if s > at:
            gaps.append((at, s))
        if t > at:
            busy += t - max(s, at)
            at = t
    if w1 > at:
        gaps.append((at, w1))
    return busy, gaps


def _innermost(host, points) -> List[str]:
    """For each point (ascending), the name of the latest-starting host
    event that covers it, or "no_host_op"."""
    host = sorted(host)
    out, heap, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            s, t, name = host[i]
            heapq.heappush(heap, (-s, t, name))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "no_host_op")
    return out

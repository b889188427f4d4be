"""``torch.profiler`` integration: host-span annotations + trace capture.

``annotate(name)`` wraps a host-side region in a
``torch.profiler.record_function`` so device profiles (captured with
``device_trace``) line up with the serve path's own span names — the kernel
dispatch sites in ``repro_torch.search.substrate`` use the reference's
``rnsg.scan_dispatch`` / ``rnsg.beam_dispatch`` /
``rnsg.graph_beam_dispatch``.  With no profiler session active a
``record_function`` only records its name, so the annotations stay on
unconditionally.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch


def annotate(name: str):
    """Context manager marking a host region in the profiler timeline."""
    return torch.profiler.record_function(name)


@contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` session (host ops, and the card's
    kernels when CUDA is present) around a block and write it as a Chrome
    trace, ``<log_dir>/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

"""Device ms of the range scan's launches (``range_scan*``) per 1,024
scan-routed queries answered in the traced window (``torch.profiler``)."""
import numpy as np

from repro_torch.planner import SCAN


def read(ctx):
    if ctx.device is None:
        return None
    n = int(np.sum(ctx.window.strategy == SCAN))
    s = ctx.device.seconds_of("range_scan")
    return s * 1e3 * 1024 / n if n and s > 0 else None

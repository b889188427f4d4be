"""Share of the window's queries the planner routed to the scan (the
program's per-query ``stats["strategy"]``)."""
import numpy as np

from repro_torch.planner import SCAN


def read(ctx):
    s = ctx.window.strategy
    return float(np.mean(s == SCAN)) if len(s) else None

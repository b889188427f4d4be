"""Mean distance evaluations per beam-routed query (the program's
per-query ``stats["ndist"]``) answered in the window."""
import numpy as np

from repro_torch.planner import SCAN


def read(ctx):
    w = ctx.window
    beam = w.strategy != SCAN
    return float(np.mean(w.ndist[beam])) if beam.any() else None

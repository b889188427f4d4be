"""95th percentile of the latency of every request answered in the window:
one ``search`` call, on the host clock.  Judged only where the card sets
the pace."""
import numpy as np


def read(ctx):
    lat = ctx.window.lat_ms
    return float(np.percentile(lat, 95)) if len(lat) else None

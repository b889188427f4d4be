"""The range scan's share of its roofline, in %: the least time of each
search call's scan work (``roofline.scan_least_s``: the union of the
scan-routed queries' rank windows read once, or their operations, from the
ranks and shapes alone) summed over the traced window, over the
``range_scan*`` kernels' device time there (``torch.profiler``)."""
import numpy as np

from rfann_bench import roofline
from repro_torch.planner import SCAN


def read(ctx):
    if ctx.device is None:
        return None
    dev_s = ctx.device.seconds_of("range_scan")
    if dev_s <= 0:
        return None
    d, k = int(ctx.config["d"]), int(ctx.traffic["k"])
    least = 0.0
    for rows, strat in zip(ctx.window.calls, ctx.window.call_strategy):
        sc = rows[np.asarray(strat) == SCAN]
        if len(sc):
            least += roofline.scan_least_s(ctx.pool_lo[sc], ctx.pool_hi[sc],
                                           d, k, ctx.config["precision"])[0]
    return 100.0 * least / dev_s

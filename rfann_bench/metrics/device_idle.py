"""Share of the traced window in which no operation ran on the card:
1 - (union of device records' intervals) / window (``torch.profiler``)."""


def read(ctx):
    return ctx.device.idle if ctx.device is not None else None

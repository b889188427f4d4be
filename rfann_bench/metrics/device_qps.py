"""Queries answered in the window over the seconds of it in which the card
was busy (the union of the profiler's device records, ``torch.profiler``):
the rate the card's own work allows, which host work left on the path does
not move."""


def read(ctx):
    d = ctx.device
    if d is None or d.busy_s <= 0:
        return None
    return ctx.window.answered / d.busy_s

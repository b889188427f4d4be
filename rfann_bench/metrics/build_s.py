"""``RNSGIndex.build`` wall seconds in set-up, closed by a synchronize."""


def read(ctx):
    return ctx.build_s

"""Seconds from the process' start to the window's first request."""


def read(ctx):
    return ctx.setup_s

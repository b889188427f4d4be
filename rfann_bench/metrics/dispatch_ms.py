"""Mean wall ms of the program's ``dispatch`` span per search call (its
``QueryTrace``; host clock, the enqueue of the device work and, on the
synchronous path, the wait for it)."""


def read(ctx):
    ms = [tr.wall_ms("dispatch") for tr in ctx.window.traces
          if tr.all("dispatch")]
    return sum(ms) / len(ms) if ms else None

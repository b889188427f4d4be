"""Microseconds of one dependent hop inside its block: Σ (t1 − t0) over
Σ hops of the window's traced fused-beam blocks (``%globaltimer`` at block
entry and exit, ``beamrec``)."""
from rfann_bench import beamrec


def read(ctx):
    return beamrec.hop_us(ctx.window.traces)

"""Share of the fused beam's hop-loop cycles spent in scoring the fresh
neighbours (score_fresh): thread 0's ``%clock`` cycles of that phase over the
loop's, summed over the window's traced blocks (``beamrec``)."""
from rfann_bench import beamrec


def read(ctx):
    return beamrec.phase_share(ctx.window.traces, "score")

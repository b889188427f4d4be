"""Share of the fused beam's hop-loop cycles spent in the expansion: the
neighbour row and the visited test and set (bw 1), or the hop, pool and
table dedup and the insert (bw > 1): thread 0's ``%clock`` cycles of that
phase over the loop's, summed over the window's traced blocks
(``beamrec``)."""
from rfann_bench import beamrec


def read(ctx):
    return beamrec.phase_share(ctx.window.traces, "expand")

"""Mean dependent hops per beam-routed query answered in the traced window:
the ``hops`` of the program's fused-beam launch records (``beamrec``)."""
from rfann_bench import beamrec


def read(ctx):
    return beamrec.hops_per_query(ctx.window.traces)

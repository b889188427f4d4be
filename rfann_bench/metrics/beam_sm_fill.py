"""Share of the SM-time of the window's fused-beam launches that held a
block: per launch, Σ over SMs of the union of its blocks' [t0, t1]
(``%globaltimer``, ``%smid``), over ``sms`` × (max t1 − min t0); launches
weighted by their span (``beamrec``).  1 − fill is the SM-time the
launch's shape and its tail leave empty."""
from rfann_bench import beamrec


def read(ctx):
    return beamrec.sm_fill(ctx.window.traces)

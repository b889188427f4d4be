"""The fused beam's readers (``hops_per_query``, ``beam_hop_us``,
``beam_sm_fill`` and the four phase shares) on hand-built launch records
with known answers, None where no record carries what they read, and a
traced run of the wide cell on the CPU, whose plain beam records hops
alone."""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from rfann_bench import beamrec
from rfann_bench.spec import Spec
from rfann_bench.test_rfann_bench_harness import CELLS, Tiny, _run
from repro_torch.obs import QueryTrace

ROOT = Path(__file__).resolve().parents[1]
BEAM = ("hops_per_query", "beam_hop_us", "beam_sm_fill", "beam_select_share",
        "beam_expand_share", "beam_score_share", "beam_fold_share")
TIMED = BEAM[1:]


def _launch(sm, t0, t1, hops, cycles, sms=2):
    a = lambda v: np.asarray(v, np.int64)
    return dict(rows=np.arange(len(sm)), hops=a(hops), t0_ns=a(t0),
                t1_ns=a(t1), sm=a(sm), sms=sms,
                cycles={k: a(v) for k, v in cycles.items()})


def _ctx(*calls):
    """A window of traced calls, each a list of beam records on its
    ``dispatch`` span (None: a dispatch span without the key)."""
    traces = []
    for recs in calls:
        tr = QueryTrace()
        if recs is None:
            tr.add_span("dispatch")
        else:
            tr.add_span("dispatch", beam=list(recs))
        traces.append(tr)
    return SimpleNamespace(window=SimpleNamespace(traces=traces))


#: two SMs: blocks on SM 0 over [0, 10] and [5, 20] (union 20), on SM 1
#: over [0, 10]; the launch spans 20 ns on 2 SMs
ONE = _launch(sm=[0, 0, 1], t0=[0, 5, 0], t1=[10, 20, 10], hops=[2, 3, 5],
              cycles=dict(select=[1, 2, 0], expand=[2, 2, 0],
                          score=[3, 2, 0], fold=[4, 2, 0], loop=[10, 8, 0]))
#: a second launch: one block on SM 1 over [100, 140]
TWO = _launch(sm=[1], t0=[100], t1=[140], hops=[4],
              cycles=dict(select=[1], expand=[1], score=[1], fold=[1],
                          loop=[5]))
#: the plain path's record: rows and hops alone
PLAIN = dict(rows=np.arange(2), hops=np.array([1, 1]))


def _read(name, ctx):
    return Spec(ROOT).reader(name)(ctx)


def test_readers_give_known_answers():
    ctx = _ctx([ONE], [TWO, PLAIN], None)
    assert _read("hops_per_query", ctx) == pytest.approx(16 / 6)
    assert _read("beam_hop_us", ctx) == pytest.approx(75 / 14 / 1e3)
    assert _read("beam_sm_fill", ctx) == pytest.approx(70 / 120)
    for phase, num in dict(select=4, expand=5, score=6, fold=7).items():
        assert _read(f"beam_{phase}_share", ctx) == pytest.approx(num / 23)


def test_sm_fill_of_one_launch_and_the_sm_union():
    assert _read("beam_sm_fill", _ctx([ONE])) == pytest.approx(30 / 40)
    sm = np.array([3, 3, 3, 0])
    t0 = np.array([0, 2, 50, 7])
    t1 = np.array([4, 3, 60, 9])
    assert beamrec.sm_busy_ns(sm, t0, t1) == 4 + 10 + 2


@pytest.mark.parametrize("name", BEAM)
def test_readers_return_none_without_records(name):
    for ctx in (_ctx(), _ctx(None), _ctx([])):
        assert _read(name, ctx) is None
    expect_plain = None if name in TIMED else 1.0
    assert _read(name, _ctx([PLAIN])) == expect_plain


def test_the_wide_cell_lists_the_readers_and_the_narrow_one_does_not():
    spec = Spec(ROOT)
    wide = {m["name"]: m for m in spec.metrics(CELLS[0], True)}
    assert set(BEAM) <= set(wide)
    assert all(wide[n]["moves"] == "qps" for n in BEAM)
    assert not set(BEAM) & {m["name"] for m in spec.metrics(CELLS[1], True)}
    assert not set(BEAM) & {m["name"] for m in spec.metrics(CELLS[0], False)}


def test_traced_wide_run_on_the_cpu_reads_hops_alone():
    """The plain beam's records hold hops but no timers: a traced run of
    the wide cell reports ``hops_per_query`` and none of the timed
    readings."""
    line = _run(Tiny(ROOT), CELLS[0], trace=True)
    assert line["correct"]
    hops = line["metrics"]["hops_per_query"]
    assert hops["unit"] == "hops" and hops["value"] > 0
    assert not set(TIMED) & set(line["metrics"])

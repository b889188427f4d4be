"""The fused beam's trace: a traced search against an untraced one on the
CPU, the ``beam`` records on the ``dispatch`` span, ``to_dict`` through
them, and the program spans under a ``torch.profiler`` session; on the card
(marked ``gpu``, skipped without one) the kernel's traced instantiation
against the untraced one, bit for bit, and its record's invariants."""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.search.substrate as sub
from repro_torch.core.rfann import RNSGIndex
from repro_torch.data.ann import make_attrs, make_vectors, selectivity_ranges
from repro_torch.kernels import ops
from repro_torch.kernels.beam import PHASES, TRACE_FIELDS
from repro_torch.obs import QueryTrace
from repro_torch.obs.trace import _plain
from repro_torch.planner import SCAN

N, D, NQ = 512, 16, 48


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small torch ops, cores shared by workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _index(device):
    v, a = make_vectors(N, D, seed=0), make_attrs(N, seed=0)
    return RNSGIndex.build(v, a, m=16, ef_spatial=16, ef_attribute=24,
                           device=device), a


def _queries(attrs):
    """Queries over ranges from the whole corpus down to a few rows, so
    that ``plan="auto"`` routes some to the scan and some to the beam."""
    qv = make_vectors(NQ, D, seed=3)
    ranges = np.concatenate([selectivity_ranges(attrs, NQ // 4, f, seed=i)
                             for i, f in enumerate((1.0, 0.25, 0.05, 0.01))])
    return qv, ranges


@pytest.fixture(scope="module")
def cpu_index():
    return _index("cpu")


def _beam_records(tr):
    return [rec for sp in tr.all("dispatch") for rec in sp.attrs.get("beam",
                                                                     [])]


def _search_pair(idx, qv, ranges, monkeypatch, **kw):
    """The same search untraced and traced, from the same planner state:
    (untraced result, traced result, its trace, fused-beam calls of the
    traced search)."""
    state = json.dumps(idx.planner.cost.state_dict())
    calls = []
    inner = sub.beam_search_batch

    def counted(*a, **k):
        calls.append(k.get("trace"))
        return inner(*a, **k)

    monkeypatch.setattr(sub, "beam_search_batch", counted)
    plain = idx.search(qv, ranges, **kw)
    idx.planner.cost.load_state_dict(json.loads(state))
    calls.clear()
    tr = QueryTrace()
    traced = idx.search(qv, ranges, trace=tr, **kw)
    return plain, traced, tr, calls


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("bw", [1, 4])
@pytest.mark.parametrize("plan", ["graph", "auto"])
def test_traced_search_equals_untraced_and_records_each_beam_launch(
        cpu_index, monkeypatch, plan, bw, use_kernel):
    """Ids, distances and stats of a traced search equal an untraced one's;
    the ``dispatch`` span holds one ``beam`` record per beam launch, rows
    and hops alone on the plain path (no timers), whose hops are
    ``stats["hops"]`` on its rows; the record stays out of the stats, and
    the trace serializes."""
    idx, attrs = cpu_index
    qv, ranges = _queries(attrs)
    plain, traced, tr, calls = _search_pair(
        idx, qv, ranges, monkeypatch, k=5, ef=32, plan=plan, beam_width=bw,
        use_kernel=use_kernel)
    assert np.array_equal(plain.ids, traced.ids)
    assert np.array_equal(plain.dists, traced.dists)
    assert plain.stats.keys() == traced.stats.keys()
    assert "record" not in traced.stats
    for key, val in plain.stats.items():
        assert np.array_equal(val, traced.stats[key]), key
    recs = _beam_records(tr)
    assert calls and calls == [True] * len(calls)
    assert len(recs) == len(calls)
    beam_rows = np.flatnonzero(traced.stats["strategy"] != SCAN)
    assert sorted(np.concatenate([r["rows"] for r in recs])) == \
        sorted(beam_rows)
    for rec in recs:
        assert set(rec) == {"rows", "hops"}
        assert np.array_equal(rec["hops"], traced.stats["hops"][rec["rows"]])
    doc = json.loads(json.dumps(tr.to_dict()))
    (disp,) = [s for s in doc["spans"] if s["name"] == "dispatch"]
    assert disp["attrs"]["beam"][0]["hops"] == recs[0]["hops"].tolist()


def test_untraced_search_records_nothing(cpu_index, monkeypatch):
    """With no trace the beam is asked for no record."""
    idx, attrs = cpu_index
    qv, ranges = _queries(attrs)
    calls = []
    inner = sub.beam_search_batch

    def counted(*a, **k):
        calls.append(k.get("trace"))
        return inner(*a, **k)

    monkeypatch.setattr(sub, "beam_search_batch", counted)
    res = idx.search(qv, ranges, k=5, ef=32, plan="graph")
    assert calls == [False] and "record" not in res.stats


def test_plain_converts_nested_numpy():
    """``to_dict`` reaches numpy values inside dicts, lists and tuples."""
    tr = QueryTrace("r1", seed=np.int64(3))
    tr.add_span("dispatch", beam=[{"rows": np.arange(3), "cycles": {
        "loop": np.array([7, 8, 9]), "sms": np.int32(132)}}],
        pair=(np.float32(0.5), np.bool_(True)))
    doc = json.loads(json.dumps(tr.to_dict()))
    attrs = doc["spans"][0]["attrs"]
    assert attrs["beam"] == [{"rows": [0, 1, 2], "cycles": {
        "loop": [7, 8, 9], "sms": 132}}]
    assert attrs["pair"] == [0.5, True] and doc["meta"] == {"seed": 3}
    assert _plain({"a": [np.int8(1)]}) == {"a": [1]}


def test_spans_open_profiler_ranges_only_in_a_session(cpu_index,
                                                      monkeypatch):
    """Under a ``torch.profiler`` session the spans appear as
    ``rnsg.<span>`` ranges beside the substrate's own annotations; with no
    session none of them enters a ``record_function``."""
    idx, attrs = cpu_index
    qv, ranges = _queries(attrs)
    seen = []
    real = torch.profiler.record_function

    def spy(name, *a, **kw):
        seen.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    kw = dict(k=5, ef=32, plan="auto")
    idx.search(qv, ranges, trace=QueryTrace(), **kw)
    assert not [n for n in seen if n.startswith("rnsg.")]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        idx.search(qv, ranges, trace=QueryTrace(), **kw)
    names = {e.name for e in prof.events()}
    assert {"rnsg.resolve", "rnsg.plan", "rnsg.dispatch",
            "rnsg.stitch"} <= names
    assert "rnsg.beam_dispatch" in names      # the substrate's own annotation
    seen.clear()
    idx.search(qv, ranges, trace=QueryTrace(), **kw)
    assert not [n for n in seen if n.startswith("rnsg.")]


def test_trace_fields_follow_the_kernel_enum():
    """``TRACE_FIELDS`` names the kernel's ``TraceField`` record in its
    order, and its width is the enum's last member."""
    src = (Path(sub.__file__).parents[1] / "csrc" / "beam.cu").read_text()
    body = re.search(r"enum TraceField \{(.*?)\};", src, re.S).group(1)
    names = [w.strip() for w in body.split(",") if w.strip()]
    assert names == [f"TR_{f.upper()}" for f in TRACE_FIELDS] + [
        "TRACE_FIELDS"]
    assert set(PHASES) < set(TRACE_FIELDS)


# ----------------------------------------------------------------- on card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _beam_inputs(cuda, precision, n=4096, d=32, q=256, m=24):
    """A random graph with pads, queries over ranges of every width, and
    the corpus the beam scores in ``precision``."""
    from repro_torch.kernels.quantize import quantize_corpus
    rng = np.random.default_rng(23)
    x = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    nbrs = rng.integers(0, n, (n, m)).astype(np.int32)
    nbrs[rng.random((n, m)) < 0.15] = -1
    lo = rng.integers(0, n, q)
    hi = np.minimum(lo + (n >> rng.integers(0, 10, q)), n - 1)
    entry = ((lo + hi) // 2).clip(0, n - 1)
    scale = None
    if precision != "f32":
        qc = quantize_corpus(x, precision)
        x, scale = qc.data, qc.scale
        scale = None if scale is None else scale.to(cuda)
    qv = torch.as_tensor(rng.standard_normal((q, d)), dtype=torch.float32)
    t = lambda a: torch.as_tensor(a, device=cuda)
    return (x.to(cuda), scale, t(nbrs), qv.to(cuda), t(lo), t(hi), t(entry))


def _check_record(rec, sms):
    """Per block: entry before exit, an SM of the card, a loop that took
    cycles, and phases that are non-negative and sum to no more than the
    loop."""
    f = dict(zip(TRACE_FIELDS, rec.cpu().numpy().T))
    assert (f["t0_ns"] <= f["t1_ns"]).all() and (f["t0_ns"] > 0).all()
    assert ((0 <= f["sm"]) & (f["sm"] < sms)).all()
    phases = np.stack([f[p] for p in PHASES])
    assert (phases >= 0).all()
    assert (phases.sum(0) <= f["loop"]).all()
    assert (f["loop"] > 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("bw", [1, 4])
@pytest.mark.parametrize("precision", ["f32", "int8", "bf16"])
def test_traced_launch_is_bit_equal_on_card(cuda, precision, bw):
    """The traced instantiation returns the untraced one's pools, hops and
    ndist bit for bit, and one sound record per block."""
    args = _beam_inputs(cuda, precision)
    kw = dict(ef=64, steps_cap=8 * 64 + 64, early_stop=True)
    run = ops.beam_single
    if bw > 1:
        run, kw["beam_width"] = ops.beam_batched, bw
    want = run(*args, **kw)
    got = run(*args, trace=True, **kw)
    assert len(want) == 4 and len(got) == 5
    for g, w in zip(got[:4], want):
        assert torch.equal(g, w)
    rec = got[4]
    assert rec.dtype == torch.int64
    assert rec.shape == (args[3].shape[0], len(TRACE_FIELDS))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _check_record(rec, sms)


@pytest.mark.gpu
def test_block_stamps_lie_inside_the_launch_on_card(cuda):
    """The blocks' %globaltimer span of a launch of 1,024 queries lies
    inside the CUDA events around the call and covers most of it."""
    args = _beam_inputs(cuda, "f32", q=1024)
    kw = dict(ef=256, steps_cap=8 * 256 + 64, early_stop=True)
    ops.beam_single(*args, trace=True, **kw)            # warm
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    rec = ops.beam_single(*args, trace=True, **kw)[4]
    ev[1].record()
    torch.cuda.synchronize()
    f = dict(zip(TRACE_FIELDS, rec.cpu().numpy().T))
    span_ms = (f["t1_ns"].max() - f["t0_ns"].min()) / 1e6
    event_ms = ev[0].elapsed_time(ev[1])
    assert 0.5 * event_ms <= span_ms <= event_ms * 1.001 + 0.002, \
        (span_ms, event_ms)


@pytest.mark.gpu
@pytest.mark.parametrize("bw", [1, 4])
@pytest.mark.parametrize("plan", ["graph", "auto"])
def test_search_records_blocks_on_card(cuda, plan, bw):
    """A traced search on the card: one record per fused-beam launch with
    each row's hops (``stats["hops"]``, the kernel's ``out_steps``),
    stamps, SM and phase cycles, and the card's SM count; its answers equal
    an untraced search's."""
    idx, attrs = _index(cuda)
    qv, ranges = _queries(attrs)
    kw = dict(k=5, ef=32, plan=plan, beam_width=bw)
    state = json.dumps(idx.planner.cost.state_dict())
    plain = idx.search(qv, ranges, **kw)
    idx.planner.cost.load_state_dict(json.loads(state))
    tr = QueryTrace()
    res = idx.search(qv, ranges, trace=tr, **kw)
    assert np.array_equal(plain.ids, res.ids)
    assert np.array_equal(plain.stats["hops"], res.stats["hops"])
    recs = _beam_records(tr)
    assert recs
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for rec in recs:
        assert rec["sms"] == sms
        assert np.array_equal(rec["hops"], res.stats["hops"][rec["rows"]])
        assert (rec["t0_ns"] <= rec["t1_ns"]).all()
        assert ((0 <= rec["sm"]) & (rec["sm"] < sms)).all()
        cyc = rec["cycles"]
        assert (sum(cyc[p] for p in PHASES) <= cyc["loop"]).all()
    json.dumps(tr.to_dict())

"""The port's search path against the reference's, on the corpora and ranges
of ``tests/test_search_substrate.py`` (narrow, wide, empty, single-point and
full-span ranges), with and without a ``live`` mask.

Both indexes hold the same graph (the port's is carried across with
``graph_from_arrays``), so every difference is a difference of search."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.beam import beam_search_batch as jbeam
from repro.core.rfann import RNSGIndex as JIndex
from repro.data.ann import make_attrs, make_vectors, selectivity_ranges
from repro.planner import QueryPlanner as JPlanner
from repro.search import merge_topk as jmerge
from repro.search import select_entry as jselect
from repro_torch.core.beam import beam_search_batch
from repro_torch.core.construction import graph_from_arrays
from repro_torch.core.rfann import RNSGIndex
from repro_torch.obs import QueryTrace
from repro_torch.planner import QueryPlanner
from repro_torch.search import merge_topk, select_entry

N, D, NQ, K = 256, 16, 15, 8
FIELDS = ("vecs", "attrs", "nbrs", "order", "centroid", "dist_c", "rmq")


def _degenerate_ranges(attrs, nq, seed):
    s = np.sort(attrs)
    return np.concatenate([
        selectivity_ranges(attrs, nq - 3, 0.2, seed=seed),
        np.asarray([[s[5] + 1e-7, s[5] + 2e-7],     # empty
                    [s[17], s[17]],                 # single point
                    [s[0], s[-1]]], np.float32)])   # full span


@pytest.fixture(scope="module")
def pair():
    vecs = make_vectors(N, D, seed=0)
    attrs = make_attrs(N, seed=0)
    ref = JIndex.build(vecs, attrs, m=16, ef_spatial=16, ef_attribute=24)
    port = RNSGIndex(graph_from_arrays(
        {f: np.asarray(getattr(ref.g, f)) for f in FIELDS}, "cpu"))
    qv = make_vectors(NQ, D, seed=7)
    ranges = _degenerate_ranges(attrs, NQ, seed=11)
    live = np.random.default_rng(3).random(N) < 0.8
    return ref, port, qv, ranges, live


@pytest.mark.parametrize("use_live", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("bw", [1, 4])
def test_graph_ids_hops_ndist_equal(pair, bw, use_kernel, use_live):
    """plan="graph" below the exhaustive regime (ef < n): ids, and per
    query hops and ndist, equal the reference's."""
    ref, port, qv, ranges, live = pair
    kw = dict(k=K, ef=32, plan="graph", beam_width=bw, use_kernel=use_kernel,
              live=live if use_live else None)
    want = ref.search(qv, ranges, **kw)
    got = port.search(qv, ranges, **kw)
    assert np.array_equal(got.ids, want.ids)
    for s in ("hops", "ndist"):
        assert np.array_equal(got.stats[s], want.stats[s]), s
    fin = np.isfinite(want.dists)
    assert np.array_equal(np.isfinite(got.dists), fin)
    assert np.allclose(got.dists[fin], want.dists[fin], rtol=1e-5, atol=1e-4)
    if use_live:
        assert all(live[port.g.order.numpy().argsort()[i]] for i in
                   got.ids[got.ids >= 0])


@pytest.mark.parametrize("use_live", [False, True])
def test_strategy_parity_exhaustive(pair, use_live):
    """With ef >= n every strategy is exact: graph/auto/scan/beam (and the
    batched width) return the reference's id sets, and the port's own
    strategies agree with each other, degenerate rows included."""
    ref, port, qv, ranges, live = pair
    lv = live if use_live else None
    base = ref.search(qv, ranges, k=K, ef=N, plan="graph", live=lv).ids
    runs = {}
    for plan in ("graph", "auto", "scan", "beam"):
        for bw in ((1, 4) if plan != "scan" else (1,)):
            for uk in (False, True):
                runs[(plan, bw, uk)] = port.search(
                    qv, ranges, k=K, ef=N, plan=plan, beam_width=bw,
                    use_kernel=uk, live=lv).ids
    for q in range(NQ):
        want = set(base[q][base[q] >= 0].tolist())
        for name, ids in runs.items():
            got = set(ids[q][ids[q] >= 0].tolist())
            assert got == want, (name, q)
    g = runs[("graph", 1, False)]
    assert (g[NQ - 3] == -1).all()                              # empty
    assert g[NQ - 2][0] >= 0 and (g[NQ - 2][1:] == -1).all()    # single
    if not use_live:
        assert (g[NQ - 1] >= 0).all()                           # full span


@pytest.mark.parametrize("plan", ["auto", "scan", "beam"])
def test_planned_results_equal_reference(pair, plan):
    """Planned dispatch below the exhaustive regime: same ids, same
    routing, same stats as the reference from the same starting state."""
    ref, port, qv, ranges, _ = pair
    port.planner.cost.load_state_dict(ref.planner.cost.state_dict())
    want = ref.search(qv, ranges, k=K, ef=32, plan=plan)
    got = port.search(qv, ranges, k=K, ef=32, plan=plan)
    assert np.array_equal(got.ids, want.ids)
    assert np.array_equal(got.stats["strategy"], want.stats["strategy"])
    assert got.stats["scan_frac"] == want.stats["scan_frac"]
    beam = want.stats["strategy"] == 1
    for s in ("hops", "ndist"):
        assert np.array_equal(got.stats[s][beam], want.stats[s][beam]), s


def test_same_calibration_gives_same_partitions(tmp_path):
    """A calibration state moves across the packages (JSON both ways) and
    plans the same partitions."""
    rng = np.random.default_rng(0)
    lo = rng.integers(0, 4000, 200)
    hi = lo + rng.integers(-5, 3000, 200)
    jp, tp = JPlanner(4096, 12.0), QueryPlanner(4096, 12.0)
    jp.cost.update_beam(300.0, 64)
    jp.cost.observe_wall("scan", 640, 0.002, 8)
    jp.cost.observe_wall("beam", 300, 0.004, 8)
    jp.save_calibration(str(tmp_path / "j.json"))
    tp.load_calibration(str(tmp_path / "j.json"))
    tp.save_calibration(str(tmp_path / "t.json"))
    with open(tmp_path / "j.json") as f, open(tmp_path / "t.json") as g:
        assert json.load(f) == json.load(g)
    for mode in ("auto", "scan", "beam"):
        a = jp.plan_batch(lo, hi, k=10, ef=64, mode=mode, beam_width=2)
        b = tp.plan_batch(lo, hi, k=10, ef=64, mode=mode, beam_width=2)
        assert np.array_equal(a.strategy, b.strategy)
        assert [p.signature for p in a.partitions] == \
            [p.signature for p in b.partitions]
        for pa, pb in zip(a.partitions, b.partitions):
            assert np.array_equal(pa.indices, pb.indices)


def test_multi_entry_beam_matches_reference(pair):
    """beam_search_batch with a (Q, E) entry matrix (-1 = no entry)."""
    ref, port, qv, _, _ = pair
    rng = np.random.default_rng(4)
    lo = rng.integers(0, 128, 6).astype(np.int32)
    hi = (lo + rng.integers(20, 120, 6)).astype(np.int32)
    entry = np.stack([lo, (lo + hi) // 2, hi], 1).astype(np.int32)
    entry[0, 1] = -1
    g = ref.g
    for bw in (1, 3):
        ji, jd, js = jbeam(jnp.asarray(g.vecs), jnp.asarray(g.nbrs),
                           jnp.asarray(qv[:6]), jnp.asarray(lo),
                           jnp.asarray(hi), jnp.asarray(entry), k=5, ef=16,
                           beam_width=bw)
        ti, td, ts = beam_search_batch(
            port.g.vecs, port.g.nbrs, torch.as_tensor(qv[:6]),
            torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(entry),
            k=5, ef=16, beam_width=bw)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        for s in ("hops", "ndist"):
            assert np.array_equal(ts[s].numpy(), np.asarray(js[s]))


@pytest.mark.parametrize("bw", [1, 4])
def test_beam_without_early_stop_matches_reference(pair, bw):
    """``early_stop=False`` (the legacy condition the substrate bench
    times): a pool that never fills runs to the 8·ef+64 cap, with the
    reference's ids, hops and ndist."""
    ref, port, qv, _, _ = pair
    lo = np.asarray([0, 10, 40, 100, 7, 200], np.int32)
    hi = np.asarray([255, 13, 90, 100, 6, 230], np.int32)   # narrow, empty
    g = ref.g
    entry = np.asarray(jselect(jnp.asarray(g.rmq), jnp.asarray(g.dist_c),
                               jnp.asarray(lo), jnp.asarray(hi), N))
    ji, _, js = jbeam(jnp.asarray(g.vecs), jnp.asarray(g.nbrs),
                      jnp.asarray(qv[:6]), jnp.asarray(lo), jnp.asarray(hi),
                      jnp.asarray(entry), k=5, ef=16, beam_width=bw,
                      early_stop=False)
    ti, _, ts = beam_search_batch(
        port.g.vecs, port.g.nbrs, torch.as_tensor(qv[:6]),
        torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(entry),
        k=5, ef=16, beam_width=bw, early_stop=False)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    for s in ("hops", "ndist"):
        assert np.array_equal(ts[s].numpy(), np.asarray(js[s])), s
    assert (ts["hops"].numpy() == 8 * 16 + 64).any()


def test_select_entry_and_merge_topk_match_reference(pair):
    ref, port, _, _, _ = pair
    rng = np.random.default_rng(5)
    lo = rng.integers(-1, N + 1, 50)
    hi = rng.integers(-1, N + 1, 50)
    want = jselect(jnp.asarray(ref.g.rmq), jnp.asarray(ref.g.dist_c),
                   jnp.asarray(lo), jnp.asarray(hi), N)
    got = select_entry(port.g.rmq, port.g.dist_c, torch.as_tensor(lo),
                       torch.as_tensor(hi), N)
    assert np.array_equal(got.numpy(), np.asarray(want))
    ids = rng.integers(-1, 100, (3, 4, 5)).astype(np.int32)
    d = np.round(rng.random((3, 4, 5)), 1).astype(np.float32)  # many ties
    d = np.sort(np.where(ids < 0, np.inf, d), axis=-1).astype(np.float32)
    wi, wd = jmerge(jnp.asarray(ids), jnp.asarray(d), 6)
    gi, gd = merge_topk(torch.as_tensor(ids), torch.as_tensor(d), 6)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gd.numpy(), np.asarray(wd))


def test_trace_spans_and_unported_precision(pair):
    """An f32 search traces exactly resolve/plan/dispatch/stitch; a
    quantized scan adds one rerank span per scan partition, each naming the
    precision; a precision neither package has is refused with the
    reference's message."""
    _, port, qv, ranges, _ = pair
    tr = QueryTrace("r1")
    res = port.search(qv, ranges, k=K, ef=32, plan="auto", trace=tr)
    assert res.trace is tr
    assert tr.names() == ["resolve", "plan", "dispatch", "stitch"]
    tr = QueryTrace("r2")
    res = port.search(qv, ranges, k=K, ef=32, plan="scan", trace=tr,
                      precision="int8")
    assert res.trace is tr
    names = tr.names()
    assert names[:2] == ["resolve", "plan"] and names[-2:] == ["dispatch",
                                                               "stitch"]
    assert set(names[2:-2]) == {"rerank"}          # one per scan partition
    assert all(sp.attrs["precision"] == "int8" for sp in tr.spans[1:-1])
    with pytest.raises(ValueError, match="invalid precision='f16'"):
        port.search(qv, ranges, k=K, precision="f16")

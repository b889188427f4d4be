"""The port's streaming index (``repro_torch.streaming``) against the
reference's: both start from one base state and take the same mutations;
their searches return the same ids (exactly, or gap-aware at near-ties)
before and after a compaction, the compacted bases are the same arrays, and
the delta segment's scan equals the reference's.  Also the oracle-backed
interleaved sweep, the reconcile of mutations racing a compaction, and
queries racing compactions through the port's engine."""
import threading

import numpy as np
import pytest
import torch

from repro.index import io as jio
from repro.streaming import DeltaView as JDelta
from repro.streaming import StreamingRFANN as JStream
from repro_torch.index import io
from repro_torch.serving.engine import RFANNEngine
from repro_torch.streaming import DeltaView, StreamingRFANN

_BUILD = dict(m=8, ef_spatial=16, ef_attribute=24)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small torch ops, cores shared by workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def _rand_range(rng):
    a, b = np.sort(rng.random(2).astype(np.float32))
    if rng.random() < 0.1:
        a, b = np.float32(0.0), np.float32(1.0)
    return a, b


def _pair(rng, n0, d, **kw):
    """The reference's streaming index and the port's, restored from its
    state, so both start from one base graph."""
    vecs = rng.standard_normal((n0, d)).astype(np.float32)
    attrs = rng.random(n0).astype(np.float32)
    ref = JStream(vecs, attrs, **_BUILD, **kw)
    flat, man = jio.index_state(ref)
    port = io.index_from_state({k: np.array(x) for k, x in flat.items()},
                               man, device="cpu")
    return ref, port


def _same_ids(got, want):
    """Equal id rows, except where two neighbours tie within f32 noise
    (then the sets of the tied distances must agree)."""
    gi, wi = np.asarray(got.ids), np.asarray(want.ids)
    gd, wd = np.asarray(got.dists), np.asarray(want.dists)
    fin = np.isfinite(wd)
    assert np.array_equal(np.isfinite(gd), fin)
    assert np.allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-4)
    for r in np.flatnonzero((gi != wi).any(1)):
        diff = gi[r] != wi[r]
        assert np.allclose(gd[r][diff], wd[r][diff], rtol=1e-4, atol=1e-4), (
            f"row {r}: ids {gi[r]} vs {wi[r]}")


def _mutate(rng, pair, d, n_ins, n_del):
    for _ in range(n_ins):
        v = rng.standard_normal(d).astype(np.float32)
        a = float(rng.random())
        ids = [s.insert(v, a) for s in pair]
        assert ids[0] == ids[1]
    for _ in range(n_del):
        live = sorted(pair[0]._id_loc)
        victim = int(live[rng.integers(len(live))])
        for s in pair:
            s.delete(victim)


@pytest.mark.parametrize("plan", ["scan", "auto", "graph"])
def test_searches_equal_the_reference_before_and_after_compaction(plan):
    rng = np.random.default_rng(7)
    n0, d, k = 200, 8, 6
    pair = _pair(rng, n0, d, max_delta=10**9)
    _mutate(rng, pair, d, 40, 30)
    ref, port = pair
    qv = rng.standard_normal((12, d)).astype(np.float32)
    ar = np.stack([_rand_range(rng) for _ in range(12)])
    for ef in (32, _pow2(n0 + 40)):
        want = ref.search(qv, ar, k=k, ef=ef, plan=plan)
        got = port.search(qv, ar, k=k, ef=ef, plan=plan)
        _same_ids(got, want)
        for s in ("delta_size", "tombstones", "version"):
            assert got.stats[s] == want.stats[s], s
    assert ref.compact(wait=True) and port.compact(wait=True)
    fa, ma = io.index_state(port)
    fb, mb = jio.index_state(ref)
    for key in fb:                          # the same rebuilt base
        assert np.array_equal(fa[key], np.asarray(fb[key])), key
    assert ma["streaming"]["next_id"] == mb["streaming"]["next_id"]
    for ef in (32, 256):
        want = ref.search(qv, ar, k=k, ef=ef, plan=plan)
        got = port.search(qv, ar, k=k, ef=ef, plan=plan)
        _same_ids(got, want)
    ref.close()
    port.close()


@pytest.mark.parametrize("m", [0, 1, 70, 129])
def test_delta_scan_equals_the_reference(m):
    """The delta segment's range_scan at bucket = its pow2 capacity, pad
    tail masked, against the reference's (its Pallas kernel in interpret
    mode)."""
    rng = np.random.default_rng(m)
    d, k = 12, 5
    v = rng.standard_normal((m, d)).astype(np.float32)
    a = np.sort(rng.random(m).astype(np.float32))
    ids = (np.arange(m) * 3 + 1000).astype(np.int32)
    got_view, want_view = DeltaView(v, a, ids, "cpu"), JDelta(v, a, ids)
    qv = rng.standard_normal((5, d)).astype(np.float32)
    ar = np.stack([_rand_range(rng) for _ in range(4)]
                  + [(np.float32(2.0), np.float32(3.0))])
    got, want = got_view.search(qv, ar, k), want_view.search(qv, ar, k)
    if m == 0:
        assert got is None and want is None
        return
    assert np.array_equal(got[0], want[0])
    assert np.allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert got_view._device()[2] == max(128, _pow2(m))   # capacity
    assert (got[0][-1] == -1).all()         # a range past every row


def test_seeded_interleaved_sweep():
    """Randomized interleaved inserts, deletes, compactions and queries
    against a brute-force f64 oracle over the live set: every batch
    returns live in-range ids only, and the exact top-k wherever the k/k+1
    gap exceeds f32 noise."""
    rng = np.random.default_rng(20260808)
    n0, d, k = 160, 10, 5
    vecs = rng.standard_normal((n0, d)).astype(np.float32)
    attrs = rng.random(n0).astype(np.float32)
    s = StreamingRFANN(vecs, attrs, max_delta=64, device="cpu", **_BUILD)
    store = {i: (vecs[i].astype(np.float64), float(attrs[i]))
             for i in range(n0)}
    dead = set()
    plans = ["scan", "auto", "graph"]
    n_q = 0
    for _ in range(260):
        r = rng.random()
        if r < 0.40:
            v = rng.standard_normal(d).astype(np.float32)
            a = float(rng.random())
            store[s.insert(v, a)] = (v.astype(np.float64), a)
        elif r < 0.62 and len(store) > 16:
            victim = int(rng.choice(sorted(store)))
            s.delete(victim)
            del store[victim]
            dead.add(victim)
        elif r < 0.67:
            s.compact(wait=True)
        else:
            q = rng.standard_normal(d).astype(np.float32)
            a, b = _rand_range(rng)
            ef = _pow2(len(s._view.base_ids) + s._view.delta.count)
            res = s.search(q[None], np.asarray([[a, b]]), k=k, ef=ef,
                           plan=plans[n_q % 3])
            n_q += 1
            got = [int(i) for i in res.ids[0] if i >= 0]
            cand = sorted(i for i, (_, at) in store.items() if a <= at <= b)
            dd = np.asarray([((store[i][0] - q) ** 2).sum() for i in cand])
            o = np.argsort(dd, kind="stable")
            assert len(got) == min(k, len(cand))
            assert not set(got) & dead and set(got) <= set(cand)
            if cand:
                dk = dd[o][min(k, len(cand)) - 1]
                eps = 1e-3 * (1.0 + dk)
                if len(cand) <= k or dd[o][k] - dk > 2 * eps:
                    assert set(got) == {cand[j] for j in o[:k]}
    assert n_q >= 50 and s.compactions >= 1
    assert set(s.live_items()[2].tolist()) == set(store)
    s.close()


def test_tombstones_survive_racing_compaction_reconcile():
    """Mutations landing during a rebuild are reconciled at the swap:
    deletes win, inserts stay as the residual delta."""
    rng = np.random.default_rng(5)
    n0, d = 160, 8
    vecs = rng.standard_normal((n0, d)).astype(np.float32)
    s = StreamingRFANN(vecs, rng.random(n0).astype(np.float32),
                       max_delta=10**9, device="cpu", **_BUILD)
    for _ in range(24):
        s.insert(rng.standard_normal(d).astype(np.float32),
                 float(rng.random()))
    v0 = s._view
    post_ins = [s.insert(rng.standard_normal(d).astype(np.float32),
                         float(rng.random())) for _ in range(6)]
    post_del = [int(x) for x in rng.choice(sorted(s._id_loc), 6,
                                           replace=False)]
    for x in post_del:
        s.delete(x)
    s._compacting.set()
    s._compact_run(v0)
    li = set(s.live_items()[2].tolist())
    assert s.compactions == 1
    assert not li & set(post_del) and set(post_ins) <= li
    s.close()


def test_queries_racing_compaction_through_engine():
    """Query threads racing mutations and compactions through the port's
    engine with a cache: a deleted id never comes back once its delete
    returned, and the counters total exactly."""
    rng = np.random.default_rng(3)
    n0, d, k = 256, 8, 8
    s = StreamingRFANN(rng.standard_normal((n0, d)).astype(np.float32),
                       rng.random(n0).astype(np.float32), max_delta=10**9,
                       device="cpu", **_BUILD)
    eng = RFANNEngine(s, k=k, ef=64, plan="scan", max_wait_ms=0.5,
                      cache_bytes=1 << 20)
    n_threads, n_compactions, per = 3, 2, 20
    deleted, lock, errors = set(), threading.Lock(), []

    def hammer(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(per):
                q = r.standard_normal(d).astype(np.float32)
                a, b = np.sort(r.random(2).astype(np.float32))
                with lock:
                    dead_before = set(deleted)
                ids = eng.submit(q, (a, b)).result(timeout=60).ids
                bad = {int(i) for i in ids if i >= 0} & dead_before
                if bad:
                    errors.append(f"tombstoned ids served: {bad}")
        except Exception as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    try:
        for _ in range(n_compactions):
            for _ in range(10):
                eng.insert(rng.standard_normal(d).astype(np.float32),
                           float(rng.random()))
            for _ in range(5):
                victim = int(rng.choice([i for i in list(eng.index._id_loc)
                                         if i not in deleted]))
                with lock:
                    eng.delete(victim)
                    deleted.add(victim)
            assert s.compact(wait=True)
    finally:
        for t in threads:
            t.join(timeout=120)
        eng.close()
        s.close()
    assert not errors, errors
    snap = eng.metrics()
    assert snap["counters"]["stream_compactions_total"] == n_compactions
    assert snap["counters"]["stream_inserts_total"] == 10 * n_compactions
    assert snap["counters"]["stream_deletes_total"] == 5 * n_compactions
    assert snap["counters"]["engine_requests_total"] == n_threads * per
    assert not set(s.live_items()[2].tolist()) & deleted


def test_repeat_query_sees_delete_immediately():
    rng = np.random.default_rng(4)
    n0, d, k = 192, 8, 5
    s = StreamingRFANN(rng.standard_normal((n0, d)).astype(np.float32),
                       rng.random(n0).astype(np.float32), m=8,
                       max_delta=10**9, device="cpu")
    eng = RFANNEngine(s, k=k, ef=64, plan="scan", max_wait_ms=0.5,
                      cache_bytes=1 << 20)
    try:
        q = rng.standard_normal(d).astype(np.float32)
        ids0 = eng.submit(q, (0.0, 1.0)).result(timeout=60).ids
        victim = int(ids0[0])
        eng.submit(q, (0.0, 1.0)).result(timeout=60)      # now cached
        eng.delete(victim)
        ids1 = eng.submit(q, (0.0, 1.0)).result(timeout=60).ids
        assert victim not in {int(i) for i in ids1}
        assert s.compact(wait=True)
        ids2 = eng.submit(q, (0.0, 1.0)).result(timeout=60).ids
        assert {int(i) for i in ids2 if i >= 0} == {int(i) for i in ids1
                                                    if i >= 0}
    finally:
        eng.close()
        s.close()


def test_use_kernel_resolves_by_device():
    """No ``use_kernel`` means the plain versions on a CPU index (the
    cache keys carry the resolved bool, as the reference's do)."""
    from repro_torch.device import resolve_use_kernel
    assert resolve_use_kernel(None, "cpu") is False
    assert resolve_use_kernel(None, torch.device("cuda")) is True
    assert resolve_use_kernel(True, "cpu") is True
    rng = np.random.default_rng(1)
    s = StreamingRFANN(rng.standard_normal((64, 4)).astype(np.float32),
                       rng.random(64).astype(np.float32), m=8,
                       device="cpu")
    from repro_torch.search import SearchCache
    cache = SearchCache()
    s.install_cache(cache)
    s.search(rng.standard_normal((2, 4)).astype(np.float32),
             np.asarray([[0.0, 1.0]] * 2, np.float32), k=3, plan="graph")
    assert {key[7] for key in cache._d} == {False}
    s.close()

"""The port's metrics registry, exporters, profiler spans and result cache
against the reference's (``repro.obs``, ``repro.search.cache``), and the
substrate's cache and metrics hooks: the same request stream through both
substrates gives the same ids, cache keys, hit / miss / dedup counts and
metric names, and equal registries print byte-equal Prometheus text."""
import threading

import numpy as np
import pytest
import torch

from repro.core.rfann import RNSGIndex as JIndex
from repro.data.ann import make_attrs, make_vectors, selectivity_ranges
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import format_stats_line as j_stats_line
from repro.obs import to_prometheus as j_prometheus
from repro.search import SearchCache as JCache
from repro.search.cache import query_key as j_query_key
from repro_torch.core.construction import graph_from_arrays
from repro_torch.core.rfann import RNSGIndex
from repro_torch.obs import (CORE_FAMILIES, MetricsRegistry, annotate,
                             device_trace, format_stats_line,
                             parse_prometheus, to_prometheus)
from repro_torch.search import SearchCache, SearchRequest, query_key
from repro_torch.search.cache import CacheEntry, hash_query

N, D = 256, 16
FIELDS = ("vecs", "attrs", "nbrs", "order", "centroid", "dist_c", "rmq")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small torch ops, cores shared by workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair():
    """The reference's index and the port's over the same graph."""
    vecs, attrs = make_vectors(N, D, seed=0), make_attrs(N, seed=0)
    ref = JIndex.build(vecs, attrs, m=16, ef_spatial=16, ef_attribute=24)
    port = RNSGIndex(graph_from_arrays(
        {f: np.asarray(getattr(ref.g, f)) for f in FIELDS}, "cpu"))
    return ref, port, attrs


@pytest.fixture(scope="module")
def pair():
    return _pair()


# ------------------------------------------------------------------ metrics
def _fill(reg):
    """One fixed sequence of metric operations."""
    rng = np.random.default_rng(5)
    reg.counter("queries_total", "queries").inc(17)
    reg.counter("engine_requests_total", "requests").inc(3)
    reg.gauge("engine_queue_depth", "depth").set(4.5)
    reg.gauge("stream_delta_size").add(2)
    h = reg.histogram("engine_e2e_ms", "latency")
    h.observe_many(rng.lognormal(0.5, 1.0, 300))
    h.observe(0.0)
    h.observe(1e9)                      # overflow bucket
    reg.histogram("engine_batch_size", lo=1.0, hi=8192.0,
                  growth=1.25).observe_many([1, 7, 64, 64])
    reg.register_producer("engine", lambda: dict(
        served=20, batches=2, mean_batch=10.0, p50_ms=1.25, scan_frac=0.5,
        cache_hit_frac=0.25, nested=dict(a=1, b=True), text="dropped",
        bad=float("nan")))
    reg.register_producer("dead", lambda: 1 / 0)
    return reg


def test_prometheus_text_byte_equal():
    text = to_prometheus(_fill(MetricsRegistry()))
    assert text == j_prometheus(_fill(JRegistry()))
    samples = parse_prometheus(text)
    assert samples[("rnsg_queries_total", "")] == 17
    assert samples[("rnsg_engine_e2e_ms_count", "")] == 302
    assert samples[("rnsg_engine_e2e_ms_bucket", '{le="+Inf"}')] == 302
    assert ("rnsg_engine_nested_b", "") in samples
    assert not any(n.startswith("rnsg_dead") for n, _ in samples)


def test_snapshot_percentiles_and_stats_line_equal():
    snap, want = _fill(MetricsRegistry()).snapshot(), _fill(
        JRegistry()).snapshot()
    assert snap == want
    assert format_stats_line(snap) == j_stats_line(want)
    h = snap["histograms"]["engine_e2e_ms"]
    assert 0 < h["p50"] <= h["p90"] <= h["p99"] <= h["max"]


def test_registry_type_conflict_and_threads():
    reg = MetricsRegistry()
    c = reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")

    def hammer():
        for _ in range(2000):
            c.inc()
            reg.histogram("h").observe(1.0)

    ts = [threading.Thread(target=hammer) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value == 8000 and reg.histogram("h").count == 8000


# ----------------------------------------------------------------- profiler
def test_annotate_spans_reach_the_trace(tmp_path):
    """``annotate`` marks host regions under their names in a
    ``device_trace`` session, which writes a Chrome trace."""
    with device_trace(str(tmp_path)) as prof:
        with annotate("rnsg.scan_dispatch"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "rnsg.scan_dispatch" in names
    assert (tmp_path / "trace.json").stat().st_size > 0
    with annotate("outside a session"):    # a no-op without a profiler
        pass


@pytest.mark.parametrize("plan", ["graph", "auto", "scan", "beam"])
def test_dispatch_sites_carry_the_reference_span_names(pair, plan):
    _, port, attrs = pair
    qv = make_vectors(6, D, seed=7)
    rg = selectivity_ranges(attrs, 6, 0.05, seed=3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        port.search(qv, rg, k=5, ef=32, plan=plan)
    names = {e.key for e in prof.key_averages()}
    want = {"graph": {"rnsg.graph_beam_dispatch"},
            "scan": {"rnsg.scan_dispatch"},
            "beam": {"rnsg.beam_dispatch"}}.get(plan, set())
    assert want <= names
    if plan == "auto":
        assert names & {"rnsg.scan_dispatch", "rnsg.beam_dispatch"}


# -------------------------------------------------------------------- cache
def test_query_key_and_hash_equal():
    rng = np.random.default_rng(2)
    q = rng.standard_normal(D).astype(np.float32)
    assert hash_query(q) == j_query_key(q, 0, 0, 1, 1, "graph")[1]
    for kw in (dict(), dict(ns="base", beam_width=4, precision="int8"),
               dict(use_kernel=True, ns=3)):
        assert (query_key(q, 3, 90, 10, 64, "auto", **kw)
                == j_query_key(q, 3, 90, 10, 64, "auto", **kw))


def test_cache_eviction_epochs_and_segments_as_the_reference():
    """One sequence of stores, lookups and invalidations leaves both caches
    with the same entries, bytes and counters."""
    k = 5
    caches = (SearchCache(max_bytes=3 * 400), JCache(max_bytes=3 * 400))
    q = np.arange(4, dtype=np.float32)
    for c in caches:
        e = lambda: CacheEntry(np.zeros(k, np.int32),  # noqa: E731
                               np.zeros(k, np.float32),
                               {"hops": np.int32(1), "strategy": np.int8(0)})
        for i in range(6):
            c.store(query_key(q + i, 0, 10, k, 64, "auto", ns=i % 2), e())
        c.lookup(query_key(q + 5, 0, 10, k, 64, "auto", ns=1))
        c.lookup(query_key(q + 0, 0, 10, k, 64, "auto", ns=0))
        ep = c.epoch_for(1)
        c.invalidate_segment(1)
        c.store(query_key(q + 9, 0, 10, k, 64, "auto", ns=1), e(), epoch=ep)
        c.store(query_key(q + 8, 0, 10, k, 64, "auto", ns=0), e())
    got, want = caches
    assert got.snapshot() == want.snapshot()
    assert list(got._d) == list(want._d)


def _stream(attrs, rounds=3, per=8, seed=7):
    """Request batches with intra-batch duplicates and repeats of earlier
    batches."""
    rng = np.random.default_rng(seed)
    pool_q = make_vectors(2 * per, D, seed=seed)
    pool_r = selectivity_ranges(attrs, 2 * per, 0.1, seed=seed + 1)
    out = []
    for _ in range(rounds):
        pick = rng.integers(0, 2 * per, per)
        out.append((pool_q[pick], pool_r[pick]))
    return out


@pytest.mark.parametrize("plan,ef", [("graph", 32), ("auto", N),
                                     ("scan", 32)])
def test_substrate_cache_and_metrics_equal_the_reference(plan, ef):
    """The same request stream through both substrates, each with a cache
    and a registry installed: equal ids and dists per batch, equal cache
    keys and hit / miss / dedup counts, equal metric names and counters."""
    ref, port, attrs = _pair()
    caches, regs = (SearchCache(), JCache()), (MetricsRegistry(),
                                               JRegistry())
    for ix, c, r in zip((port, ref), caches, regs):
        ix.install_cache(c)
        ix.install_metrics(r)
    for qv, rg in _stream(attrs):
        got = port.search(qv, rg, k=5, ef=ef, plan=plan)
        want = ref.search(qv, rg, k=5, ef=ef, plan=plan)
        assert np.array_equal(got.ids, want.ids)
        assert np.allclose(got.dists, want.dists, rtol=1e-5, atol=1e-4)
        for s in ("cache_hits", "batch_dedup"):
            assert got.stats.get(s) == want.stats.get(s), s
    c_got, c_want = caches
    assert list(c_got._d) == list(c_want._d)
    for s in ("hits", "misses", "dedup_hits", "entries", "bytes"):
        assert c_got.snapshot()[s] == c_want.snapshot()[s], s
    assert c_got.hits > 0 and c_got.dedup_hits > 0
    s_got, s_want = regs[0].snapshot(), regs[1].snapshot()
    for sec in ("counters", "gauges", "histograms"):
        assert sorted(s_got[sec]) == sorted(s_want[sec]), sec
    assert s_got["counters"] == s_want["counters"]


def test_fully_hit_batch_does_no_device_work(pair, monkeypatch):
    _, port, attrs = pair
    port.install_cache(SearchCache())
    try:
        qv = make_vectors(4, D, seed=3)
        rg = selectivity_ranges(attrs, 4, 0.2, seed=4)
        first = port.search(qv, rg, k=5, ef=32, plan="auto")
        import repro_torch.search.substrate as sub
        monkeypatch.setattr(sub, "beam_search_batch", None)
        monkeypatch.setattr(sub, "range_scan", None)
        again = port.search(qv, rg, k=5, ef=32, plan="auto")
        assert again.stats["cache_hits"] == 4
        assert np.array_equal(first.ids, again.ids)
    finally:
        port.install_cache(None)


def test_invalidate_fences_in_flight_stores(pair):
    _, port, attrs = pair
    cache = SearchCache()
    port.install_cache(cache)
    try:
        qv = make_vectors(4, D, seed=7)
        rg = selectivity_ranges(attrs, 4, 0.2, seed=11)
        lo, hi = port.rank_range(rg)
        p = port.substrate.dispatch(SearchRequest(
            queries=qv, lo=lo, hi=hi, k=5, ef=32, strategy="auto"))
        cache.invalidate()
        assert p.result().ids.shape == (4, 5)
        assert len(cache) == 0
    finally:
        port.install_cache(None)


@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_install_quantized_bumps_the_segment_epoch(precision):
    """A rebuilt quantized corpus leaves no servable rows behind, as in the
    reference (and ``preload_quantized`` does the same)."""
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((160, 8)).astype(np.float32)
    attrs = rng.random(160).astype(np.float32)
    idx = RNSGIndex.build(vecs, attrs, m=8, device="cpu")
    cache = SearchCache(max_bytes=1 << 20)
    idx.install_cache(cache)
    qv = rng.standard_normal((2, 8)).astype(np.float32)
    ar = np.asarray([[0.0, 1.0]] * 2, np.float32)
    idx.search(qv, ar, k=5, plan="scan", precision=precision)
    idx.search(qv, ar, k=5, plan="scan", precision=precision)
    assert cache.hits == 2 and len(cache) == 2
    idx.install_quantized(precision)
    assert len(cache) == 0
    assert cache.epoch_for(idx.substrate.cache_ns)[1] == 1
    slot = idx.substrate._quant[precision]
    idx.search(qv, ar, k=5, plan="scan", precision=precision)
    idx.substrate.preload_quantized(precision, slot["data"].float(),
                                    slot["scale"])
    assert len(cache) == 0
    assert cache.epoch_for(idx.substrate.cache_ns)[1] == 2


def test_core_families_named_by_an_engine_registry(pair):
    from repro_torch.serving.engine import RFANNEngine
    _, port, _ = pair
    eng = RFANNEngine(port, k=5, ef=32, max_wait_ms=1.0)
    try:
        eng.submit(make_vectors(1, D, seed=1)[0], (0.2, 0.6)).result(60)
    finally:
        eng.close()
        port.install_metrics(None)
    names = {n for n, _ in parse_prometheus(to_prometheus(eng.registry))}
    for fam in CORE_FAMILIES:
        assert any(n == fam or n.startswith(fam + "_") for n in names), fam

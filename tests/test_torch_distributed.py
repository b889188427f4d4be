"""The port's multi-device serving path (``serving/distributed.py``,
``MeshSubstrate``, ``parallel/sharding.py``) on meshes of CPU shards,
against the reference's ``DistributedRFANN``.

* the local path (``mesh=None``) returns the reference's ids, and its
  distances within rtol 1e-5 / atol 1e-4 (``test_torch_search.py``'s
  tolerance), at S = 4 and 8, for every plan × beam width × precision,
  with and without a tombstone mask;
* the mesh path equals the local path (the reference holds its mesh to its
  local path), and at S = 1 the reference's mesh on a 1-device JAX mesh;
  ``plan_strategies`` equals the reference's;
* async dispatch equals the sequential loop; the 8-shard delta + tombstone
  parity; the ``"mesh"`` cache namespace; the spans and metric names of
  the ``dist`` and ``mesh`` paths; the empty batch.

The int8 / bf16 cases of the local path's matrix are in
``test_torch_distributed_quantized.py``."""
import numpy as np
import pytest
import torch

from _torch_dist_case import (D, K, KW, PER, built, case_data, same,
                              check_local_path)
from repro.obs import MetricsRegistry as JMetrics
from repro.obs import QueryTrace as JTrace
from repro.search import MeshSubstrate as JMesh
from repro.search import SearchCache as JCache
from repro_torch.data.ann import make_attrs, make_vectors
from repro_torch.obs import MetricsRegistry, QueryTrace
from repro_torch.parallel.sharding import (all_gather, make_mesh,
                                           shard_map)
from repro_torch.search import MeshSubstrate, SearchCache, merge_topk
from repro_torch.serving.distributed import DistributedRFANN

REQUIRED_SPANS = {"resolve", "plan", "dispatch", "stitch"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the lockstep loops run many small torch ops,
    and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("use_live", [False, True])
@pytest.mark.parametrize("bw", [1, 4])
@pytest.mark.parametrize("plan", ["graph", "auto", "scan", "beam"])
@pytest.mark.parametrize("shards", [4, 8])
def test_local_path_matches_reference(shards, plan, bw, use_live):
    check_local_path(shards, plan, bw, "f32", use_live)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("bw", [1, 4])
@pytest.mark.parametrize("plan", ["graph", "auto", "scan", "beam"])
def test_mesh_matches_local(plan, bw, precision):
    """8 CPU shards: the mesh path's merged top-k is the local path's."""
    _, _, qv, rg, _ = case_data(PER * 8)
    kw = dict(k=K, ef=48, plan=plan, beam_width=bw, precision=precision)
    same(built("mesh", 8).search(qv, rg, **kw),
          built("local", 8).search(qv, rg, **kw))


def test_mesh_int8_scale_is_joint():
    """The mesh scales its int8 corpus over all shards jointly (each local
    shard over its own rows, as in the reference); given the mesh's copy,
    the local shards return the mesh's answers."""
    vecs, attrs, qv, rg, _ = case_data(PER * 4)
    mesh = built("mesh", 4)
    local = DistributedRFANN(vecs, attrs, n_shards=4, device="cpu", **KW)
    slot = mesh.mesh_substrate._quant_for("int8")
    assert all(torch.equal(s, slot["scale"][0]) for s in slot["scale"])
    for s, sub in enumerate(local.substrates):
        sub.preload_quantized("int8", slot["data"][s], slot["scale"][s])
    for plan in ("graph", "auto"):
        kw = dict(k=K, ef=48, plan=plan, precision="int8")
        same(mesh.search(qv, rg, **kw), local.search(qv, rg, **kw))


@pytest.mark.parametrize("mode", ["auto", "scan", "beam"])
@pytest.mark.parametrize("bw", [1, 4])
def test_plan_strategies_matches_reference(mode, bw):
    ref, port = built("ref", 8), built("mesh", 8)
    # fresh substrates: both planners at their prior
    jms = JMesh(None, "data", ref.vecs, ref.nbrs, ref.rmq, ref.dist_c,
                ref.order, ref.rank0)
    ms = MeshSubstrate(port.mesh, port.vecs, port.nbrs, port.rmq,
                       port.dist_c, port.order)
    _, _, _, rg, _ = case_data(PER * 8)
    lo, hi = ref.rank_range(rg)
    for prec in ("f32", "int8"):
        kw = dict(k=K, ef=48, mode=mode, beam_width=bw, precision=prec)
        want = jms.plan_strategies(lo, hi, **kw)
        got = ms.plan_strategies(lo, hi, **kw)
        assert np.array_equal(got[0], want[0]) and got[0].dtype == np.int8
        assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("plan,bw,precision,use_live", [
    ("graph", 1, "f32", False), ("graph", 4, "bf16", False),
    ("auto", 1, "f32", False), ("auto", 4, "int8", False),
    ("auto", 1, "f32", True), ("scan", 1, "int8", False),
    ("beam", 1, "f32", True)])
def test_one_shard_mesh_matches_reference_mesh(plan, bw, precision,
                                               use_live):
    """S = 1: the port's mesh against the reference's on a 1-device JAX
    mesh, in process."""
    _, _, qv, rg, live = case_data(PER)
    kw = dict(k=K, ef=48, plan=plan, beam_width=bw, precision=precision,
              live=live if use_live else None)
    same(built("mesh", 1).search(qv, rg, **kw),
          built("ref_mesh", 1).search(qv, rg, **kw))


@pytest.mark.parametrize("plan", ["graph", "auto", "scan", "beam"])
@pytest.mark.parametrize("shards", [4, 8])
def test_async_matches_sequential(shards, plan):
    """Every shard enqueued before any result is read back: the merged
    top-k is the sequential loop's, bit for bit."""
    _, _, qv, rg, _ = case_data(PER * shards)
    dist = built("local", shards)
    out = {}
    for mode in (False, True):
        dist.async_dispatch = mode
        out[mode] = dist.search(qv, rg, k=K, ef=48, plan=plan)
    dist.async_dispatch = True
    assert np.array_equal(out[False][0], out[True][0])
    assert np.array_equal(out[False][1], out[True][1])


def test_async_cache_repeat_8_shards():
    _, _, qv, rg, _ = case_data(PER * 8)
    dist = built("local", 8)
    cache = SearchCache(8 << 20)
    dist.install_cache(cache)
    try:
        i1, d1 = dist.search(qv, rg, k=K, ef=48, plan="auto")
        i2, d2 = dist.search(qv, rg, k=K, ef=48, plan="auto")
        assert np.array_equal(i1, i2) and np.array_equal(d1, d2)
        assert cache.hits == 8 * len(rg), cache.snapshot()
    finally:
        dist.install_cache(None)


def test_delta_tombstone_parity_8_shards():
    """A rank-space tombstone mask through ``live=`` gives the same merged
    top-k on the mesh and local paths, and merging either with one
    brute-force delta segment through ``merge_topk`` stays the same, with
    no tombstoned id surfacing."""
    from repro_torch.streaming import DeltaView
    vecs, attrs, qv, rg, live = case_data(PER * 8)
    dv = make_vectors(64, D, seed=9)
    da = make_attrs(64, seed=9)
    o = np.argsort(da, kind="stable")
    delta = DeltaView(dv[o], da[o],
                      np.arange(2048, 2048 + 64, dtype=np.int32)[o],
                      device="cpu")
    order = np.argsort(attrs, kind="stable")
    dead = set(order[~live].tolist())
    for plan in ("graph", "auto"):
        ia, da_ = built("local", 8).search(qv, rg, k=K, ef=64, plan=plan,
                                            live=live)
        ib, db = built("mesh", 8).search(qv, rg, k=K, ef=64, plan=plan,
                                          live=live)
        assert np.array_equal(ia, ib), plan
        di, dd = delta.search(qv, rg, K)
        merged = []
        for ids, ds in ((ia, da_), (ib, db)):
            mi, _ = merge_topk(
                torch.as_tensor(np.stack([ids.astype(np.int32), di])),
                torch.as_tensor(np.stack([np.where(ids >= 0, ds, np.inf),
                                          dd])), K)
            merged.append(mi.numpy())
        assert np.array_equal(merged[0], merged[1]), plan
        got = set(int(x) for x in merged[0].ravel() if x >= 0)
        assert not (got & dead), (plan, got & dead)


def test_mesh_cache_namespace_keys_and_epoch():
    """The mesh path caches under the ``"mesh"`` namespace with the
    reference's keys; hits are bit-identical; ``install_quantized`` bumps
    the mesh epoch and empties the segment."""
    _, _, qv, rg, _ = case_data(PER)
    caches = {}
    for name, cls in (("mesh", SearchCache), ("ref_mesh", JCache)):
        dist = built(name, 1)
        cache = caches[name] = cls(max_bytes=1 << 20)
        dist.install_cache(cache)
        try:
            r1 = dist.search(qv, rg, k=K, ef=48, plan="graph",
                             precision="int8")
            assert len(cache) == len(qv)
            r2 = dist.search(qv, rg, k=K, ef=48, plan="graph",
                             precision="int8")
            assert cache.hits == len(qv)
            assert np.array_equal(r1[0], r2[0])
            assert np.array_equal(r1[1], r2[1])
        finally:
            dist.install_cache(None)
    assert list(caches["mesh"]._d) == list(caches["ref_mesh"]._d)
    assert all(key[0] == "mesh" for key in caches["mesh"]._d)
    dist = built("mesh", 1)
    cache = caches["mesh"]
    dist.install_cache(cache)
    try:
        before = cache.epoch_for("mesh")[1]
        dist.install_quantized("int8")
        assert len(cache) == 0
        assert cache.epoch_for("mesh")[1] > before
    finally:
        dist.install_cache(None)


@pytest.mark.parametrize("plan", ["graph", "auto", "scan", "beam"])
@pytest.mark.parametrize("path", ["dist", "mesh"])
def test_spans_and_metrics_match_reference(path, plan):
    """Every strategy on the ``dist`` (local, 4 shards) and ``mesh`` paths
    records the reference's spans, with the routing decision and cache
    outcome, and counts the reference's metrics; tracing never changes the
    ids."""
    shards = 4 if path == "dist" else 1
    names = ("local", "ref") if path == "dist" else ("mesh", "ref_mesh")
    _, _, qv, rg, _ = case_data(PER * shards)
    seen = {}
    for name, trace_cls, reg_cls in zip(names, (QueryTrace, JTrace),
                                        (MetricsRegistry, JMetrics)):
        dist = built(name, shards)
        reg = reg_cls()
        dist.install_metrics(reg)
        try:
            tr = trace_cls(request_id=f"{path}-{plan}")
            traced = dist.search(qv, rg, k=K, ef=32, plan=plan, trace=tr)
            plain = dist.search(qv, rg, k=K, ef=32, plan=plan)
        finally:
            dist.install_metrics(None)
        assert np.array_equal(np.asarray(traced[0]), np.asarray(plain[0]))
        assert REQUIRED_SPANS <= set(tr.names()), tr.names()
        plan_sp = tr.get("plan")
        assert plan_sp.attrs["strategy_mode"] == plan
        assert tr.get("dispatch").attrs["cache_enabled"] is False
        snap = reg.snapshot()
        attrs = tr.get("dispatch").attrs
        # the port's own key: one record per fused-beam launch (rows and
        # hops on the CPU), which the reference's span has not
        assert all(set(r) == {"rows", "hops"} for r in attrs.get("beam", []))
        seen[name] = (tr.names(), sorted(k for k in attrs if k != "beam"),
                      snap["counters"], sorted(snap["histograms"]))
    a, b = (seen[n] for n in names)
    assert a[0] == b[0] and a[1] == b[1]
    assert a[2] == b[2] and a[3] == b[3]
    if path == "mesh":
        assert a[2]["mesh_queries_total"] == 2 * len(qv)
        assert "mesh_dispatch_ms" in a[3]


@pytest.mark.parametrize("name", ["local", "mesh"])
def test_empty_batch(name):
    dist = built(name, 4 if name == "local" else 8)
    ids, dists = dist.search(np.zeros((0, D), np.float32),
                             np.zeros((0, 2), np.float32), k=K, plan="auto")
    assert ids.shape == (0, K) and dists.shape == (0, K)


def test_make_mesh_places_shards_round_robin():
    mesh = make_mesh(5, ["cpu", "meta"], axis="rows")
    assert [d.type for d in mesh.devices] == ["cpu", "meta"] * 2 + ["cpu"]
    assert mesh.axis == "rows" and mesh.size == 5
    assert [d.type for d in mesh.distinct] == ["cpu", "meta"]
    with pytest.raises(ValueError, match="n_shards=0"):
        make_mesh(0, ["cpu"])
    cpu = make_mesh(3, ["cpu"])
    parts = shard_map(lambda s, dev: torch.full((2,), s, device=dev), cpu)
    assert torch.equal(all_gather(parts, cpu),
                       torch.tensor([[0, 0], [1, 1], [2, 2]]))


def test_distributed_rejects_bad_shapes():
    vecs, attrs, *_ = case_data(PER * 2)
    with pytest.raises(ValueError, match="not a multiple"):
        DistributedRFANN(vecs[:-1], attrs[:-1], n_shards=2, device="cpu",
                         **KW)
    with pytest.raises(ValueError, match="mesh size"):
        DistributedRFANN(vecs, attrs, n_shards=2,
                         mesh=make_mesh(4, ["cpu"]), **KW)
    with pytest.raises(ValueError, match="needs mesh"):
        built("local", 4).mesh_substrate


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_entry_points_raise_without_a_card(no_card):
    """The mesh, the sharded build and both distributed paths default to
    the card."""
    from repro_torch.core.build_sharded import build_rnsg_sharded
    from repro_torch.core.rfann import RNSGIndex
    vecs, attrs, *_ = case_data(PER * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_rnsg_sharded(vecs, attrs, n_shards=2, **KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RNSGIndex.build_sharded(vecs, attrs, n_shards=2, **KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedRFANN(vecs, attrs, n_shards=2, **KW)

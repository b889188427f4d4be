"""The port's build against the reference's: data generators, exact KNN,
NNDescent, prune + pack, reverse edges, entry structures, and the npz
format across both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.construction import RNSGGraph as JGraph
from repro.core.construction import build_rnsg as jbuild
from repro.core.entry import rmq_query_jax
from repro.core.entry import rmq_query_np as jrmq_np
from repro.data import ann as jann
from repro.index.knn import exact_knn as jknn
from repro.index.knn import knn_recall as jknn_recall
from repro.index.knn import nndescent as jnndescent
from repro_torch.core.construction import (RNSGGraph, build_rnsg,
                                           graph_from_arrays)
from repro_torch.core.entry import rmq_query, rmq_query_np
from repro_torch.core.pruning import prune_all
from repro_torch.core.rfann import RNSGIndex
from repro_torch.data import ann as tann
from repro_torch.index.knn import exact_knn, knn_recall, nndescent

FIELDS = ("vecs", "attrs", "nbrs", "order", "centroid", "dist_c", "rmq")


def _graph_of(g):
    """The reference graph's fields as numpy."""
    return {f: np.asarray(getattr(g, f)) for f in FIELDS}


def test_generators_bit_identical():
    assert np.array_equal(tann.make_vectors(300, 12, seed=4),
                          jann.make_vectors(300, 12, seed=4))
    assert np.array_equal(tann.make_vectors(50, 3, seed=1, kind="uniform"),
                          jann.make_vectors(50, 3, seed=1, kind="uniform"))
    for kind in ("uniform", "zipf", "normal"):
        assert np.array_equal(tann.make_attrs(200, seed=2, kind=kind),
                              jann.make_attrs(200, seed=2, kind=kind))
    a = jann.make_attrs(500, seed=3)
    assert np.array_equal(tann.selectivity_ranges(a, 20, 0.1, seed=5),
                          jann.selectivity_ranges(a, 20, 0.1, seed=5))
    for got, want in zip(tann.mixed_workload(a, 37, seed=2),
                         jann.mixed_workload(a, 37, seed=2)):
        assert np.array_equal(got, want)


def _gap_aware_equal(ids_a, d_a, ids_b, d_b):
    """Rows of (ids_b, d_b) hold the id sets of the reference's rows
    (ids_a, d_a), except where an id swapped in sits within 2·eps·dist of
    the reference's k-th distance: a true near-tie at the k/k+1 boundary
    that float rounding may flip."""
    eps = np.finfo(np.float32).eps
    for r in range(len(ids_a)):
        sa, sb = set(ids_a[r].tolist()), set(ids_b[r].tolist())
        if sa == sb:
            continue
        kth = float(np.max(d_a[r][np.isfinite(d_a[r])]))
        for j, i in enumerate(ids_b[r].tolist()):
            if i not in sa:
                assert d_b[r, j] <= kth + 2 * eps * max(kth, 1.0), (r, i)


@pytest.mark.parametrize("n,d,k", [(700, 24, 16), (300, 8, 299)])
def test_exact_knn_matches_reference(n, d, k):
    """ids equal up to gap-aware near-ties; k >= n-1 masks pad rows the
    same way (-1, +inf)."""
    v = jann.make_vectors(n, d, seed=n)
    jd, ji = jknn(v, k)
    td, ti = exact_knn(torch.as_tensor(v), k)
    td, ti = td.numpy(), ti.numpy()
    assert np.array_equal(np.isfinite(td), np.isfinite(jd))
    assert np.array_equal(ti < 0, ji < 0)
    _gap_aware_equal(ji, jd, ti, td)
    fin = np.isfinite(jd)
    assert np.allclose(td[fin], jd[fin], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n,d,m,efs,efa", [(512, 16, 16, 16, 24),
                                           (1000, 8, 8, 8, 12),
                                           (5, 4, 4, 8, 3)])
def test_build_bit_equal_with_shared_knn(n, d, m, efs, efa):
    """Given the same KNN graph, prune + pack and the entry structures are
    bit-equal to the reference; the centroid is allclose."""
    v = jann.make_vectors(n, d, seed=1)
    a = jann.make_attrs(n, seed=1)
    order = np.argsort(a, kind="stable")
    k_eff = min(efs, n - 1)
    _, knn = jknn(v[order], k_eff)
    ref = _graph_of(jbuild(v, a, m=m, ef_spatial=efs, ef_attribute=efa,
                           knn_ids=knn))
    got = build_rnsg(v, a, m=m, ef_spatial=efs, ef_attribute=efa,
                     knn_ids=knn, device="cpu").arrays()
    for f in ("vecs", "attrs", "nbrs", "order", "dist_c", "rmq"):
        assert got[f].dtype == ref[f].dtype, f
        assert np.array_equal(got[f], ref[f]), f
    assert np.allclose(got["centroid"], ref["centroid"], rtol=1e-6, atol=1e-6)


def test_build_with_own_knn_matches_reference():
    """The whole build (the port's own exact KNN included) on a small
    corpus: no near-ties there, so the adjacency is bit-equal too."""
    v = jann.make_vectors(256, 16, seed=0)
    a = jann.make_attrs(256, seed=0)
    ref = _graph_of(jbuild(v, a, m=16, ef_spatial=16, ef_attribute=24))
    got = build_rnsg(v, a, m=16, ef_spatial=16, ef_attribute=24,
                     device="cpu").arrays()
    for f in ("nbrs", "order", "dist_c", "rmq"):
        assert np.array_equal(got[f], ref[f]), f


def test_prune_block_size_cannot_change_rows():
    v = jann.make_vectors(300, 8, seed=2)
    g = build_rnsg(v, jann.make_attrs(300, seed=2), m=8, ef_spatial=8,
                   ef_attribute=12, device="cpu")
    from repro_torch.core.construction import _gap_sorted_side
    _, knn = exact_knn(g.vecs, 8)
    cl = _gap_sorted_side(300, knn, 12, "l")
    cr = _gap_sorted_side(300, knn, 12, "r")
    assert np.array_equal(prune_all(g.vecs, cl, cr, 8, block=37),
                          g.nbrs.numpy())


def test_rmq_query_matches_reference():
    rng = np.random.default_rng(9)
    v = jann.make_vectors(1000, 8, seed=9)
    g = build_rnsg(v, jann.make_attrs(1000, seed=9), m=8, ef_spatial=8,
                   ef_attribute=8, device="cpu")
    lo = rng.integers(0, 1000, 400)
    hi = np.minimum(lo + rng.integers(0, 1000, 400), 999)
    hi[:5] = lo[:5]                                  # single points
    want = np.asarray(rmq_query_jax(jnp.asarray(g.rmq.numpy()),
                                    jnp.asarray(g.dist_c.numpy()),
                                    jnp.asarray(lo), jnp.asarray(hi)))
    got = rmq_query(g.rmq, g.dist_c, torch.as_tensor(lo), torch.as_tensor(hi))
    assert np.array_equal(got.numpy(), want)
    table, dc = g.rmq.numpy(), g.dist_c.numpy()
    host = [rmq_query_np(table, dc, int(a), int(b)) for a, b in zip(lo, hi)]
    assert host == [jrmq_np(table, dc, int(a), int(b)) for a, b in zip(lo, hi)]
    assert np.array_equal(rmq_query_np(table, dc, lo, hi), host)


def test_npz_cross_loads_both_ways(tmp_path):
    v = jann.make_vectors(200, 8, seed=3)
    a = jann.make_attrs(200, seed=3)
    ref = jbuild(v, a, m=8, ef_spatial=8, ef_attribute=12)
    ref.save(str(tmp_path / "ref"))
    port = RNSGGraph.load(str(tmp_path / "ref"), device="cpu")
    for f in FIELDS:
        assert np.array_equal(port.arrays()[f], np.asarray(getattr(ref, f)))
    assert port.meta == ref.meta
    assert port.build_seconds == pytest.approx(ref.build_seconds)
    port.save(str(tmp_path / "port.npz"))
    back = JGraph.load(str(tmp_path / "port.npz"))
    for f in FIELDS:
        got = np.asarray(getattr(back, f))
        assert got.dtype == np.asarray(getattr(ref, f)).dtype, f
        assert np.array_equal(got, np.asarray(getattr(ref, f))), f
    assert back.meta == ref.meta
    idx = RNSGIndex.load(str(tmp_path / "port.npz"), device="cpu")
    assert idx.stats()["edges"] == ref.n_edges


def test_graph_from_arrays_round_trips():
    v = jann.make_vectors(150, 6, seed=4)
    ref = jbuild(v, jann.make_attrs(150, seed=4), m=8, ef_spatial=8,
                 ef_attribute=8)
    arrays = dict(_graph_of(ref), meta=ref.meta,
                  build_seconds=ref.build_seconds)
    g = graph_from_arrays(arrays, "cpu")
    assert g.n == ref.n and g.m == ref.m and g.n_edges == ref.n_edges
    assert g.index_bytes == ref.index_bytes
    again = graph_from_arrays(dict(g.arrays(), meta=g.meta), "cpu")
    for f in FIELDS:
        assert np.array_equal(again.arrays()[f], arrays[f]), f


def test_nndescent_matches_reference():
    """Same seed, same initial lists: ids equal on >= 99 % of rows (the
    einsum sums in another order than XLA, so a near-tie may flip and
    change later neighbours-of-neighbours), and recall against the exact
    graph within 0.005 of the reference's."""
    v = jann.make_vectors(2048, 16, seed=5)
    _, ji = jnndescent(v, 16)
    td, ti = nndescent(torch.as_tensor(v), 16)
    assert ti.shape == (2048, 16) and td.shape == (2048, 16)
    ti = ti.numpy()
    assert (ti == ji).all(1).mean() >= 0.99
    _, exact = jknn(v, 16)
    assert abs(knn_recall(ti, exact) - jknn_recall(ji, exact)) <= 0.005
    assert knn_recall(ti, exact) == jknn_recall(ti, exact)


def test_nndescent_equal_on_an_integer_corpus():
    """Integer coordinates make every f32 sum exact, so the two packages
    see the same distances; ties (many, at integer distances) resolve the
    same way: ids and distances equal on every row."""
    v = np.random.default_rng(1).integers(-8, 9, (1500, 12))
    v = v.astype(np.float32)
    jd, ji = jnndescent(v, 10, iters=4, seed=3)
    td, ti = nndescent(torch.as_tensor(v), 10, iters=4, seed=3)
    assert np.array_equal(ti.numpy(), ji)
    assert np.array_equal(td.numpy(), jd)


def test_build_with_nndescent_matches_reference():
    v = np.random.default_rng(2).integers(-8, 9, (600, 8)).astype(np.float32)
    a = jann.make_attrs(600, seed=2)
    kw = dict(m=8, ef_spatial=8, ef_attribute=12, knn_method="nndescent",
              knn_iters=3, seed=4)
    ref = jbuild(v, a, **kw)
    got = build_rnsg(v, a, device="cpu", **kw)
    assert np.array_equal(got.arrays()["nbrs"], np.asarray(ref.nbrs))
    assert got.meta == ref.meta


@pytest.mark.parametrize("cap", [None, 9, 40])
def test_reverse_edges_bit_equal_with_shared_knn(cap):
    """``reverse_edges=True`` adds the reference's reverse edges: the
    default cap 1.25·m, one that saturates, one that does not."""
    v = jann.make_vectors(500, 12, seed=6)
    a = jann.make_attrs(500, seed=6)
    order = np.argsort(a, kind="stable")
    _, knn = jknn(v[order], 12)
    kw = dict(m=8, ef_spatial=12, ef_attribute=16, knn_ids=knn,
              reverse_edges=True, reverse_cap=cap)
    want = np.asarray(jbuild(v, a, **kw).nbrs)
    got = build_rnsg(v, a, device="cpu", **kw).arrays()["nbrs"]
    assert got.shape == want.shape == (500, cap or 10)
    assert np.array_equal(got, want)


def test_ground_truth_matches_reference():
    v = jann.make_vectors(600, 12, seed=5)
    a = jann.make_attrs(600, seed=5)
    qv = jann.make_vectors(30, 12, seed=6)
    rg, _ = jann.mixed_workload(a, 30, seed=1)
    ji, jd = jann.ground_truth(v, a, qv, rg, 10)
    ti, td = tann.ground_truth(v, a, qv, rg, 10, device="cpu")
    assert np.array_equal(ti < 0, np.asarray(ji) < 0)
    _gap_aware_equal(np.asarray(ji), np.asarray(jd), ti, td)
    assert tann.recall_at_k(ti, np.asarray(ji)) == pytest.approx(1.0)

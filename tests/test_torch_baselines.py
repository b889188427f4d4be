"""The port's baselines (``repro_torch.index.baselines``) against the
reference's (``repro.index.baselines``): the graph helpers on random
graphs, the MRNG and segment-tree builds (arrays equal), and the searches
of all four indexes over the reference's own built arrays
(``baseline_from_arrays``): ids, hops and ndist equal, distances allclose
(rtol 1e-5: the two packages sum a row's squares in another order)."""
import numpy as np
import pytest
import torch

import repro.index.baselines as R
import repro_torch.index.baselines as T
from repro.data import ann as jann
from repro.index.knn import exact_knn as jknn

N, D = 1024, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small torch ops, and with
    the test workers sharing the cores, more threads only add waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    v = jann.make_vectors(N, D, seed=3)
    a = jann.make_attrs(N, seed=3)
    qv = jann.make_vectors(64, D, seed=91)
    rg, _ = jann.mixed_workload(a, 60, seed=1)
    s = np.sort(a)
    rg = np.concatenate([rg, np.asarray([[s[5] + 1e-7, s[5] + 2e-7],
                                         [s[17], s[17]], [s[0], s[-1]],
                                         [s[3], s[40]]], np.float32)])
    return v, a, qv, rg


@pytest.fixture(scope="module")
def ref_mrng(corpus):
    v, a, _, _ = corpus
    return R.MRNGIndex(v, a, m=16, ef_spatial=32)


@pytest.fixture(scope="module")
def ref_segtree(corpus):
    v, a, _, _ = corpus
    return R.SegmentTreeIndex(v, a, m=16, ef_spatial=32)


def _arrays(ix, **kw):
    return dict(vecs=ix.vecs, attrs=ix.attrs, order=ix.order, nbrs=ix.nbrs,
                centroid=ix.centroid, dist_c=ix.dist_c, rmq=ix.rmq, **kw)


def _graph(rng, n, m, kind):
    nb = rng.integers(-1, n, (n, m)).astype(np.int32)
    if kind == "packed":          # ids first, then -1: the builders' layout
        nb = -np.sort(-nb, axis=1)
    elif kind == "dups":          # repeated ids within rows
        nb[:, 1::2] = nb[:, ::2][:, :nb[:, 1::2].shape[1]]
    return nb                     # "holes": a -1 followed by ids


@pytest.mark.parametrize("kind", ["packed", "holes", "dups"])
@pytest.mark.parametrize("n,m", [(40, 4), (200, 8), (7, 3)])
@pytest.mark.parametrize("extra", [0, 2, 12])
def test_add_reverse_edges_matches_reference(kind, n, m, extra):
    """cap = m saturates most rows, m + 12 leaves them unsaturated."""
    nb = _graph(np.random.default_rng(n * 31 + m + extra), n, m, kind)
    want = R.add_reverse_edges(nb, m + extra)
    got = T.add_reverse_edges(nb, m + extra, device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_connectivity_repair_matches_reference(seed):
    """Graphs of several components (some rows empty, some one-way links
    between components), repaired from different entries."""
    rng = np.random.default_rng(seed)
    n, m = 90, 4
    v = rng.standard_normal((n, 8)).astype(np.float32)
    comp = rng.integers(0, 2 + seed, n)
    nb = np.full((n, m), -1, np.int32)
    for i in range(n):
        same = np.flatnonzero(comp == comp[i])
        k = int(rng.integers(0, m + 1))
        nb[i, :k] = rng.choice(same, k)
    nb[rng.integers(0, n, 3), m - 1] = rng.integers(0, n, 3)
    for entry in (0, int(rng.integers(0, n))):
        assert np.array_equal(
            T.connectivity_repair(nb, v, entry, device="cpu"),
            R.connectivity_repair(nb, v, entry))


@pytest.mark.parametrize("m", [4, 16])
def test_mrng_prune_graph_bit_equal_given_knn(corpus, m):
    v = corpus[0][:512]
    _, knn = jknn(v, 24)
    got = T.mrng_prune_graph(torch.as_tensor(v), knn, m, block=100)
    assert np.array_equal(got, R.mrng_prune_graph(v, knn, m))


def test_mrng_build_arrays_equal_reference(corpus, ref_mrng):
    v, a, _, _ = corpus
    got = T.MRNGIndex(v, a, m=16, ef_spatial=32, device="cpu")
    for f in ("vecs", "attrs", "order", "nbrs", "dist_c", "rmq"):
        assert np.array_equal(getattr(got, f), getattr(ref_mrng, f)), f
    assert np.allclose(got.centroid, ref_mrng.centroid, atol=1e-6)
    assert got.index_bytes == ref_mrng.index_bytes


def _ref_block_knn(vecs, size, k):
    """The reference's per-level block KNN (``SegmentTreeIndex.__init__``),
    in numpy as it stands there."""
    n = len(vecs)
    out = np.full((n, k), -1, np.int32)
    for start in range(0, n, size):
        end = min(start + size, n)
        bn = end - start
        if bn <= 1:
            continue
        blk = vecs[start:end]
        d2 = np.sum(blk * blk, 1)[:, None] - 2 * blk @ blk.T \
            + np.sum(blk * blk, 1)[None, :]
        np.fill_diagonal(d2, np.inf)
        kk = min(k, bn - 1)
        idx = np.argpartition(d2, kth=kk - 1, axis=1)[:, :kk]
        o = np.argsort(np.take_along_axis(d2, idx, axis=1), axis=1)
        out[start:end, :kk] = np.take_along_axis(idx, o, axis=1) + start
    return out


@pytest.mark.parametrize("size", [2, 8, 64, 256, 1024])
@pytest.mark.parametrize("tile", [64, 4096])
def test_segment_knn_matches_reference(corpus, size, tile):
    """Both branches (blocks within one tile; blocks sliced into tiles)
    return the reference's neighbour lists, in order."""
    v = corpus[0][:1000]                          # a ragged last block
    k = min(32, size - 1)
    got = T.segment_knn(torch.as_tensor(v), size, k, tile=tile)
    assert np.array_equal(got, _ref_block_knn(v, size, k))


def test_segtree_build_arrays_equal_reference(corpus, ref_segtree,
                                              monkeypatch):
    v, a, _, _ = corpus
    monkeypatch.setattr(T, "KNN_TILE", 128)       # the sliced branch too
    widths, real = [], T.ops.l2dist
    monkeypatch.setattr(T.ops, "l2dist",
                        lambda q, x: widths.append(x.shape[0]) or real(q, x))
    got = T.SegmentTreeIndex(v, a, m=16, ef_spatial=32, device="cpu")
    assert max(widths) > 128 and min(widths) <= 128   # both branches ran
    assert got.levels == ref_segtree.levels
    for f in ("vecs", "attrs", "order", "nbrs", "dist_c", "rmq"):
        assert np.array_equal(getattr(got, f), getattr(ref_segtree, f)), f
    assert got.index_bytes == ref_segtree.index_bytes


def test_segtree_repairs_disconnected_blocks_as_the_reference(monkeypatch):
    """Far-apart clusters of 6, contiguous in attribute order: a block of
    several clusters has a disconnected MRNG graph (each node's 4 nearest
    lie in its own cluster), so the per-block repair runs, and the arrays
    still equal the reference's."""
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((40, 4)) * 100
    v = (np.repeat(centers, 6, 0)
         + rng.standard_normal((240, 4))).astype(np.float32)
    a = (np.repeat(np.arange(40), 6) + rng.random(240) * 0.5)
    a = a.astype(np.float32)
    repairs = []
    real = T.connectivity_repair
    monkeypatch.setattr(T, "connectivity_repair",
                        lambda *x, **kw: repairs.append(1) or real(*x, **kw))
    want = R.SegmentTreeIndex(v, a, m=4, ef_spatial=4)
    got = T.SegmentTreeIndex(v, a, m=4, ef_spatial=4, device="cpu")
    assert len(repairs) > 5
    assert np.array_equal(got.nbrs, want.nbrs)


def test_canonical_entries_match_reference(ref_segtree):
    rng = np.random.default_rng(4)
    lo = rng.integers(0, N, 400)
    hi = np.minimum(lo + rng.integers(-5, N, 400), N - 1)
    lo[:4], hi[:4] = (0, 0, 5, N - 1), (N - 1, 0, 4, N - 1)   # full, empty
    ix = T.baseline_from_arrays(
        "segtree", _arrays(ref_segtree, levels=ref_segtree.levels), "cpu")
    assert np.array_equal(ix._canonical_entries(lo, hi),
                          ref_segtree._canonical_entries(lo, hi))


def _same_search(want, got):
    (wi, wd, ws), (gi, gd, gs) = want, got
    assert np.array_equal(gi, wi)
    fin = np.isfinite(np.asarray(wd))
    assert np.array_equal(np.isfinite(gd), fin)
    assert np.allclose(np.asarray(gd)[fin], np.asarray(wd)[fin], rtol=1e-5)
    assert set(gs) == set(ws)
    for key in ws:
        assert np.array_equal(gs[key], np.asarray(ws[key])), key


@pytest.mark.parametrize("mode", ["infilter", "postfilter"])
@pytest.mark.parametrize("ef", [16, 64])
def test_mrng_search_matches_reference(corpus, ref_mrng, mode, ef):
    _, _, qv, rg = corpus
    ix = T.baseline_from_arrays("mrng", _arrays(ref_mrng, mode=mode), "cpu")
    ref_mrng.mode = mode
    _same_search(ref_mrng.search(qv, rg, k=10, ef=ef),
                 ix.search(qv, rg, k=10, ef=ef))


@pytest.mark.parametrize("ef", [16, 64])
def test_segtree_search_matches_reference(corpus, ref_segtree, ef):
    _, _, qv, rg = corpus
    ix = T.baseline_from_arrays(
        "segtree", _arrays(ref_segtree, levels=ref_segtree.levels), "cpu")
    want = ref_segtree.search(qv, rg, k=10, ef=ef)
    _same_search(want, ix.search(qv, rg, k=10, ef=ef))
    assert (want[2]["hops"] == 8 * ef + 64).any()  # an unfilled pool's cap


def test_brute_force_search_matches_reference(corpus):
    v, a, qv, rg = corpus
    ref = R.BruteForceIndex(v, a)
    ix = T.baseline_from_arrays(
        "brute", dict(vecs=ref.vecs, attrs=ref.attrs, order=ref.order), "cpu")
    wi, wd, _ = ref.search(qv, rg, k=10)
    gi, gd, st = ix.search(qv, rg, k=10)
    assert np.array_equal(gi, wi) and st == {}
    assert np.allclose(gd, wd, rtol=1e-5)
    assert ix.index_bytes == ref.index_bytes == 0
    own = T.BruteForceIndex(v, a, device="cpu")
    assert np.array_equal(own.search(qv, rg, k=10)[0], wi)


def test_index_bytes_from_arrays_equal_reference(ref_mrng, ref_segtree):
    assert T.baseline_from_arrays(
        "mrng", _arrays(ref_mrng), "cpu").index_bytes == ref_mrng.index_bytes
    assert T.baseline_from_arrays(
        "segtree", _arrays(ref_segtree), "cpu").index_bytes \
        == ref_segtree.index_bytes

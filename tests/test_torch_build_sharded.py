"""The port's sharded build (``core/build_sharded.py``) on meshes of CPU
shards: bit-identity to the port's ``build_rnsg`` at S ∈ {1, 2, 8} and to
the reference's build, the reference's own checks (a degenerate corpus, a
bad shard count, restore-then-query parity through the sharded directory
format), and the launcher's ``--build-shards``."""
import numpy as np
import pytest
import torch

from repro.core.build_sharded import build_rnsg_sharded as jsharded
from repro.core.construction import build_rnsg as jbuild
from repro_torch.core.build_sharded import build_rnsg_sharded
from repro_torch.core.construction import build_rnsg
from repro_torch.core.rfann import RNSGIndex
from repro_torch.data.ann import make_attrs, make_vectors
from repro_torch.parallel.sharding import make_mesh

FIELDS = ("vecs", "attrs", "nbrs", "order", "centroid", "dist_c", "rmq")
KW = dict(m=16, ef_spatial=16, ef_attribute=24)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n, d=24, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def _assert_graph_equal(a, b):
    for f in FIELDS:
        assert np.array_equal(a[f], b[f]), f


@pytest.fixture(scope="module", params=[1500, 2900])
def single(request):
    """(corpus, the port's single-device build) at an n that is not a
    multiple of 512·S for any S tested."""
    v, a = _corpus(request.param, seed=request.param)
    return v, a, build_rnsg(v, a, device="cpu", **KW).arrays()


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_sharded_build_bit_identical(single, shards):
    v, a, want = single
    g = build_rnsg_sharded(v, a, mesh=make_mesh(shards, ["cpu"]), **KW)
    _assert_graph_equal(g.arrays(), want)
    assert g.meta["shards"] == shards and g.meta["knn"] == "exact"
    assert g.device == torch.device("cpu")


def test_row_ranges_equal_the_whole_call():
    """The two row-range entry points the slabs use: ``exact_knn`` over
    [row0, row1) and ``prune_all`` from ``row0`` (on a block grid that the
    range crosses) return those rows of the whole call."""
    from repro_torch.core.construction import _gap_sorted_side
    from repro_torch.core.pruning import prune_all
    from repro_torch.index.knn import exact_knn
    v = torch.as_tensor(_corpus(1300, d=8, seed=3)[0])
    d_all, i_all = exact_knn(v, 8)
    d, i = exact_knn(v, 8, 512, 1300)
    assert torch.equal(i, i_all[512:]) and torch.equal(d, d_all[512:])
    with pytest.raises(ValueError, match="multiple"):
        exact_knn(v, 8, 100, 600)
    cl = _gap_sorted_side(1300, i_all, 12, "l")
    cr = _gap_sorted_side(1300, i_all, 12, "r")
    assert torch.equal(_gap_sorted_side(1300, i, 12, "l", 512), cl[512:])
    whole = prune_all(v, cl, cr, 8, block=300)
    part = prune_all(v, cl[512:1000], cr[512:1000], 8, block=300, row0=512)
    assert np.array_equal(part, whole[512:1000])


def test_sharded_build_matches_reference():
    """The port's sharded build against the reference's single-host build
    and its sharded build (one device, in process), each with its own exact
    KNN: a small corpus has no near-ties, so the adjacency is bit-equal."""
    v = make_vectors(256, 16, seed=0)
    a = make_attrs(256, seed=0)
    ref = jbuild(v, a, **KW)
    ref_sharded = jsharded(v, a, n_shards=1, **KW)
    for shards in (1, 8):
        got = build_rnsg_sharded(v, a, mesh=make_mesh(shards, ["cpu"]),
                                 **KW).arrays()
        for f in FIELDS:
            assert np.array_equal(got[f], np.asarray(getattr(ref, f))), f
            assert np.array_equal(got[f],
                                  np.asarray(getattr(ref_sharded, f))), f


def test_sharded_build_reverse_edges():
    v, a = _corpus(700, seed=3)
    want = build_rnsg(v, a, reverse_edges=True, device="cpu", **KW).arrays()
    got = build_rnsg_sharded(v, a, mesh=make_mesh(2, ["cpu"]),
                             reverse_edges=True, **KW).arrays()
    _assert_graph_equal(got, want)


def test_sharded_build_tiny_corpus_degenerate():
    # n=1 short-circuits to the single-device builder (k_eff < 1) but keeps
    # the shard annotation
    v, a = _corpus(1)
    g = build_rnsg_sharded(v, a, n_shards=1, device="cpu", m=8)
    assert g.nbrs.shape[0] == 1 and bool((g.nbrs < 1).all())
    assert g.meta["shards"] == 1


def test_sharded_build_rejects_bad_shard_count():
    v, a = _corpus(64)
    with pytest.raises(ValueError, match="!= mesh axis"):
        build_rnsg_sharded(v, a, n_shards=3, mesh=make_mesh(2, ["cpu"]))
    with pytest.raises(ValueError, match="n_shards=0"):
        build_rnsg_sharded(v, a, n_shards=0, device="cpu")


def test_sharded_build_restore_query_parity(tmp_path):
    """Build sharded -> save (sharded dir) -> load -> every strategy
    returns the same ids/dists as the never-persisted single-device index,
    and the reference loads the same directory to the same graph."""
    from repro.core.rfann import RNSGIndex as JIndex
    v, a = _corpus(900)
    ref = RNSGIndex.build(v, a, device="cpu", **KW)
    idx = RNSGIndex.build_sharded(v, a, mesh=make_mesh(2, ["cpu"]), **KW)
    idx.save(str(tmp_path / "dir"), shards=4)
    got = RNSGIndex.load(str(tmp_path / "dir"), device="cpu")
    _assert_graph_equal(ref.g.arrays(), got.g.arrays())
    jgot = JIndex.load(str(tmp_path / "dir"))
    _assert_graph_equal(ref.g.arrays(), {f: np.asarray(getattr(jgot.g, f))
                                         for f in FIELDS})

    rng = np.random.default_rng(5)
    q = rng.normal(size=(24, v.shape[1])).astype(np.float32)
    r = np.sort(rng.normal(size=(24, 2)).astype(np.float32), axis=1)
    for plan in ("graph", "scan", "auto", "beam"):
        want = ref.search(q, r, k=5, ef=32, plan=plan)
        have = got.search(q, r, k=5, ef=32, plan=plan)
        assert np.array_equal(want.ids, have.ids), plan
        assert np.allclose(want.dists, have.dists, equal_nan=True), plan


def test_launcher_build_shards(tmp_path):
    """``--build-shards 2`` through the launcher on the CPU: it serves, and
    the graph it built (persisted with ``--index-path``) is
    ``build_rnsg``'s."""
    from repro_torch.launch import serve
    rec = serve.main(["--mode", "rfann", "--device", "cpu", "--n", "1024",
                      "--dim", "16", "--requests", "48", "--build-shards",
                      "2", "--index-path", str(tmp_path / "idx")])
    assert rec["served"] == 48 and rec["restored"] is None
    assert rec["recall"] > 0.9
    want = build_rnsg(make_vectors(1024, 16, seed=0),
                      make_attrs(1024, seed=0), m=32, ef_spatial=32,
                      ef_attribute=48, device="cpu").arrays()
    got = RNSGIndex.load(str(tmp_path / "idx"), device="cpu").g.arrays()
    _assert_graph_equal(got, want)

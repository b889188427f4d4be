"""The port's exact RRNG/MRNG oracles (``repro_torch.core.exact``) and its
host Algorithm 1 (``repro_torch.core.pruning.rrng_prune_np``) against the
reference's, bit for bit on the property tests' point sets; then the
paper's theorem tests of ``tests/test_rnsg_properties.py`` held against the
port's own build (``build_rnsg(device="cpu")``, ``prune_all``,
``exact_knn``)."""
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

import repro.core.exact as R
import repro_torch.core.exact as T
from repro.core.pruning import rrng_prune_np as ref_prune_np
from repro_torch.core.construction import build_rnsg
from repro_torch.core.pruning import prune_all, rrng_prune_np
from repro_torch.index.knn import exact_knn


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small torch ops, and with
    the test workers sharing the cores, more threads only add waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32)


pointsets = st.builds(_points,
                      st.integers(min_value=4, max_value=26),
                      st.integers(min_value=2, max_value=6),
                      st.integers(min_value=0, max_value=10_000))


# ------------------------------------------------ the oracles, bit for bit
@settings(max_examples=20, deadline=None)
@given(pointsets, st.integers(0, 1000))
def test_oracles_equal_reference(vecs, seed):
    n = len(vecs)
    d_t, d_r = T.pair_dists(vecs), R.pair_dists(vecs)
    assert d_t.dtype == d_r.dtype and np.array_equal(d_t, d_r)
    for name in ("exact_rrng", "exact_mrng"):
        got, want = getattr(T, name)(vecs), getattr(R, name)(vecs)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    adj = R.exact_rrng(vecs)
    rng = np.random.default_rng(seed)
    lo = int(rng.integers(0, n - 1))
    hi = int(rng.integers(lo, n))
    assert np.array_equal(T.induced(adj, lo, hi), R.induced(adj, lo, hi))
    for a in (adj, R.exact_mrng(vecs), T.induced(adj, lo, hi),
              rng.random((n, n)) < 0.1):
        assert T.strongly_connected(a) == R.strongly_connected(a)
    for s, t in rng.integers(0, n, (8, 2)):
        assert (T.greedy_monotonic_reachable(vecs, adj, int(s), int(t))
                == R.greedy_monotonic_reachable(vecs, adj, int(s), int(t)))


@settings(max_examples=15, deadline=None)
@given(pointsets, st.integers(1, 12), st.integers(0, 1000))
def test_rrng_prune_np_equals_reference(vecs, m, seed):
    """Every node, with all candidates and with a random subset (ids
    repeated, -1 and the node itself among them)."""
    n = len(vecs)
    rng = np.random.default_rng(seed)
    for x in range(n):
        for cands in (np.arange(n),
                      rng.integers(-1, n, int(rng.integers(1, 2 * n)))):
            assert (rrng_prune_np(x, cands, vecs, m)
                    == ref_prune_np(x, cands, vecs, m)), (x, cands)


# ------------------------------------- the theorems, on the port's build
@settings(max_examples=20, deadline=None)
@given(pointsets)
def test_thm_3_3_monotonic_searchability(vecs):
    """Every pair of RRNG nodes is connected by a strictly-decreasing greedy walk."""
    adj = T.exact_rrng(vecs)
    n = len(vecs)
    rng = np.random.default_rng(0)
    for s, t in rng.integers(0, n, (min(20, n * n), 2)):
        if s != t:
            assert T.greedy_monotonic_reachable(vecs, adj, int(s), int(t)), (s, t)


@settings(max_examples=20, deadline=None)
@given(pointsets, st.integers(0, 1000))
def test_thm_3_5_rrng_heredity(vecs, seed):
    """Induced subgraph of the RRNG == RRNG rebuilt on the interval."""
    n = len(vecs)
    rng = np.random.default_rng(seed)
    lo = int(rng.integers(0, n - 1))
    hi = int(rng.integers(lo + 1, n))
    sub = T.induced(T.exact_rrng(vecs), lo, hi - 1)
    assert np.array_equal(sub, T.exact_rrng(vecs[lo:hi]))


def test_mrng_lacks_heredity():
    """Fig.1b: there exist pointsets where the induced MRNG ≠ rebuilt MRNG."""
    for seed in range(200):
        vecs = _points(12, 2, seed)
        sub = T.induced(T.exact_mrng(vecs), 2, 9)
        if not np.array_equal(sub, T.exact_mrng(vecs[2:10])):
            return  # counterexample found — MRNG is not hereditary
    pytest.fail("no MRNG heredity counterexample found in 200 seeds")


@settings(max_examples=15, deadline=None)
@given(pointsets)
def test_thm_4_3_alg1_full_candidates_equals_rrng(vecs):
    """Algorithm 1 with C = D and m = ∞ reproduces the exact RRNG, both as
    the host oracle and as the port's vectorized ``prune_all`` (candidate
    sides sorted by rank gap, every other node a candidate)."""
    n = len(vecs)
    adj = T.exact_rrng(vecs)
    cand_l = np.full((n, n), -1, np.int64)
    cand_r = np.full((n, n), -1, np.int64)
    for x in range(n):
        cand_l[x, :x] = np.arange(x - 1, -1, -1)
        cand_r[x, :n - 1 - x] = np.arange(x + 1, n)
    got = prune_all(torch.as_tensor(vecs), cand_l, cand_r, m=2 * n)
    for x in range(n):
        want = set(np.flatnonzero(adj[x]).tolist())
        assert set(rrng_prune_np(x, np.arange(n), vecs, m=10 ** 9)) == want, x
        assert set(got[x][got[x] >= 0].tolist()) == want, x


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 100))
def test_thm_4_6_rnsg_induced_strong_connectivity(seed):
    """RNSG + every interval-induced subgraph stays (strongly) connected."""
    rng = np.random.default_rng(seed)
    n = 256
    vecs = rng.standard_normal((n, 8)).astype(np.float32)
    attrs = rng.random(n).astype(np.float32) + np.arange(n) * 1e-9
    nbrs = np.asarray(build_rnsg(vecs, attrs, m=8, ef_spatial=8,
                                 ef_attribute=8, device="cpu").nbrs)
    for _ in range(5):
        lo = int(rng.integers(0, n - 2))
        hi = int(rng.integers(lo + 1, n))
        sub_n = hi - lo
        adj = np.zeros((sub_n, sub_n), bool)
        for i in range(sub_n):
            for j in nbrs[lo + i]:
                if lo <= j < hi:
                    adj[i, j - lo] = True
        # undirected reachability over the bidirectional chain guarantee
        assert T.strongly_connected(adj | adj.T), (lo, hi)


def test_thm_4_7_rnsg_heredity_with_induced_knn():
    """RNSG built on V_I with the induced KNN graph == induced RNSG subgraph."""
    rng = np.random.default_rng(3)
    n, d, k = 200, 6, 12
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    attrs = np.arange(n).astype(np.float32)
    knn = exact_knn(torch.as_tensor(vecs), k)[1].numpy()
    ef_attr, m = 10, 8
    nbrs = np.asarray(build_rnsg(vecs, attrs, m=m, ef_attribute=ef_attr,
                                 knn_ids=knn, device="cpu").nbrs)
    lo, hi = 40, 160   # interval [lo, hi)
    ind = np.full((hi - lo, k), -1, np.int32)
    for i in range(lo, hi):
        js = [j - lo for j in knn[i] if lo <= j < hi]
        ind[i - lo, :len(js)] = js
    sub_nbrs = np.asarray(build_rnsg(vecs[lo:hi], attrs[lo:hi], m=m,
                                     ef_attribute=ef_attr, knn_ids=ind,
                                     device="cpu").nbrs)
    for i in range(hi - lo):
        glob = {int(j) - lo for j in nbrs[lo + i] if lo <= j < hi}
        sub = {int(j) for j in sub_nbrs[i] if j >= 0}
        assert glob == sub, (i, glob, sub)

"""The rerank kernel's selection (``csrc/gather_dist.cu``), held on the CPU.

A CUDA kernel cannot run on the CPU, so this file holds its algorithm: a
model of what the blocks of one ``gather_rerank_select`` launch do, written
in plain Python below, must return the plain version's ids and distances
exactly (``ref.gather_rerank_ref``, which sorts the ids and takes a stable
top-k).  The model scores rows with the plain version's own distances, so
equality is exact, and follows the kernel step by step:

* the chunks of ``rerank_plan``: block (i, c) owns positions [c*R,
  min((c+1)*R, M)) of query i's ids;
* each warp's positions in steps of 4U (U = RERANK_U rows per 8-lane
  group), masked ids and positions past M never scored, an id >= N scored
  as row N-1 and keyed on its own id; the packed (dist, id) key;
* a 64-key queue of the keys that beat the warp's k-th key, flushed before
  a step could overflow it (sort, rank merge: the network and merge of
  ``tests/test_torch_range_scan_select.py``, whose helpers this file
  reuses, since both kernels share ``csrc/select.cuh``); the block's three
  pairwise merges; and, for a query of several chunks, the last block to
  arrive (in a random order) feeding the chunk lists through the same
  queue.

Beside the model: ``rerank_plan`` over every M up to 30,000 and every k up
to 3,000, the wrapper's CPU path on unsorted ids against the JAX
reference's ``gather_rerank`` on the sorted ids, and the port's
``rerank_pool`` against the reference's."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.beam import rerank_pool as jrerank_pool
from repro.kernels import ops as jops
from repro.kernels import quantize as jq
from repro_torch.core.beam import rerank_pool
from repro_torch.kernels import gather_dist as kgd
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quantize import sort_candidates
from test_torch_range_scan_select import (INF_BITS, NWARPS, QCAP, THREADS,
                                          WarpTopk, block_merge, last_block,
                                          make_key)

U = 4                                   # RERANK_U in csrc/gather_dist.cu
SMEM_MAX = 232448                       # a block's shared memory on an H100


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the model -----------------------------------------------------------

def select_block(dist, ids, p0, n, k):
    """One block of gather_rerank_select over positions [p0, p0 + n) of one
    query (dist: the plain version's distance of every position): its k
    best keys."""
    lists = []
    for warp in range(NWARPS):
        top = WarpTopk(k)
        for t0 in range(warp * 4 * U, n, NWARPS * 4 * U):
            if len(top.queue) > QCAP - 4 * U:
                top.flush()
            for u in range(U):
                passing = []
                for grp in range(4):                 # the leaders' lanes
                    r = t0 + 4 * u + grp
                    idv = int(ids[p0 + r]) if r < n else -1
                    if idv >= 0:
                        key = make_key(dist[p0 + r], idv)
                        if key < top.thr:
                            passing.append(key)
                top.push(passing)
        if top.queue:
            top.flush()
        lists.append(top.list)
    return block_merge(lists, k)


def model_rerank(x, ids, q, k, seed=0):
    """What one launch of gather_rerank_select returns: (ids (Q, k),
    dists (Q, k))."""
    path, r, s, _, _ = kgd.rerank_plan(ids.shape[1], k, x.shape[1])
    assert path == kgd.PATH_SELECT
    m = ids.shape[1]
    dist = ref.gather_dist_ref(x, ids, q).numpy()  # clips ids to [0, N-1]
    ids = ids.numpy()
    rng = np.random.default_rng(seed)
    out = []
    for i in range(ids.shape[0]):
        if s == 1:
            out.append(select_block(dist[i], ids[i], 0, min(r, m), k))
            continue
        partial, arrivals, res = [None] * s, 0, None
        for c in rng.permutation(s):               # blocks finish in any order
            c = int(c)
            partial[c] = select_block(dist[i], ids[i], c * r,
                                      min(r, m - c * r), k)
            arrivals += 1
            if arrivals == s:                      # the last arrival merges
                res = last_block(partial, k)
                arrivals = 0
        out.append(res)
    keys = np.asarray(out, dtype=np.uint64)
    fin = (keys >> np.uint64(32)) < INF_BITS
    got_i = np.where(fin, (keys & np.uint64(0xFFFFFFFF)).astype(np.int64), -1)
    got_d = np.where(fin, (keys >> np.uint64(32)).astype(np.uint32)
                     .view(np.float32), np.inf).astype(np.float32)
    return got_i.astype(np.int32), got_d


# --- data ----------------------------------------------------------------

def _data(n, d, nq, m, seed, lo=0, hi=None):
    """A corpus with duplicated rows (exact ties between two ids), and
    unsorted survivor ids with masked entries, an all-masked row, duplicate
    ids and ids >= n (scored as row n - 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[n // 2:n // 2 + 20] = x[10:30]                  # duplicated rows
    ids = rng.integers(lo, n + 3 if hi is None else hi, (nq, m))
    ids[rng.random((nq, m)) < 0.15] = -1
    ids[0] = -1                                       # all-masked row
    if m > 3:
        ids[1, : m // 3] = ids[1, m // 3: 2 * (m // 3)]   # duplicate ids
    if nq > 2 and m > 4:
        ids[2, :4] = [n // 2 + 3, 13, n - 1, n + 1]   # ties, and id >= n
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q[2] = x[13]                                      # nearest: 13, n/2 + 3
    return (torch.as_tensor(x), torch.as_tensor(ids.astype(np.int32)),
            torch.as_tensor(q))


def _close(got_d, ref_d, x):
    got_d, ref_d = np.asarray(got_d), np.asarray(ref_d)
    fin = np.isfinite(ref_d)
    assert np.array_equal(fin, np.isfinite(got_d))
    atol = 1e-4 * max(1.0, float(np.max(np.sum(np.square(x), axis=-1))))
    assert np.allclose(got_d[fin], ref_d[fin], rtol=1e-4, atol=atol)


# --- tests ---------------------------------------------------------------

@pytest.mark.parametrize("m,k,d", [(64, 10, 16), (128, 10, 24),
                                   (128, 128, 16), (5, 8, 32), (1, 1, 16),
                                   (300, 256, 20), (700, 10, 128),
                                   (3000, 37, 128), (4096, 10, 128),
                                   (1100, 256, 128)])
def test_model_equals_plain(m, k, d):
    """Every regime of the select path (one chunk; several chunks merged by
    the last arrival; k past the queue's 64 keys; M < k; one position): the
    model returns the plain version's ids and distances bit for bit, on
    unsorted ids with duplicates, exact ties and ids >= N."""
    n = 400 if m < 1000 else 3000
    x, ids, q = _data(n, d, 6, m, seed=m + k + d)
    _, r, s, _, _ = kgd.rerank_plan(m, k, d)
    assert (s > 1) == (m > r)
    got_i, got_d = model_rerank(x, ids, q, k, seed=k)
    want_i, want_d = ref.gather_rerank_ref(x, ids, q, k=k)
    assert np.array_equal(got_i, want_i.numpy())
    assert np.array_equal(got_d, want_d.numpy())


def test_model_ties_go_to_the_lower_id():
    """Query 2's nearest rows are 13 and its copy n/2 + 3, which arrive in
    the higher id's order: the lower id comes first, in one chunk and
    across chunks, and an id >= n keeps its own id; every copy of a
    duplicated id is kept."""
    for m in (64, 3000):
        x, ids, q = _data(3000, 128, 4, m, seed=5)
        n = x.shape[0]
        got_i, got_d = model_rerank(x, ids, q, 10)
        assert got_i[2, 0] == 13 and got_i[2, 1] == n // 2 + 3
        assert got_d[2, 0] == got_d[2, 1] == 0.0
        assert (got_i[0] == -1).all() and np.isinf(got_d[0]).all()
    x, ids, q = _data(400, 16, 4, 6, seed=1)
    ids[3] = torch.as_tensor([7, 7, 401, 399, -1, 7], dtype=torch.int32)
    got_i, got_d = model_rerank(x, ids, q, 6)
    assert sorted(got_i[3].tolist()) == [-1, 7, 7, 7, 399, 401]
    assert got_d[3][got_i[3] == 401] == got_d[3][got_i[3] == 399]


def test_last_arrival_order_is_irrelevant():
    x, ids, q = _data(3000, 128, 5, 3000, seed=11)
    assert kgd.rerank_plan(3000, 20, 128)[2] > 1
    first = model_rerank(x, ids, q, 20, seed=0)
    for seed in (1, 2):
        got = model_rerank(x, ids, q, 20, seed=seed)
        assert all(np.array_equal(g, f) for g, f in zip(got, first))


def _check_plan(m, k, d):
    path, r, s, p, sz = kgd.rerank_plan(m, k, d)
    if k <= kgd.SELECT_K:
        assert path == kgd.PATH_SELECT and (p, sz) == (0, 0)
        assert r % kgd.SELECT_STEP == 0 and 0 < r <= kgd.SELECT_MAX_R
        assert s >= 1 and s * r >= m and (s - 1) * r < max(m, 1)
        assert s <= max(kgd.SELECT_CHUNKS, -(-m // kgd.SELECT_MAX_R))
        nseg = -(-d // 128)
        assert NWARPS * (2 * k + QCAP) * 8 + nseg * 512 + r * 4 <= SMEM_MAX
    elif s:
        assert path == kgd.PATH_RUNS and r == kgd.TILE_MAX
        assert s & (s - 1) == 0 and s * r >= m and k > kgd.SMEM_K
    else:
        assert path == kgd.PATH_BLOCK and sz & (sz - 1) == 0
        assert sz <= kgd.TILE_MAX
        assert sz >= max(m, k) if p == 0 else k <= p < sz


def test_rerank_plan_covers_every_m_and_k():
    """Every M from 1 to 30,000 at the k of each regime's edges, and every
    k from 1 to 3,000 at the M of each edge: the select path's chunks
    cover M with at most SELECT_CHUNKS blocks of a multiple of
    SELECT_STEP positions and fit a block's shared memory; past
    SELECT_K, gather_topk's block plan or its sorted runs."""
    for d in (24, 128, 130):
        for m in range(1, 30001):
            for k in (1, 10, 256, 257, 2048, 2049, 3000):
                _check_plan(m, k, d)
    for m in (1, 5, 64, 127, 128, 129, 512, 4095, 4096, 4097, 30000):
        for k in range(1, 3001):
            _check_plan(m, k, 128)
    assert kgd.rerank_plan(128, 10, 128)[1:3] == (128, 1)  # the main path
    assert kgd.rerank_plan(4096, 10, 128)[2] > 1


@pytest.mark.parametrize("m,k", [(40, 8), (128, 10), (64, 64), (5, 8),
                                 (300, 128)])
def test_unsorted_ids_match_reference_on_sorted(m, k):
    """``ops.gather_rerank`` on the CPU, fed unsorted ids (duplicates, exact
    ties, ids >= N), equals the JAX reference's ``gather_rerank`` (Pallas
    in interpret mode) on ``sort_candidates`` of the same ids."""
    x, ids, q = _data(300, 24, 7, m, seed=3 * m + k)
    gi, gd = ops.gather_rerank(x, ids, q, k=k)
    srt = jq.sort_candidates(jnp.asarray(ids.numpy()))
    ri, rd = jops.gather_rerank(jnp.asarray(x.numpy()), srt,
                                jnp.asarray(q.numpy()), k=k)
    assert np.array_equal(gi.numpy(), np.asarray(ri))
    _close(gd.numpy(), rd, x.numpy())
    assert np.array_equal(sort_candidates(ids).numpy(), np.asarray(srt))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rerank_pool_matches_reference(use_kernel):
    """The port's ``rerank_pool`` no longer sorts its pool; on an unsorted
    pool with masked entries, duplicates and exact ties it returns the
    reference's ``rerank_pool`` (which sorts first)."""
    x, ids, q = _data(300, 24, 9, 64, seed=21, hi=300)
    gi, gd = rerank_pool(x, ids, q, 10, use_kernel=use_kernel)
    ji, jd = jrerank_pool(jnp.asarray(x.numpy()), jnp.asarray(ids.numpy()),
                          jnp.asarray(q.numpy()), 10, use_kernel=use_kernel)
    assert np.array_equal(gi.numpy(), np.asarray(ji))
    _close(gd.numpy(), jd, x.numpy())


def test_model_constants_match_kernel_source():
    """The model's block shape is the kernel's (THREADS, QCAP and RERANK_U
    in csrc/gather_dist.cu), the launcher numbers its paths as the wrapper
    does, and the choice of path is the wrapper's alone."""
    src = (Path(kgd.__file__).resolve().parents[1] / "csrc"
           / "gather_dist.cu").read_text()
    defines = dict(re.findall(r"#define (\w+) (\d+)", src))
    assert int(defines["THREADS"]) == THREADS
    assert int(defines["QCAP"]) == QCAP
    assert int(defines["RERANK_U"]) == U
    assert NWARPS * 4 * U == kgd.SELECT_STEP
    assert "SELECT_K" not in defines and "SMEM_K" not in defines
    enum = re.search(r"enum \{([^}]*)\}", src).group(1)
    paths = dict(re.findall(r"(PATH_\w+) = (\d+)", enum))
    assert {name: int(v) for name, v in paths.items()} == {
        "PATH_SELECT": kgd.PATH_SELECT, "PATH_BLOCK": kgd.PATH_BLOCK,
        "PATH_RUNS": kgd.PATH_RUNS}

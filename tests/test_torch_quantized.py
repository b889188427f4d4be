"""The port's quantized path (int8/bf16 scoring + exact f32 rerank) against
the reference's, on the CPU.

The same numpy inputs go through ``repro`` (Pallas in interpret mode, as
``tests/test_quantized.py`` runs it) and ``repro_torch`` on
``device="cpu"`` (the kernels' plain PyTorch versions).  Quantized corpora
must be bit-equal; kernel ids equal, distances within rtol 1e-4 and
atol 1e-4·max(1, max‖x‖²) (XLA and torch sum in different orders); the
search's ids, hops and ndist equal, with a flip between two candidates
whose distances agree within that tolerance judged a near-tie."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.beam import rerank_pool as jrerank_pool
from repro.core.rfann import RNSGIndex as JIndex
from repro.data.ann import make_attrs, make_vectors, selectivity_ranges
from repro.kernels import ops as jops
from repro.kernels import quantize as jq
from repro.kernels.ref import gather_rerank_ref as jgather_rerank_ref
from repro_torch.core.beam import rerank_pool
from repro_torch.core.construction import graph_from_arrays
from repro_torch.core.rfann import RNSGIndex
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tq
from repro_torch.kernels.gather_dist import TILE_MAX, topk_plan

QUANT = ("int8", "bf16")
FIELDS = ("vecs", "attrs", "nbrs", "order", "centroid", "dist_c", "rmq")


def _close(got_d, ref_d, x):
    got_d, ref_d = np.asarray(got_d), np.asarray(ref_d)
    fin = np.isfinite(ref_d)
    assert np.array_equal(fin, np.isfinite(got_d))
    atol = 1e-4 * max(1.0, float(np.max(np.sum(np.square(x), axis=-1))))
    assert np.allclose(got_d[fin], ref_d[fin], rtol=1e-4, atol=atol)


def _bits(a) -> np.ndarray:
    """Raw bits of a jax or torch array (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint8 if a.dtype == torch.int8
                              else np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else
                  np.uint8 if a.dtype.itemsize == 1 else np.uint32)


def _corpus(n, d, seed):
    """Columns on very different scales, an all-zero column, a column whose
    extreme is negative (quantizes to -127), and values that land exactly
    half-way between two int8 steps or two bf16 values."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d))
         * rng.uniform(0.01, 50.0, d)).astype(np.float32)
    x[:, 1] = 0.0                                   # all-zero dimension
    x[3, 2] = -4.0 * np.abs(x[:, 2]).max()          # clips at -127
    x[:, 4] = 0.0
    x[0, 4] = 127.0                                 # scale 1: exact halves
    x[1:9, 4] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    half = np.float32(1.0) + np.float32(2.0 ** -8)  # bf16 halfway points
    x[10:14, 5] = [half, -half, np.float32(1.0) + np.float32(3 * 2.0 ** -8),
                   np.float32(3.0) + np.float32(3 * 2.0 ** -7)]
    return x


def _quant_pair(x, precision):
    """The reference's and the port's quantized copies of one array."""
    return (jq.quantize_corpus(jnp.asarray(x), precision),
            tq.quantize_corpus(torch.as_tensor(x), precision))


# ------------------------------------------------------------ corpus artifact
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("precision", QUANT)
def test_quantized_corpus_bit_equal(precision, seed):
    x = _corpus(600, 32, seed)
    want, got = _quant_pair(x, precision)
    assert got.precision == want.precision == precision
    assert got.bytes_per_vector == want.bytes_per_vector
    assert np.array_equal(_bits(got.data), _bits(want.data))
    if precision == "int8":
        assert np.array_equal(_bits(got.scale), _bits(want.scale))
        assert (got.data[:, 1] == 0).all() and got.scale[1] == 1.0
        assert got.data[3, 2] == -127
        # round half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
        assert got.data[1:9, 4].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]
        assert np.array_equal(tq.dequantize(got).numpy(),
                              np.asarray(jq.dequantize(want)))
    else:
        assert got.scale is None and want.scale is None
        assert _bits(got.data)[10:14, 5].tolist() == [
            0x3F80, 0xBF80, 0x3F82, 0x4042]         # ties to the even bf16
    with pytest.raises(ValueError, match="invalid precision"):
        tq.quantize_corpus(torch.as_tensor(x), "f16")


def test_sort_candidates_and_rerank_depth_equal():
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 500, (7, 40)).astype(np.int32)
    ids[2] = -1
    got = tq.sort_candidates(torch.as_tensor(ids))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(jq.sort_candidates(jnp.asarray(ids))))
    assert tq.RERANK_CAP == jq.RERANK_CAP and tq.PRECISIONS == jq.PRECISIONS
    for k in (1, 5, 10, 128, 200):
        for ef in (1, 8, 16, 64, 300):
            for cap in (64, 128):
                assert tq.rerank_depth(k, ef, cap) == jq.rerank_depth(k, ef,
                                                                      cap)


# ------------------------------------------------------------ kernel parity
@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("n,m,d", [(200, 37, 48), (500, 32, 24)])
def test_gather_dist_quantized_matches_reference(precision, n, m, d):
    """Batched (Q, M) ids, out-of-range ones clipped; d = 24 is not a
    multiple of 4."""
    rng = np.random.default_rng(m)
    x = _corpus(n, d, seed=m)
    want_c, got_c = _quant_pair(x, precision)
    ids = rng.integers(-2, n + 2, (3, m)).astype(np.int32)
    qv = rng.standard_normal((3, d)).astype(np.float32)
    got = tops.gather_dist(got_c.data, torch.as_tensor(ids),
                           torch.as_tensor(qv), got_c.scale).numpy()
    want = np.stack([np.asarray(jops.gather_dist(
        want_c.data, jnp.asarray(ids[i]), jnp.asarray(qv[i]),
        scale=want_c.scale)) for i in range(3)])
    _close(got, want, x)


@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("m,k", [(37, 9), (128, 64), (5, 8)])
def test_gather_topk_quantized_matches_reference(precision, m, k):
    rng = np.random.default_rng(k)
    n, d = 300, 24
    x = _corpus(n, d, seed=k)
    want_c, got_c = _quant_pair(x, precision)
    ids = rng.integers(0, n, (3, m)).astype(np.int32)
    ids = np.where(rng.random((3, m)) < 0.3, -1, ids).astype(np.int32)
    ids[2] = -1                                     # all masked
    qv = rng.standard_normal((3, d)).astype(np.float32)
    gi, gd = tops.gather_topk(got_c.data, torch.as_tensor(ids),
                              torch.as_tensor(qv), k=k, scale=got_c.scale)
    for i in range(3):
        ri, rd = jops.gather_topk(want_c.data, jnp.asarray(ids[i]),
                                  jnp.asarray(qv[i]), k=k,
                                  scale=want_c.scale)
        assert np.array_equal(gi[i].numpy(), np.asarray(ri))
        _close(gd[i].numpy(), rd, x)


@pytest.mark.parametrize("use_live", [False, True])
@pytest.mark.parametrize("precision", QUANT)
def test_range_scan_quantized_matches_reference(precision, use_live):
    """Padded (n_pad, d_pad) quantized scan corpus with its padded scale;
    empty, one-row, unaligned and clipped windows."""
    n, d, q, bucket, k = 900, 40, 9, 256, 7
    rng = np.random.default_rng(5)
    xp = np.zeros((1024, 128), np.float32)
    xp[:n, :d] = _corpus(n, d, seed=5)
    want_c, got_c = _quant_pair(xp, precision)
    starts = rng.integers(0, n, q).astype(np.int32)
    lens = np.minimum(rng.integers(0, bucket + 1, q),
                      n - starts).astype(np.int32)
    lens[0] = 0
    starts[1], lens[1] = n - 1, 1
    starts[2], lens[2] = 130, bucket
    qv = np.zeros((q, 128), np.float32)
    qv[:, :d] = rng.standard_normal((q, d)).astype(np.float32)
    live = (rng.random((1, 1024)) < 0.6).astype(np.int32) if use_live \
        else None
    ri, rd = jops.range_scan(want_c.data, jnp.asarray(starts),
                             jnp.asarray(lens), jnp.asarray(qv),
                             bucket=bucket, k=k, scale=want_c.scale,
                             live=None if live is None else jnp.asarray(live))
    ti, td = tops.range_scan(got_c.data, torch.as_tensor(starts),
                             torch.as_tensor(lens), torch.as_tensor(qv),
                             bucket=bucket, k=k, scale=got_c.scale,
                             live=None if live is None
                             else torch.as_tensor(live))
    assert np.array_equal(ti.numpy(), np.asarray(ri))
    _close(td.numpy(), rd, xp)


@pytest.mark.parametrize("m,k", [(40, 8), (128, 10), (64, 64), (5, 8)])
def test_gather_rerank_matches_reference(m, k):
    """Sparse survivor lists, one fully masked pool, M < k."""
    rng = np.random.default_rng(m + k)
    n, d, q = 300, 24, 11
    x = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.integers(0, n, (q, m)).astype(np.int32)
    ids[rng.random((q, m)) < 0.25] = -1
    ids[3] = -1
    ids = np.array(jq.sort_candidates(jnp.asarray(ids)))
    qv = rng.standard_normal((q, d)).astype(np.float32)
    gi, gd = tops.gather_rerank(torch.as_tensor(x), torch.as_tensor(ids),
                                torch.as_tensor(qv), k=k)
    ri, rd = jops.gather_rerank(jnp.asarray(x), jnp.asarray(ids),
                                jnp.asarray(qv), k=k)
    assert np.array_equal(gi.numpy(), np.asarray(ri))
    _close(gd.numpy(), rd, x)


def test_gather_rerank_wide_k_matches_reference_oracle():
    """k > 128, where the reference leaves its kernel for the jnp oracle;
    the port's wrapper takes every k."""
    rng = np.random.default_rng(9)
    n, d, q, m, k = 600, 16, 4, 300, 200
    x = rng.standard_normal((n, d)).astype(np.float32)
    ids = np.sort([rng.permutation(n)[:m] for _ in range(q)],
                  1).astype(np.int32)
    qv = rng.standard_normal((q, d)).astype(np.float32)
    gi, gd = tops.gather_rerank(torch.as_tensor(x), torch.as_tensor(ids),
                                torch.as_tensor(qv), k=k)
    ri, rd = jgather_rerank_ref(jnp.asarray(x), jnp.asarray(ids),
                                jnp.asarray(qv), k=k)
    assert np.array_equal(gi.numpy(), np.asarray(ri))
    _close(gd.numpy(), rd, x)


@pytest.mark.parametrize("m,k", [(64, 10), (4096, 10), (4097, 10),
                                 (30000, 128), (5000, 3000), (100, 5000),
                                 (9000, 2049)])
def test_topk_plan_covers_every_m_and_k(m, k):
    """The kernels' plan: one block sort, a tiled running best, or sorted
    runs merged in global memory; each covers all M positions and k."""
    p, sz, r, s = topk_plan(m, k)
    if s == 0:
        assert sz & (sz - 1) == 0 and sz <= TILE_MAX
        if p == 0:
            assert sz >= max(m, k)
        else:
            assert p == 1 << (k - 1).bit_length() and k <= p < sz
    else:
        assert r == TILE_MAX and s & (s - 1) == 0 and s * r >= m
        assert k > 2048


# ------------------------------------------------------- rerank exactness
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("precision", QUANT)
def test_scan_rerank_restores_exact_f32_topk(precision, use_kernel):
    """The quantized scan keeping ``rerank_depth`` survivors + the f32
    rerank returns the exact f32 top-k (empty and sub-k slices included),
    the port's and the reference's alike."""
    n, d, k, ef, bucket = 700, 24, 7, 16, 256
    rng = np.random.default_rng(3)
    xp = np.zeros((768, 128), np.float32)
    xp[:n, :d] = rng.standard_normal((n, d)).astype(np.float32)
    want_c, got_c = _quant_pair(xp, precision)
    starts = np.asarray([0, 123, 600, 42, 42], np.int32)
    lens = np.minimum(np.asarray([64, 200, 100, 0, 3], np.int32), n - starts)
    qv = np.zeros((len(starts), 128), np.float32)
    qv[:, :d] = rng.standard_normal((len(starts), d)).astype(np.float32)
    t = [torch.as_tensor(a) for a in (starts, lens, qv)]
    f32_i, f32_d = tops.range_scan(torch.as_tensor(xp), *t, bucket=bucket,
                                   k=k)
    rq = tq.rerank_depth(k, ef)
    q_i, _ = tops.range_scan(got_c.data, *t, bucket=bucket, k=rq,
                             scale=got_c.scale)
    ids, dists = rerank_pool(torch.as_tensor(xp), q_i, t[2], k,
                             use_kernel=use_kernel)
    assert np.array_equal(ids.numpy(), f32_i.numpy())
    _close(dists.numpy(), f32_d.numpy(), xp)
    jq_i, _ = jops.range_scan(want_c.data, *map(jnp.asarray,
                                                (starts, lens, qv)),
                              bucket=bucket, k=rq, scale=want_c.scale)
    assert np.array_equal(q_i.numpy(), np.asarray(jq_i))
    ji, jd = jrerank_pool(jnp.asarray(xp), jq_i, jnp.asarray(qv), k,
                          use_kernel=use_kernel)
    assert np.array_equal(ids.numpy(), np.asarray(ji))
    _close(dists.numpy(), jd, xp)


# --------------------------------------------------------------- end to end
N, D, NQ, K = 300, 24, 12, 5


@pytest.fixture(scope="module")
def pair():
    """The reference index and the port's over the same graph and the same
    quantized corpora (carried across as their exact f32 upcasts)."""
    vecs = make_vectors(N, D, seed=0)
    attrs = make_attrs(N, seed=0)
    ref = JIndex.build(vecs, attrs, m=12)
    port = RNSGIndex(graph_from_arrays(
        {f: np.asarray(getattr(ref.g, f)) for f in FIELDS}, "cpu"))
    for p in QUANT:
        ref.install_quantized(p)
        slot = ref.substrate._quant[p]
        port.substrate.preload_quantized(
            p, np.asarray(slot["data"]).astype(np.float32),
            None if slot["scale"] is None else np.array(slot["scale"]))
        assert np.array_equal(_bits(port.substrate._quant[p]["data"]),
                              _bits(slot["data"]))
    qv = make_vectors(NQ, D, seed=7)
    ranges = selectivity_ranges(attrs, NQ, 0.3, seed=3)
    ranges[0] = [2.0, 1.0]                          # empty attribute range
    live = np.random.default_rng(3).random(N) < 0.8
    return ref, port, qv, ranges, live


def _equal_up_to_near_ties(got, want, x_norm):
    """Ids equal by position, except where the two distances at a position
    agree within the tolerance (a near-tie that summation order flips)."""
    atol = 1e-4 * max(1.0, x_norm)
    fin = np.isfinite(want.dists)
    assert np.array_equal(np.isfinite(got.dists), fin)
    assert np.allclose(got.dists[fin], want.dists[fin], rtol=1e-4, atol=atol)
    tie = np.isclose(got.dists, want.dists, rtol=1e-4, atol=atol) & fin
    assert not ((got.ids != want.ids) & ~tie).any()


@pytest.mark.parametrize("use_live", [False, True])
@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("bw", [1, 4])
@pytest.mark.parametrize("plan", ["graph", "auto", "scan", "beam"])
def test_quantized_search_equals_reference(pair, plan, bw, use_kernel,
                                           precision, use_live):
    """Below the exhaustive regime (ef < n): ids, routing, and per query
    hops and ndist equal the reference's from the same planner state."""
    ref, port, qv, ranges, live = pair
    port.planner.cost.load_state_dict(ref.planner.cost.state_dict())
    kw = dict(k=K, ef=16, plan=plan, beam_width=bw, use_kernel=use_kernel,
              precision=precision, live=live if use_live else None)
    want = ref.search(qv, ranges, **kw)
    got = port.search(qv, ranges, **kw)
    x_norm = float((port.g.vecs ** 2).sum(1).max())
    _equal_up_to_near_ties(got, want, x_norm)
    assert np.array_equal(got.stats["strategy"], want.stats["strategy"])
    beam = want.stats["strategy"] == 1
    for s in ("hops", "ndist"):
        assert np.array_equal(got.stats[s][beam], want.stats[s][beam]), s
    if use_live:
        order = port.g.order.numpy().argsort()
        assert all(live[order[i]] for i in got.ids[got.ids >= 0])


@pytest.mark.parametrize("plan", ["graph", "auto", "scan", "beam"])
def test_quantized_exhaustive_equals_f32(pair, plan):
    """At ef >= n every strategy × precision returns the f32 top-k ids with
    the f32 distances: the rerank restores what quantization reorders."""
    _, port, qv, ranges, _ = pair
    for bw in (1, 4):
        base = port.search(qv, ranges, k=K, ef=N, plan=plan, beam_width=bw)
        for prec in QUANT:
            res = port.search(qv, ranges, k=K, ef=N, plan=plan,
                              beam_width=bw, precision=prec)
            assert np.array_equal(res.ids, base.ids), (bw, prec)
            assert np.allclose(res.dists[res.ids >= 0],
                               base.dists[base.ids >= 0], atol=1e-4)


def test_install_quantized_matches_preload_and_counts_nothing_on_cpu(pair):
    """``install_quantized`` on the port's own f32 corpus builds the corpus
    the reference carried across; CPU tensors launch no kernel."""
    _, port, qv, ranges, _ = pair
    sub = port.substrate
    carried = {p: sub._quant[p] for p in QUANT}
    try:
        for p in QUANT:
            port.install_quantized(p)
            for key in ("data", "data_pad", "scale", "scale_pad"):
                a, b = sub._quant[p][key], carried[p][key]
                assert (a is None and b is None) or torch.equal(a, b), key
            assert sub._quant[p]["data_pad"].shape == (384, 128)
    finally:
        sub._quant.update(carried)
    tops.reset_launches()
    port.search(qv, ranges, k=K, ef=16, plan="auto", precision="int8",
                use_kernel=True)
    assert set(tops.LAUNCHES) >= {"gather_rerank", "range_scan.int8",
                                  "gather_dist.bf16", "gather_topk.f32"}
    assert all(v == 0 for v in tops.LAUNCHES.values())

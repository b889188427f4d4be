"""On the card: each hand-written kernel against its plain PyTorch version
(f32, int8 and bf16 corpora; the f32 rerank at every M and k; l2dist; the
fused beam against the lockstep loop), the quantized corpus against the
CPU's bit for bit, and the slices end to end (the benchmark's baselines,
the 8-shard mesh and sharded build on one card, and one LM of each family
against the CPU included, serving and training).  Marked
``gpu``; every test skips (inside the ``cuda`` fixture) where no card is
present.  Run on the card with ``pytest -m gpu tests/test_torch_*.py``."""
import copy
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

#: seconds a torch.profiler session waits before its first launch: kernels
#: launched right after the session starts are now and then all missing
#: from it, whatever ran before in the process
PROFILER_LEAD_S = 0.02


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(got, want, atol=1e-2):
    """Dists allclose by position; ids equal except where the two
    distances at a position are within the tolerance (a near-tie that the
    kernel's summation order may flip)."""
    gi, gd = (t.cpu().numpy() for t in got)
    wi, wd = (t.cpu().numpy() for t in want)
    fin = np.isfinite(wd)
    assert np.array_equal(np.isfinite(gd), fin)
    assert np.allclose(gd[fin], wd[fin], rtol=1e-4, atol=atol)
    tie = np.isclose(gd, wd, rtol=1e-4, atol=atol) & fin
    assert not ((gi != wi) & ~tie).any()


@pytest.mark.parametrize("bucket,k", [(64, 10), (512, 10), (4096, 128),
                                      (2048, 300), (4096, 4096),
                                      (16384, 5000)])
def test_range_scan_kernel_matches_plain(cuda, bucket, k):
    rng = np.random.default_rng(bucket)
    n, d_pad, q = 5000, 128, 16
    x = torch.zeros((5120, d_pad), device=cuda)
    x[:n] = torch.as_tensor(rng.standard_normal((n, d_pad)), device=cuda,
                            dtype=torch.float32)
    starts = torch.as_tensor(rng.integers(0, n, q), device=cuda)
    lens = torch.as_tensor(rng.integers(0, bucket + 1, q), device=cuda)
    lens[0] = 0
    starts[1] = n - 3
    qv = torch.as_tensor(rng.standard_normal((q, d_pad)), device=cuda,
                         dtype=torch.float32)
    live = torch.as_tensor(rng.random((1, 5120)) < 0.7, device=cuda).int()
    for kw in ({}, {"n_valid": n}, {"live": live}):
        got = ops.range_scan(x, starts, lens, qv, bucket=bucket, k=k, **kw)
        want = ref.range_scan_ref(x, starts, lens, qv, bucket=bucket, k=k,
                                  **kw)
        _same(got, want)


@pytest.mark.parametrize("m,k", [(32, 32), (128, 64), (200, 128), (5, 8)])
def test_gather_kernels_match_plain(cuda, m, k):
    rng = np.random.default_rng(m)
    x = torch.as_tensor(rng.standard_normal((3000, 96)), device=cuda,
                        dtype=torch.float32)
    ids = torch.as_tensor(rng.integers(-3, 3003, (64, m)), device=cuda)
    qv = torch.as_tensor(rng.standard_normal((64, 96)), device=cuda,
                         dtype=torch.float32)
    got = ops.gather_dist(x, ids, qv).cpu().numpy()
    want = ref.gather_dist_ref(x, ids, qv).cpu().numpy()
    assert np.allclose(got, want, rtol=1e-5, atol=1e-3)
    ids = torch.where(ids >= 3000, -1, ids)
    _same(ops.gather_topk(x, ids, qv, k=k), ref.gather_topk_ref(x, ids, qv, k=k))


def _quantized(x, precision):
    from repro_torch.kernels.quantize import quantize_corpus
    qc = quantize_corpus(x, precision)
    return qc.data, qc.scale


@pytest.mark.parametrize("precision", ["int8", "bf16"])
@pytest.mark.parametrize("bucket,k", [(512, 10), (8192, 128), (4096, 300)])
def test_range_scan_quantized_kernel_matches_plain(cuda, precision, bucket,
                                                   k):
    rng = np.random.default_rng(bucket + k)
    n, q = 9000, 16
    x = torch.zeros((9088, 128), device=cuda)
    x[:n] = torch.as_tensor(rng.standard_normal((n, 128)) * 3, device=cuda,
                            dtype=torch.float32)
    data, scale = _quantized(x, precision)
    starts = torch.as_tensor(rng.integers(0, n, q), device=cuda)
    lens = torch.as_tensor(rng.integers(0, bucket + 1, q), device=cuda)
    lens[0] = 0
    qv = torch.as_tensor(rng.standard_normal((q, 128)), device=cuda,
                         dtype=torch.float32)
    live = torch.as_tensor(rng.random((1, 9088)) < 0.7, device=cuda).int()
    for kw in ({}, {"n_valid": n}, {"live": live}):
        got = ops.range_scan(data, starts, lens, qv, bucket=bucket, k=k,
                             scale=scale, **kw)
        want = ref.range_scan_ref(data, starts, lens, qv, bucket=bucket, k=k,
                                  scale=scale, **kw)
        _same(got, want, atol=0.1)


@pytest.mark.parametrize("precision", ["int8", "bf16"])
@pytest.mark.parametrize("m,k,d", [(32, 32, 128), (128, 64, 128),
                                   (37, 9, 24)])
def test_gather_quantized_kernels_match_plain(cuda, precision, m, k, d):
    rng = np.random.default_rng(m + d)
    x = torch.as_tensor(rng.standard_normal((3000, d)) * 3, device=cuda,
                        dtype=torch.float32)
    data, scale = _quantized(x, precision)
    ids = torch.as_tensor(rng.integers(-3, 3003, (64, m)), device=cuda)
    qv = torch.as_tensor(rng.standard_normal((64, d)), device=cuda,
                         dtype=torch.float32)
    got = ops.gather_dist(data, ids, qv, scale).cpu().numpy()
    want = ref.gather_dist_ref(data, ids, qv, scale).cpu().numpy()
    assert np.allclose(got, want, rtol=1e-5, atol=1e-2)
    ids = torch.where(ids >= 3000, -1, ids)
    _same(ops.gather_topk(data, ids, qv, k=k, scale=scale),
          ref.gather_topk_ref(data, ids, qv, k=k, scale=scale), atol=0.1)


@pytest.mark.parametrize("m,k", [(128, 10), (64, 10), (4096, 200),
                                 (4096, 10), (30000, 128), (5, 8),
                                 (9000, 3000), (128, 1), (1, 1), (512, 256),
                                 (300, 257), (30000, 10)])
@pytest.mark.parametrize("d,aligned", [(128, True), (128, False), (24, True),
                                       (130, True)])
def test_gather_rerank_kernel_matches_plain(cuda, m, k, d, aligned):
    """Every M (past one block's chunk, past one tile), every k (past the
    select path's 256 and past the shared-memory running best), rows with a
    partial last 128-wide segment (d = 24), rows for scalar loads (d = 130,
    or a corpus not 16-byte aligned); unsorted ids with masked entries, an
    all-masked row, duplicate ids, exact ties between copied rows and ids
    >= N.  One wrapper launch per call (the kernels on the card per call:
    ``test_gather_rerank_is_one_launch``)."""
    rng = np.random.default_rng(m + k + d)
    n = 50000
    x_np = rng.standard_normal((n, d)).astype(np.float32)
    x_np[25000:25100] = x_np[100:200]                  # exact ties
    flat = torch.empty(n * d + 1, device=cuda)
    off = int(not aligned)                             # 4 bytes off if not
    x = flat[off:off + n * d].view(n, d)
    x.copy_(torch.as_tensor(x_np, device=cuda))
    assert (x.data_ptr() % 16 == 0) == aligned
    ids = rng.integers(0, n + 50, (8, m))              # a few ids >= N
    ids[rng.random((8, m)) < 0.2] = -1
    ids[1] = -1
    ids[2, : m // 2] = ids[2, m // 2: 2 * (m // 2)]    # duplicate ids
    if m >= 2:
        ids[3, :2] = [25050, 150]                      # tie, higher id first
    ids = torch.as_tensor(ids.astype(np.int32), device=cuda)
    qv = torch.as_tensor(rng.standard_normal((8, d)), device=cuda,
                         dtype=torch.float32)
    qv[3] = x[150]
    ops.reset_launches()
    got = ops.gather_rerank(x, ids, qv, k=k)
    assert ops.LAUNCHES["gather_rerank"] == 1
    want = ref.gather_rerank_ref(x, ids, qv, k=k)
    _same(got, want)
    if m >= 2:                 # the exact ties at 0, lower id first
        tied = got[0][3][got[1][3] == 0].tolist()
        assert tied[0] == 150 and tied == sorted(tied)
        assert k < 2 or 25050 in tied


def test_quantized_corpus_on_card_equals_cpu(cuda):
    from repro_torch.kernels.quantize import quantize_corpus
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5000, 128)) *
         rng.uniform(0.01, 50, 128)).astype(np.float32)
    x[:, 7] = 0
    for p in ("int8", "bf16"):
        a = quantize_corpus(torch.as_tensor(x), p)
        b = quantize_corpus(torch.as_tensor(x, device=cuda), p)
        assert torch.equal(a.data.view(torch.uint8 if p == "int8"
                                       else torch.int16),
                           b.data.cpu().view(torch.uint8 if p == "int8"
                                             else torch.int16))
        if p == "int8":
            assert torch.equal(a.scale.view(torch.int32),
                               b.scale.cpu().view(torch.int32))


def test_slice_end_to_end_on_card(cuda):
    """Build on the card, then every strategy × width × kernel choice
    returns the exact brute-force ids at ef >= n, through the kernels."""
    from repro_torch.core.rfann import RNSGIndex
    from repro_torch.data.ann import (ground_truth, make_attrs, make_vectors,
                                      mixed_workload)
    n, d = 2048, 32
    v, a = make_vectors(n, d, seed=0), make_attrs(n, seed=0)
    qv = make_vectors(24, d, seed=7)
    rg, _ = mixed_workload(a, 24, seed=1)
    idx = RNSGIndex.build(v, a, m=16, ef_spatial=16, ef_attribute=24)
    gt, _ = ground_truth(v, a, qv, rg, 10)
    ops.reset_launches()
    for precision in ("f32", "int8", "bf16"):
        for plan in ("graph", "auto", "scan", "beam"):
            for bw in (1, 4):
                for uk in (False, True):
                    ids = idx.search(qv, rg, k=10, ef=n, plan=plan,
                                     beam_width=bw, use_kernel=uk,
                                     precision=precision).ids
                    for r in range(len(qv)):
                        assert set(ids[r][ids[r] >= 0]) == \
                            set(gt[r][gt[r] >= 0])
    # the search path runs the fused beams; the per-hop gathers and l2dist
    # are not on it
    off = ("l2dist", "gather_dist", "gather_topk")
    assert all(c > 0 for name, c in ops.LAUNCHES.items()
               if not name.startswith(off)), ops.LAUNCHES
    assert not any(c for name, c in ops.LAUNCHES.items()
                   if name.startswith(off)), ops.LAUNCHES


@pytest.mark.parametrize("cap", [128, 256, 512, 1024, 2048, 4096, 8192])
def test_delta_scan_matches_plain(cuda, cap):
    """The streaming delta's scan (range_scan at bucket = its pow2
    capacity, the pad tail masked by the live row) on the card against the
    same view's plain version, at every capacity up to 8192; one launch per
    search."""
    from repro_torch.streaming import DeltaView
    rng = np.random.default_rng(cap)
    m, d = cap - cap // 3, 128
    v = rng.standard_normal((m, d)).astype(np.float32)
    a = np.sort(rng.random(m).astype(np.float32))
    ids = np.arange(m, dtype=np.int32) * 2 + 11
    qv = rng.standard_normal((40, d)).astype(np.float32)
    lo = rng.random(40).astype(np.float32) * 0.9
    ar = np.stack([lo, lo + rng.random(40).astype(np.float32) * 0.4], 1)
    ar[0] = (2.0, 3.0)                      # past every row
    view = DeltaView(v, a, ids, cuda)
    ops.reset_launches()
    got = view.search(qv, ar, 10)
    assert ops.LAUNCHES["range_scan.f32"] == 1 and view._dev[2] == cap
    want = DeltaView(v, a, ids, "cpu").search(qv, ar, 10)
    _same(tuple(torch.as_tensor(x) for x in got),
          tuple(torch.as_tensor(x) for x in want))
    assert (got[0][0] == -1).all()


def test_searches_from_two_threads_during_a_build(cuda):
    """Two threads search one index at once while a third builds another
    on the card (the engine's dispatch thread beside a compaction): every
    thread's ids equal a serial run's, through the kernels."""
    import threading
    from repro_torch.core.construction import build_rnsg
    from repro_torch.core.rfann import RNSGIndex
    from repro_torch.data.ann import make_attrs, make_vectors, mixed_workload
    n, d = 20000, 64
    v, a = make_vectors(n, d, seed=0), make_attrs(n, seed=0)
    idx = RNSGIndex.build(v, a, m=16, ef_spatial=16, ef_attribute=24)
    idx.install_quantized("int8")
    qv = make_vectors(256, d, seed=7)
    rg, _ = mixed_workload(a, 256, seed=1)
    plans = [dict(plan="auto", beam_width=1), dict(plan="graph",
                                                   beam_width=4),
             dict(plan="auto", precision="int8")]
    # keep the calibration fixed, so the threads and the serial run route
    # every query alike
    idx.planner.cost.observe_wall = lambda *a, **kw: None
    idx.planner.cost.update_beam = lambda *a, **kw: None
    serial = [[idx.search(qv[i:i + 64], rg[i:i + 64], k=10, ef=64, **kw).ids
               for i in range(0, 256, 64)] for kw in plans]
    out, errs = {}, []

    def searcher(t):
        try:
            for rep in range(3):
                for j, kw in enumerate(plans):
                    out[(t, rep, j)] = [
                        idx.search(qv[i:i + 64], rg[i:i + 64], k=10, ef=64,
                                   **kw).ids for i in range(0, 256, 64)]
        except Exception as e:
            errs.append(e)

    def builder():
        try:
            build_rnsg(make_vectors(30000, d, seed=3),
                       make_attrs(30000, seed=3), m=16)
        except Exception as e:
            errs.append(e)

    ops.reset_launches()
    ts = [threading.Thread(target=searcher, args=(t,)) for t in (0, 1)]
    ts.append(threading.Thread(target=builder))
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    for (t, rep, j), got in out.items():
        for g, w in zip(got, serial[j]):
            assert np.array_equal(g, w), (t, rep, j)
    assert ops.LAUNCHES["beam_single.f32"] > 0
    assert ops.LAUNCHES["beam_batched.f32"] > 0
    assert ops.LAUNCHES["range_scan.int8"] > 0 and ops.LAUNCHES[
        "gather_rerank"] > 0


def test_sharded_build_on_card_bit_equal(cuda):
    """Eight slabs on one card: every array equals ``build_rnsg``'s (the
    KNN products have its 512-row shapes, the prune its 8192-row grid)."""
    from repro_torch.core.build_sharded import build_rnsg_sharded
    from repro_torch.core.construction import build_rnsg
    from repro_torch.data.ann import make_attrs, make_vectors
    n, d = 30000, 64
    v, a = make_vectors(n, d, seed=4), make_attrs(n, seed=4)
    want = build_rnsg(v, a, m=16, ef_spatial=16, ef_attribute=24).arrays()
    g = build_rnsg_sharded(v, a, n_shards=8, m=16, ef_spatial=16,
                           ef_attribute=24)
    assert g.device.type == "cuda" and g.meta["shards"] == 8
    got = g.arrays()
    for f in want:
        assert np.array_equal(got[f], want[f]), f


@pytest.mark.parametrize("bw", [1, 4])
@pytest.mark.parametrize("plan", ["graph", "auto"])
def test_mesh_on_card_matches_local_and_plain(cuda, plan, bw):
    """An 8-shard mesh on one card: its merged top-k is the local path's
    (up to near-ties), the local path's kernels agree with its plain
    versions, and the mesh runs one fused beam per shard per batch."""
    from repro_torch.data.ann import make_attrs, make_vectors, mixed_workload
    from repro_torch.parallel.sharding import make_mesh
    from repro_torch.serving.distributed import DistributedRFANN
    n, d, q = 16000, 32, 64
    v, a = make_vectors(n, d, seed=1), make_attrs(n, seed=1)
    qv = make_vectors(q, d, seed=2)
    rg, _ = mixed_workload(a, q, seed=3)
    kw = dict(n_shards=8, m=16, ef_spatial=16, ef_attribute=24)
    local = DistributedRFANN(v, a, **kw)
    mesh = DistributedRFANN(v, a, mesh=make_mesh(8), **kw)
    assert {str(dv) for dv in mesh.mesh.devices} == {"cuda:0"} or \
        torch.cuda.device_count() > 1
    sk = dict(k=10, ef=64, plan=plan, beam_width=bw)
    planners = ([sub.planner for sub in local.substrates]
                + [mesh.mesh_substrate.planner])
    prior = [p.cost.state_dict() for p in planners]

    def run(dist, **kw):
        # every search plans from the planners' prior, so a kernel path
        # and its plain path route alike
        for p, st in zip(planners, prior):
            p.cost.load_state_dict(copy.deepcopy(st))
        return tuple(torch.as_tensor(t)
                     for t in dist.search(qv, rg, **sk, **kw))
    ops.reset_launches()
    got = run(mesh)
    beam = "beam_batched.f32" if bw > 1 else "beam_single.f32"
    assert ops.LAUNCHES[beam] == 8 or plan == "auto"
    assert ops.LAUNCHES[beam] > 0
    want = run(local)
    _same(want, run(local, use_kernel=False), atol=1e-3)
    _same(got, run(mesh, use_kernel=False), atol=1e-3)
    if plan == "graph":     # auto may route a query's narrow side apart
        _same(got, want, atol=1e-3)


def test_async_local_path_enqueues_without_a_host_sync(cuda):
    """The distributed local path's enqueue, every shard's
    ``dispatch(defer=True)``, under ``set_sync_debug_mode("error")``: no
    ``.cpu()``, ``.item()``, ``nonzero`` or pageable copy waits on the
    card before the merge."""
    from repro_torch.data.ann import make_attrs, make_vectors, mixed_workload
    from repro_torch.search import SearchRequest, clip_interval
    from repro_torch.serving.distributed import DistributedRFANN
    n, d, q = 16000, 32, 64
    v, a = make_vectors(n, d, seed=5), make_attrs(n, seed=5)
    qv = make_vectors(q, d, seed=6)
    rg, _ = mixed_workload(a, q, seed=7)
    dist = DistributedRFANN(v, a, n_shards=8, m=16, ef_spatial=16,
                            ef_attribute=24)
    dist.install_quantized("int8")
    lo, hi = dist.rank_range(rg)
    for prec, bw, plan in (("f32", 1, "auto"), ("int8", 4, "auto"),
                           ("f32", 4, "graph")):
        kw = dict(k=10, ef=64, plan=plan, beam_width=bw, precision=prec)
        want = dist.search(qv, rg, **kw)           # builds the kernels
        pending = []
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for s, sub in enumerate(dist.substrates):
                slo, shi = clip_interval(lo, hi, s * dist.per, dist.per)
                pending.append(sub.dispatch(SearchRequest(
                    queries=qv, lo=slo, hi=shi, k=10, ef=64, strategy=plan,
                    use_kernel=True, beam_width=bw, precision=prec),
                    defer=True))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert len(pending) == 8
        got = [p.result() for p in pending]
        assert all(r.ids.shape == (q, 10) for r in got)
        assert want[0].shape == (q, 10)


@pytest.mark.parametrize("q,n,d", [(1, 1, 1), (4, 7, 3), (100, 300, 130),
                                   (257, 129, 515), (1, 1, 515),
                                   (33, 1000, 96), (256, 4096, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2dist_kernel_matches_plain(cuda, q, n, d, dtype):
    """The reference test's tolerance, 1e-3·max(1, d/64) (f32) or
    0.15·max(1, d/64) (bf16), as max abs error; never negative; one
    counted launch."""
    rng = np.random.default_rng(q * n + d)
    a = torch.as_tensor(rng.standard_normal((q, d)), device=cuda).to(dtype)
    b = torch.as_tensor(rng.standard_normal((n, d)), device=cuda).to(dtype)
    ops.reset_launches()
    got = ops.l2dist(a, b)
    assert ops.LAUNCHES[f"l2dist.{ops.DTYPE_NAMES[dtype]}"] == 1
    want = ref.l2dist_ref(a, b)
    tol = (1e-3 if dtype == torch.float32 else 0.15) * max(1.0, d / 64)
    assert got.shape == (q, n) and got.dtype == torch.float32
    assert float((got - want).abs().max()) < tol
    assert bool((got >= 0).all())


def _scan_case(cuda, precision, bucket, seed):
    """A 9,000-row corpus (rows 1000-1099 copies of 900-999) in the given
    precision, 16 windows of bucket/2 .. bucket rows (one empty, a one-row
    tail, an unaligned start, one over the copies), int32 starts and
    lengths as the search path passes them, and a 70 % live mask."""
    rng = np.random.default_rng(seed)
    n, q = 9000, 16
    x = torch.zeros((9088, 128), device=cuda)
    x[:n] = torch.as_tensor(rng.standard_normal((n, 128)) * 3, device=cuda,
                            dtype=torch.float32)
    x[1000:1100] = x[900:1000]
    data, scale = (x, None) if precision == "f32" else _quantized(x,
                                                                   precision)
    starts = rng.integers(0, n, q).astype(np.int32)
    lens = rng.integers(bucket // 2, bucket + 1, q).astype(np.int32)
    lens[0] = 0
    starts[1], lens[1] = n - 1, 1
    starts[2] = 128 * 7 + 37
    starts[3], lens[3] = 880, min(bucket, 300)
    qv = torch.as_tensor(rng.standard_normal((q, 128)), device=cuda,
                         dtype=torch.float32)
    qv[3] = x[950]
    live = torch.as_tensor(rng.random((1, 9088)) < 0.7, device=cuda).int()
    return (data, torch.as_tensor(starts, device=cuda),
            torch.as_tensor(lens, device=cuda), qv, scale, live, n)


@pytest.mark.parametrize("bucket", [64, 2048, 16384])
@pytest.mark.parametrize("k", [1, 10, 128, 129, 256, 257, 2048, 4096, 5000])
@pytest.mark.parametrize("precision", ["f32", "int8", "bf16"])
def test_range_scan_every_regime_matches_plain(cuda, precision, k, bucket):
    """One chunk, many chunks merged by the last block, and the two-pass
    paths past k = 256, with n_valid and live; exact ties (the copied rows)
    go to the lower rank."""
    data, st, ln, qv, scale, live, n = _scan_case(cuda, precision, bucket,
                                                  k + bucket)
    atol = 1e-2 if precision == "f32" else 0.1
    for kw in ({"n_valid": n - 37}, {"live": live, "n_valid": n}):
        got = ops.range_scan(data, st, ln, qv, bucket=bucket, k=k,
                             scale=scale, **kw)
        want = ref.range_scan_ref(data, st, ln, qv, bucket=bucket, k=k,
                                  scale=scale, **kw)
        _same(got, want, atol=atol)
        if kw.get("live") is None and k >= 2 and bucket >= 300:
            gi, gd = (t.cpu().numpy() for t in got)
            assert gi[3, 0] == 950 and gi[3, 1] == 1050
            assert gd[3, 0] == gd[3, 1]


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b", "mamba2-780m",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_lm_family_on_card_matches_cpu(cuda, arch):
    """One arch per family, smoke config in f32 (TF32 off), parameters from
    numpy: the card's prefill and two decode steps (fed the CPU's greedy
    tokens) equal the CPU's logits and caches within 1e-4 (caches scaled
    by max(1, |leaf|)), and on the card the first decode step's logits
    equal the last position of a prefill one token longer within 1e-3."""
    import dataclasses
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models.lm import Model
    from repro_torch.models.params import numpy_params, params_from_reference
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    flat = list(numpy_params(cfg, 0))
    batch = concrete_batch(cfg, "prefill", 2, 16, np.random.default_rng(0),
                           device="cpu")
    runs, toks = {}, []
    for dev in (torch.device("cpu"), cuda):
        model = Model(cfg, device=dev)
        params = params_from_reference(flat, cfg, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        out = []
        with torch.inference_mode():
            cache, logits = model.prefill(params, b, cache_len=19)
            for i in range(3):
                out.append((logits.cpu().numpy().copy(),
                            {k: v.cpu().numpy().copy()
                             for k, v in cache.items()}))
                if i == 2:
                    break
                if dev.type == "cpu":
                    toks.append(torch.argmax(logits[:, :cfg.vocab_size], -1)
                                .int())
                logits, cache = model.decode(params, cache, 16 + i,
                                             toks[i].to(dev))
                if i == 0:
                    l_dec = logits
            full = dict(b, tokens=torch.cat([b["tokens"],
                                             toks[0][:, None].to(dev)], 1))
            l_full = model.prefill(params, full)[1]
        assert (l_dec - l_full).abs().max().item() < 1e-3, dev
        runs[dev.type] = out
    for (lc, cc), (lg, cg) in zip(runs["cpu"], runs["cuda"]):
        assert np.abs(lg - lc).max() <= 1e-4
        for k in cc:
            assert np.abs(cg[k] - cc[k]).max() <= 1e-4 * max(
                1.0, float(np.abs(cc[k]).max())), k


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b", "mamba2-780m",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_train_family_on_card_matches_cpu(cuda, arch):
    """One arch per family through the smoke script's own card-vs-CPU
    comparison (``chip_smoke._train_smoke``, its tolerances stated there):
    smoke config in f32, parameters from numpy, loss and every gradient
    leaf, then one train step (AdamW) on each."""
    import importlib
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    rec = importlib.import_module("chip_smoke")._train_smoke(arch, 0)
    assert rec["ok"], rec


@pytest.mark.parametrize("bucket,k", [(64, 10), (8192, 10), (8192, 128),
                                      (131072, 10), (65536, 256)])
@pytest.mark.parametrize("precision", ["f32", "int8", "bf16"])
def test_range_scan_is_one_launch(cuda, precision, bucket, k):
    """For k <= 256 a call is one device launch (torch.profiler: one kernel
    name, range_scan_select, and no more launches than calls; the profiler
    may drop events, never add them), with no sort of a whole chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(bucket + k)
    n = 200_064
    x = torch.as_tensor(rng.standard_normal((n, 128)), device=cuda,
                        dtype=torch.float32)
    data, scale = (x, None) if precision == "f32" else _quantized(x,
                                                                   precision)
    starts = torch.as_tensor(rng.integers(0, n - bucket, 64), device=cuda,
                             dtype=torch.int32)
    lens = torch.full((64,), bucket, device=cuda, dtype=torch.int32)
    qv = torch.as_tensor(rng.standard_normal((64, 128)), device=cuda,
                         dtype=torch.float32)
    call = lambda: ops.range_scan(data, starts, lens, qv, bucket=bucket, k=k,
                                  scale=scale)
    _same(call(), ref.range_scan_ref(data, starts, lens, qv, bucket=bucket,
                                     k=k, scale=scale),
          atol=1e-2 if precision == "f32" else 0.1)
    torch.cuda.synchronize()
    calls = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        time.sleep(PROFILER_LEAD_S)
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    dev = [e for e in p.key_averages()
           if e.device_type == DeviceType.CUDA and e.count]
    assert len(dev) == 1 and "range_scan_select" in dev[0].key, \
        [e.key for e in dev]
    assert 1 <= dev[0].count <= calls


@pytest.mark.parametrize("m", [1, 64, 128, 512, 4096, 30000])
@pytest.mark.parametrize("d", [128, 130])
def test_gather_rerank_is_one_launch(cuda, m, d):
    """For k <= 256 a call is one device launch at every M, with 16-byte
    (d = 128) or scalar (d = 130) row loads: torch.profiler sees one kernel
    name, gather_rerank_select, and no more launches than calls (the
    profiler may drop events, never add them).  It sits beside
    test_range_scan_is_one_launch, after the end-to-end tests: sessions
    taken before their many launches left the later sessions of the
    process recording no kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(m + d)
    n = 50000
    x = torch.as_tensor(rng.standard_normal((n, d)), device=cuda,
                        dtype=torch.float32)
    ids = rng.integers(0, n, (64, m))
    ids[rng.random((64, m)) < 0.1] = -1
    ids = torch.as_tensor(ids.astype(np.int32), device=cuda)
    qv = torch.as_tensor(rng.standard_normal((64, d)), device=cuda,
                         dtype=torch.float32)
    for k in (1, 10, 256):
        call = lambda: ops.gather_rerank(x, ids, qv, k=k)
        _same(call(), ref.gather_rerank_ref(x, ids, qv, k=k))
        torch.cuda.synchronize()
        calls = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            time.sleep(PROFILER_LEAD_S)
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        dev = [e for e in p.key_averages()
               if e.device_type == DeviceType.CUDA and e.count]
        assert len(dev) == 1 and "gather_rerank_select" in dev[0].key, \
            [e.key for e in dev]
        assert 1 <= dev[0].count <= calls


@pytest.mark.parametrize("d", [1, 3, 127, 130, 515])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2dist_ragged_tiles_match_plain(cuda, d, dtype):
    """Q and N in {1, 127, 129, 4097} around the 128 x 128 tile at every d:
    the reference test's tolerance, never negative."""
    rng = np.random.default_rng(d)
    tol = (1e-3 if dtype == torch.float32 else 0.15) * max(1.0, d / 64)
    for q in (1, 127, 129, 4097):
        for n in (1, 127, 129, 4097):
            a = torch.as_tensor(rng.standard_normal((q, d)),
                                device=cuda).to(dtype)
            b = torch.as_tensor(rng.standard_normal((n, d)),
                                device=cuda).to(dtype)
            got = ops.l2dist(a, b)
            assert got.shape == (q, n)
            err = float((got - ref.l2dist_ref(a, b)).abs().max())
            assert err < tol, (q, n, d, err)
            assert bool((got >= 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2dist_misaligned_views_match_plain(cuda, dtype):
    """Views that start off a 16-byte boundary take the kernel's scalar
    loads: ``x[1:]`` of a d = 3 tensor, and d = 128 rows one element into
    a flat buffer."""
    rng = np.random.default_rng(1)
    for d, q, n in ((3, 300, 1000), (128, 200, 700)):
        qa = torch.as_tensor(rng.standard_normal(q * d + 1),
                             device=cuda).to(dtype)[1:].view(q, d)
        xa = torch.as_tensor(rng.standard_normal((n + 1, d)),
                             device=cuda).to(dtype)[1:]
        if d % 4 == 0:
            assert qa.data_ptr() % 16 and xa.data_ptr() % 16 == 0
        got = ops.l2dist(qa, xa)
        tol = (1e-3 if dtype == torch.float32 else 0.15) * max(1.0, d / 64)
        assert float((got - ref.l2dist_ref(qa, xa)).abs().max()) < tol


def test_l2dist_past_one_grid_of_tiles(cuda):
    """N past 65,535 column tiles of 128 (the grid's y extent) takes a
    second launch for the rest: every column still matches the plain
    version, the last tile's ragged edge included; one counted call."""
    n = 65535 * 128 + 300
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.standard_normal((3, 5)), device=cuda,
                        dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((n, 5)), device=cuda,
                        dtype=torch.float32)
    ops.reset_launches()
    got = ops.l2dist(a, b)
    assert ops.LAUNCHES["l2dist.f32"] == 1
    assert got.shape == (3, n)
    assert float((got - ref.l2dist_ref(a, b)).abs().max()) < 1e-3
    assert bool((got >= 0).all())


def test_baselines_end_to_end_on_card(cuda):
    """The benchmark's five methods built on the card: the segment tree's
    block KNN launches l2dist, no baseline launches a gather kernel, and
    brute force returns the ground truth."""
    from benchmarks.common_torch import build_methods, gt_for, workloads
    from repro_torch.data.ann import make_attrs, make_vectors
    n, d = 3000, 32
    v, a = make_vectors(n, d, seed=0), make_attrs(n, seed=0)
    qv = make_vectors(40, d, seed=91)
    ops.reset_launches()
    methods = build_methods(v, a, True, cuda)
    assert ops.LAUNCHES["l2dist.f32"] > 0
    for ranges in workloads(a, 40).values():
        gt = gt_for(v, a, qv, ranges, 10, cuda)
        for name, ix in methods.items():
            ids = ix.search(qv, ranges, k=10, ef=32)[0]
            assert ids.shape == (40, 10)
            if name == "brute":
                assert np.array_equal(ids, gt)
    assert not any(c for name, c in ops.LAUNCHES.items()
                   if name.startswith("gather"))


#: (bw, ef, early_stop, precision, multi-entry) of the fused beam's card
#: test: the CPU model's grid (tests/test_torch_beam_fused.py) and the exact
#: phase's ef = n = 4096 at bw 1 and 4
BEAM_CASES = ([(bw, ef, True, p, mu) for bw in (1, 2, 4, 8)
               for ef in (8, 64, 256) for p in ("f32", "int8", "bf16")
               for mu in (False, True)]
              + [(bw, ef, False, "f32", mu) for bw in (1, 2, 4, 8)
                 for ef in (8, 64) for mu in (False, True)]
              + [(1, 256, False, "bf16", True), (1, 4096, True, "f32", False),
                 (4, 4096, True, "f32", True)])


def _beam_inputs(cuda, precision, multi, n=4096, d=32, q=128, m=24):
    """A random graph (pads, duplicate ids in rows), queries and ranges of
    every width, a lane with lo > hi, and the corpus the beam scores."""
    from repro_torch.kernels.quantize import quantize_corpus
    rng = np.random.default_rng(17)
    x = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    nbrs = rng.integers(0, n, (n, m)).astype(np.int32)
    nbrs[rng.random((n, m)) < 0.15] = -1
    dup = rng.integers(0, n, 300)
    nbrs[dup, 3] = nbrs[dup, 1]
    lo = rng.integers(0, n, q)
    hi = np.minimum(lo + (n >> rng.integers(0, 10, q)), n - 1)
    lo[5], hi[5] = 300, 299
    entry = np.stack([(lo + hi) // 2, lo, hi], 1).clip(0, n - 1)
    entry[::7, 1] = -1
    if not multi:
        entry = entry[:, 0]
    scale = None
    if precision != "f32":
        qc = quantize_corpus(x, precision)
        x, scale = qc.data, qc.scale
        scale = None if scale is None else scale.to(cuda)
    qv = torch.as_tensor(rng.standard_normal((q, d)), dtype=torch.float32)
    t = lambda a: torch.as_tensor(a, device=cuda)
    return (x.to(cuda), scale, t(nbrs), qv.to(cuda), t(lo), t(hi), t(entry))


@pytest.mark.parametrize(
    "bw,ef,early_stop,precision,multi", BEAM_CASES,
    ids=[f"bw{c[0]}-ef{c[1]}-{'stop' if c[2] else 'cap'}-{c[3]}-"
         f"entry{3 if c[4] else 1}" for c in BEAM_CASES])
def test_fused_beam_matches_lockstep_loop(cuda, bw, ef, early_stop,
                                          precision, multi):
    """One launch of beam_single / beam_batched against the plain loop on
    the same card tensors: hops and ndist equal on >= 99 % of lanes, and
    the final pools' finite top-10 equal there up to near-ties (the kernel
    sums a row in another order than torch)."""
    from repro_torch.kernels import ref
    args = _beam_inputs(cuda, precision, multi)
    kw = dict(ef=ef, steps_cap=8 * ef + 64, early_stop=early_stop)
    name = "beam_batched" if bw > 1 else "beam_single"
    if bw > 1:
        kw["beam_width"] = bw
    ops.reset_launches()
    got = getattr(ops, name)(*args, **kw)
    assert ops.LAUNCHES[f"{name}.{ops.DTYPE_NAMES[args[0].dtype]}"] == 1
    want = getattr(ref, f"{name}_ref")(*args, **kw)
    same = ((got[2] == want[2]) & (got[3] == want[3])).cpu().numpy()
    assert same.mean() >= 0.99, np.flatnonzero(~same)
    k = min(10, ef)
    rows = torch.as_tensor(np.flatnonzero(same), device=cuda)
    pick = lambda t: t[rows][:, :k]
    gd, wd = pick(got[0]), pick(want[0])
    gi = torch.where(torch.isfinite(gd), pick(got[1]), -1)
    wi = torch.where(torch.isfinite(wd), pick(want[1]), -1)
    _same((gi, gd), (wi, wd))


def test_fused_beam_pool_in_global_memory(cuda):
    """An ef whose pool does not fit shared memory beside the rest of the
    block's state runs in the same kernel with the pool in a global
    scratch row, and matches the lockstep loop."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.beam import beam_plan
    ef = 13_000
    assert beam_plan(ef, 24, 1, 32).pool_global
    args = _beam_inputs(cuda, "f32", False, q=16)
    kw = dict(ef=ef, steps_cap=8 * ef + 64, early_stop=True)
    got = ops.beam_single(*args, **kw)
    want = ref.beam_single_ref(*args, **kw)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    _same((torch.where(torch.isfinite(got[0]), got[1], -1)[:, :10],
           got[0][:, :10]),
          (torch.where(torch.isfinite(want[0]), want[1], -1)[:, :10],
           want[0][:, :10]))


def test_fused_beam_refuses_state_beyond_every_plan(cuda):
    """A block state that fits no plan (here a query row of 40,000 floats
    beside its scale) is refused before any launch, with ValueError, and
    counts nothing."""
    n, d = 64, 40_000
    x = torch.zeros((n, d), device=cuda)
    nbrs = torch.zeros((n, 8), dtype=torch.int32, device=cuda)
    qv = torch.zeros((2, d), device=cuda)
    lo = torch.zeros(2, dtype=torch.long, device=cuda)
    ops.reset_launches()
    with pytest.raises(ValueError):
        ops.beam_single(x, None, nbrs, qv, lo, lo + n - 1, lo, ef=64,
                        steps_cap=576, early_stop=True)
    assert not any(ops.LAUNCHES.values())

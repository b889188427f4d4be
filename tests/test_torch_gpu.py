"""On the card: each hand-written kernel against its plain PyTorch version
(f32, int8 and bf16 corpora; the f32 rerank at every M and k; l2dist), the
quantized corpus against the CPU's bit for bit, and the slices end to end
(the benchmark's baselines included).  Marked
``gpu``; every test skips (inside the ``cuda`` fixture) where no card is
present.  Run on the card with ``pytest -m gpu tests/test_torch_*.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


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
                                 (9000, 3000)])
def test_gather_rerank_kernel_matches_plain(cuda, m, k):
    """Every M (past one block's tile) and every k (past 128, and past the
    shared-memory running best), masked entries and an all-masked row."""
    from repro_torch.kernels.quantize import sort_candidates
    rng = np.random.default_rng(m + k)
    x = torch.as_tensor(rng.standard_normal((50000, 128)), device=cuda,
                        dtype=torch.float32)
    ids = torch.as_tensor(rng.integers(0, 50000, (8, m)), device=cuda)
    ids = torch.where(torch.as_tensor(rng.random((8, m)) < 0.2,
                                      device=cuda), -1, ids)
    ids[1] = -1
    ids = sort_candidates(ids)
    qv = torch.as_tensor(rng.standard_normal((8, 128)), device=cuda,
                         dtype=torch.float32)
    ops.reset_launches()
    got = ops.gather_rerank(x, ids, qv, k=k)
    assert ops.LAUNCHES["gather_rerank"] == 1
    _same(got, ref.gather_rerank_ref(x, ids, qv, k=k))


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
    assert all(c > 0 for name, c in ops.LAUNCHES.items()
               if not name.startswith("l2dist")), ops.LAUNCHES
    assert not any(ops.LAUNCHES[f"l2dist.{dt}"] for dt in ("f32", "bf16"))


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

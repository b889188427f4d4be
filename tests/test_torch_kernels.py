"""The port's plain kernel versions against the reference's Pallas kernels.

The same numpy inputs go through ``repro.kernels.ops`` (Pallas in interpret
mode on the CPU) and ``repro_torch.kernels.ops`` (the plain PyTorch version
for CPU tensors).  Ids must be equal; distances agree within
rtol=1e-4, atol=1e-4·max(1, max‖x‖²): the expansion form cancels, and XLA
and torch sum in different orders."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

RNG = np.random.default_rng(0)


def _close(got_d, ref_d, x):
    got_d, ref_d = np.asarray(got_d), np.asarray(ref_d)
    fin = np.isfinite(ref_d)
    assert np.array_equal(fin, np.isfinite(got_d))
    atol = 1e-4 * max(1.0, float(np.max(np.sum(np.square(x), axis=-1))))
    assert np.allclose(got_d[fin], ref_d[fin], rtol=1e-4, atol=atol)


def _padded(n, d, seed=0, tb=128):
    rng = np.random.default_rng(seed)
    n_pad = -(-n // tb) * tb
    d_pad = -(-d // 128) * 128
    xp = np.zeros((n_pad, d_pad), np.float32)
    xp[:n, :d] = rng.standard_normal((n, d)).astype(np.float32)
    return xp


def _windows(n, q, bucket, rng):
    starts = rng.integers(0, n, q).astype(np.int32)
    lens = np.minimum(rng.integers(0, bucket + 1, q), n - starts).astype(np.int32)
    lens[0] = 0                                    # empty window
    starts[1], lens[1] = n - 1, 1                  # tail, one row
    starts[2] = 130                                # unaligned start
    lens[2] = min(bucket, n - 130)
    return starts, lens


def _queries(q, d, d_pad, rng):
    qv = np.zeros((q, d_pad), np.float32)
    qv[:, :d] = rng.standard_normal((q, d)).astype(np.float32)
    return qv


def _range_scan_both(xp, starts, lens, qv, **kw):
    live = kw.pop("live", None)
    ri, rd = jops.range_scan(jnp.asarray(xp), jnp.asarray(starts),
                             jnp.asarray(lens), jnp.asarray(qv),
                             live=None if live is None else jnp.asarray(live),
                             **kw)
    ti, td = tops.range_scan(torch.as_tensor(xp), torch.as_tensor(starts),
                             torch.as_tensor(lens), torch.as_tensor(qv),
                             live=None if live is None
                             else torch.as_tensor(live), **kw)
    return (np.asarray(ri), np.asarray(rd)), (ti.numpy(), td.numpy())


@pytest.mark.parametrize("bucket", [64, 128, 512])
def test_range_scan_matches_reference(bucket):
    """Unaligned starts, empty and one-row windows, windows clipped at n."""
    n, d, q = 900, 40, 9
    rng = np.random.default_rng(bucket)
    xp = _padded(n, d)
    starts, lens = _windows(n, q, bucket, rng)
    qv = _queries(q, d, xp.shape[1], rng)
    (ri, rd), (ti, td) = _range_scan_both(xp, starts, lens, qv,
                                          bucket=bucket, k=5)
    assert np.array_equal(ti, ri)
    _close(td, rd, xp)


@pytest.mark.parametrize("case", ["n_valid", "live", "k128", "k200"])
def test_range_scan_masks_and_wide_k(case):
    """n_valid tails, live masks, k at the 128-lane row and beyond it
    (where the reference falls back to its materialising oracle)."""
    n, d, q, bucket = 700, 24, 6, 512
    rng = np.random.default_rng(3)
    xp = _padded(n, d, seed=3)
    starts, lens = _windows(n, q, bucket, rng)
    qv = _queries(q, d, xp.shape[1], rng)
    kw = dict(bucket=bucket, k=10)
    if case == "n_valid":
        starts[3], lens[3] = 600, 300               # runs past n_valid
        kw["n_valid"] = 650
    elif case == "live":
        live = (rng.random((1, xp.shape[0])) < 0.6).astype(np.int32)
        kw["live"] = live
    else:
        kw["k"] = int(case[1:])
    (ri, rd), (ti, td) = _range_scan_both(xp, starts, lens, qv, **kw)
    assert np.array_equal(ti, ri)
    _close(td, rd, xp)
    if case == "n_valid":
        assert ti.max() < 650


def test_range_scan_ties_go_to_lower_rank():
    """Duplicated rows give equal distances: the lower rank wins, as the
    Pallas kernel's in-order fold gives."""
    xp = _padded(256, 8, seed=5)
    xp[100:140] = xp[60:100]                     # 40 duplicate rows
    rng = np.random.default_rng(5)
    qv = _queries(3, 8, 128, rng)
    starts = np.asarray([50, 60, 0], np.int32)
    lens = np.asarray([100, 80, 256], np.int32)
    (ri, rd), (ti, td) = _range_scan_both(xp, starts, lens, qv,
                                          bucket=256, k=12)
    assert np.array_equal(ti, ri)
    _close(td, rd, xp)


@pytest.mark.parametrize("n,m,d", [(50, 8, 16), (1000, 32, 64), (77, 5, 130),
                                   (8, 64, 256)])
def test_gather_dist_matches_reference(n, m, d):
    """Batched (Q, M) ids including out-of-range ones, which both clip."""
    q = 3
    x = RNG.standard_normal((n, d)).astype(np.float32)
    ids = RNG.integers(-2, n + 2, (q, m)).astype(np.int32)
    qv = RNG.standard_normal((q, d)).astype(np.float32)
    got = tops.gather_dist(torch.as_tensor(x), torch.as_tensor(ids),
                           torch.as_tensor(qv)).numpy()
    want = np.stack([np.asarray(jops.gather_dist(
        jnp.asarray(x), jnp.asarray(ids[i]), jnp.asarray(qv[i])))
        for i in range(q)])
    assert got.shape == (q, m)
    _close(got, want, x)


@pytest.mark.parametrize("n,m,d,k", [
    (50, 8, 16, 5), (1000, 32, 64, 10), (77, 5, 130, 8), (8, 64, 256, 3),
    (200, 1, 7, 4), (128, 200, 32, 10), (300, 130, 24, 128),
])
def test_gather_topk_matches_reference(n, m, d, k):
    """Masked ids never enter; ascending distance, ties toward the lower
    input position; (-1, +inf) pads, also when M < k."""
    q = 2
    x = RNG.standard_normal((n, d)).astype(np.float32)
    ids = RNG.integers(0, n, (q, m)).astype(np.int32)
    ids = np.where(RNG.random((q, m)) < 0.3, -1, ids).astype(np.int32)
    qv = RNG.standard_normal((q, d)).astype(np.float32)
    ti, td = tops.gather_topk(torch.as_tensor(x), torch.as_tensor(ids),
                              torch.as_tensor(qv), k=k)
    for i in range(q):
        ri, rd = jops.gather_topk(jnp.asarray(x), jnp.asarray(ids[i]),
                                  jnp.asarray(qv[i]), k=k)
        assert np.array_equal(ti[i].numpy(), np.asarray(ri))
        _close(td[i].numpy(), rd, x)


def test_gather_topk_duplicate_ids_tie_toward_lower_position():
    x = RNG.standard_normal((20, 6)).astype(np.float32)
    ids = np.asarray([[3, 7, 3, 7, 1, 3, -1, 7]], np.int32)
    qv = RNG.standard_normal((1, 6)).astype(np.float32)
    ti, td = tops.gather_topk(torch.as_tensor(x), torch.as_tensor(ids),
                              torch.as_tensor(qv), k=6)
    ri, rd = jops.gather_topk(jnp.asarray(x), jnp.asarray(ids[0]),
                              jnp.asarray(qv[0]), k=6)
    assert np.array_equal(ti[0].numpy(), np.asarray(ri))
    _close(td[0].numpy(), rd, x)


def test_gather_topk_all_masked():
    x = torch.as_tensor(RNG.standard_normal((10, 4)).astype(np.float32))
    gi, gd = tops.gather_topk(x, torch.full((2, 6), -1, dtype=torch.int32),
                              torch.zeros((2, 4)), k=4)
    assert (gi == -1).all() and torch.isinf(gd).all()


def test_gather_topk_rejects_oversized_k():
    """The reference kernel's bound holds on every device."""
    with pytest.raises(ValueError, match="running top-k"):
        tops.gather_topk(torch.zeros((500, 8)),
                         torch.zeros((1, 400), dtype=torch.int32),
                         torch.zeros((1, 8)), k=200)


def test_wrappers_count_no_launch_on_cpu():
    tops.reset_launches()
    x = torch.zeros((128, 128))
    tops.range_scan(x, torch.zeros(1, dtype=torch.int32),
                    torch.ones(1, dtype=torch.int32), torch.zeros((1, 128)),
                    bucket=64, k=1)
    tops.gather_dist(x, torch.zeros((1, 2), dtype=torch.int32),
                     torch.zeros((1, 128)))
    assert all(v == 0 for v in tops.LAUNCHES.values())

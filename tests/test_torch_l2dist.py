"""The port's ``l2dist`` (its plain version, on the CPU) against the
reference's Pallas ``l2dist`` (interpret mode) and ``l2dist_ref``, over the
reference test's shapes, dtypes and tolerances; and the CUDA wrapper's
argument checks, which run before any launch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.kernels.ops import l2dist as jl2dist
from repro.kernels.ref import l2dist_ref as jl2dist_ref
from repro_torch.kernels import ops
from repro_torch.kernels.l2dist import l2dist_cuda
from repro_torch.kernels.ref import l2dist_ref

RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small torch ops, and with
    the test workers sharing the cores, more threads only add waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(q, n, d, dtype, rng=RNG):
    """The same inputs for both packages: drawn in numpy, rounded to the
    dtype by JAX, carried to torch exactly (bf16 values are f32-exact)."""
    a = jnp.asarray(rng.standard_normal((q, d)), dtype)
    b = jnp.asarray(rng.standard_normal((n, d)), dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    ta = torch.tensor(np.asarray(a, np.float32)).to(tdt)
    tb = torch.tensor(np.asarray(b, np.float32)).to(tdt)
    return a, b, ta, tb


@pytest.mark.parametrize("q,n,d", [
    (1, 1, 1), (4, 7, 3), (128, 128, 128), (128, 256, 64),
    (100, 300, 130), (257, 129, 515), (33, 1000, 96),
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_l2dist_matches_reference(q, n, d, dtype):
    """Max abs error within the reference test's tolerance,
    1e-3·max(1, d/64) (f32) or 0.15·max(1, d/64) (bf16), against both the
    Pallas kernel and the reference's plain version; never negative."""
    a, b, ta, tb = _pair(q, n, d, dtype)
    got = ops.l2dist(ta, tb)
    assert got.shape == (q, n) and got.dtype == torch.float32
    got = got.numpy()
    tol = (1e-3 if dtype == jnp.float32 else 0.15) * max(1.0, d / 64)
    for want in (np.asarray(jl2dist(a, b)), np.asarray(jl2dist_ref(a, b))):
        assert float(np.max(np.abs(got - want))) < tol
    assert (got >= 0).all()


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 40), st.integers(1, 40), st.integers(1, 70),
       st.integers(0, 2**31 - 1))
def test_l2dist_property(q, n, d, seed):
    """Against the float64 distances of the same f32 inputs (a numpy
    oracle: no JAX compile per drawn shape)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((q, d)).astype(np.float32)
    b = rng.standard_normal((n, d)).astype(np.float32)
    got = ops.l2dist(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = ((a[:, None, :].astype(np.float64) - b[None]) ** 2).sum(-1)
    assert got.shape == want.shape
    assert np.allclose(got, want, rtol=1e-3, atol=1e-3)
    assert (got >= 0).all()


def test_l2dist_zero_distance_on_identical_rows():
    x = torch.as_tensor(RNG.standard_normal((32, 48)), dtype=torch.float32)
    dmat = ops.l2dist(x, x).numpy()
    assert np.allclose(np.diag(dmat), 0.0, atol=1e-4)
    assert np.array_equal(dmat, l2dist_ref(x, x).numpy())


def test_l2dist_counts_no_launch_on_the_cpu():
    ops.reset_launches()
    x = torch.ones((5, 3))
    ops.l2dist(x, x)
    ops.l2dist(x.to(torch.bfloat16), x.to(torch.bfloat16))
    assert not any(ops.LAUNCHES.values())
    assert {"l2dist.f32", "l2dist.bf16"} <= set(ops.LAUNCHES)


@pytest.mark.parametrize("q,x,match", [
    (torch.zeros(3, 4), torch.zeros(5, 3), "expected q"),
    (torch.zeros(3, 4), torch.zeros(5, 4, dtype=torch.bfloat16), "one dtype"),
    (torch.zeros(3, 4, dtype=torch.int8), torch.zeros(5, 4, dtype=torch.int8),
     "one dtype"),
    (torch.zeros(4), torch.zeros(5, 4), "expected q"),
])
def test_l2dist_cuda_refuses_what_the_kernel_does_not_take(q, x, match):
    with pytest.raises(ValueError, match=match):
        l2dist_cuda(q, x)

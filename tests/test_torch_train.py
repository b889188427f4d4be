"""The port's training half against the reference's: the cross entropy,
``Model.loss`` and its gradients for all ten architectures at their smoke
configs, remat modes, the chunked CE, and the hand-written optimizer.

Parameters come from the reference's ``Model.init`` and cross into the port
through ``params_from_reference``; batches are the reference's
``concrete_batch``.  Tolerances:

* f32 (every arch): the loss within 1e-5 absolute, each gradient leaf
  within 1e-4 · max(1, max |g|) of the reference's (``jax.value_and_grad``)
  — the packages sum in another order, nothing else differs.
* remat ``none`` / ``dots`` / ``full`` and ``remat_group`` 1 / 2: the
  gradients bit-equal (the recompute gives the same numbers).
* the optimizer: per element within 1 ulp of the leaf's dtype of the
  reference's eager ``adamw_update`` / ``clip_by_global_norm`` (``b ** step``
  is a ``pow`` of each library's own); the schedule bit-equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.launch.specs import concrete_batch as ref_batch
from repro.models.layers import cross_entropy as ref_ce
from repro.models.lm import Model as RefModel
from repro.training import optim as ref_optim
from repro_torch.configs.registry import get_smoke_config, list_archs
from repro_torch.models.layers import cross_entropy
from repro_torch.models.lm import Model
from repro_torch.models.params import params_from_reference
from repro_torch.training import optim
from repro_torch.training.tree import (leaves_with_path, path_key,
                                       unflatten_like)

B, S = 2, 32
#: one architecture per family
FAMILY_ARCHS = ["llama3-8b", "mixtral-8x7b", "mamba2-780m",
                "jamba-1.5-large-398b", "seamless-m4t-large-v2",
                "llama-3.2-vision-11b"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small torch ops, and with
    the test workers sharing the cores, more threads only add waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        p = f"{pre}/{k}" if pre else k
        out.update(_flat(v, p) if isinstance(v, dict)
                   else {p: np.asarray(v, np.float32)})
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's ``Model.init`` of the f32 smoke config."""
    cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    return RefModel(cfg).init(jax.random.key(1))


def _batch(cfg):
    return ref_batch(cfg, "train", B, S, np.random.default_rng(0))


def _to_port(batch):
    """Host batch → tensors; a bf16 array crosses as f32, then narrows."""
    return {k: torch.from_numpy(np.array(v)) if v.dtype == jnp.int32 else
            torch.from_numpy(np.array(v, np.float32)).to(
                torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
            for k, v in batch.items()}


def _ref_loss_grads(cfg, params, batch, opts=None):
    ref = RefModel(cfg, opts=opts)
    (loss, m), g = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        params, batch)
    return float(loss), {k: float(v) for k, v in m.items()}, _flat(g)


def port_loss_grads(cfg, flat, batch, opts=None, mesh=None, of=None):
    """The port's (loss, metrics, {path: f32 gradient}) on parameters given
    as host arrays under the reference's paths; the gradient of the total
    loss, or of the metric ``of``."""
    model = Model(cfg, device="cpu", opts=opts, mesh=mesh)
    tree = params_from_reference(flat, cfg, "cpu")
    items = list(leaves_with_path(tree))
    req = [p.detach().requires_grad_() for _, p in items]
    loss, m = model.loss(unflatten_like(tree, req), batch)
    grads = torch.autograd.grad(loss if of is None else m[of], req,
                                allow_unused=True)
    return (float(loss.detach()), {k: float(v.detach()) for k, v in m.items()},
            {path_key(p): (np.zeros(t.shape, np.float32) if g is None
                           else g.float().numpy())
             for (p, t), g in zip(items, grads)})


def _close_grads(got, want, tol=1e-4):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = float(np.max(np.abs(got[k] - want[k]), initial=0.0))
        assert err <= tol * max(1.0, float(np.max(np.abs(want[k]),
                                                  initial=0.0))), (k, err)


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    """A padded vocab (33 of 40 real), labels in range, an optional mask:
    value and gradient; padded columns get a gradient of exactly 0."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 33, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32) if masked else None
    f = lambda lg: ref_ce(lg, jnp.asarray(labels), 33,  # noqa: E731
                          None if mask is None else jnp.asarray(mask))
    want, gwant = jax.value_and_grad(f)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy(lt, torch.from_numpy(labels), 33,
                        None if mask is None else torch.from_numpy(mask))
    (g,) = torch.autograd.grad(got, lt)
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    np.testing.assert_allclose(g.numpy(), np.asarray(gwant), atol=1e-7)
    assert not g[..., 33:].any()


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_grads_match_reference_f32(arch):
    cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    batch = _batch(cfg)
    want = _ref_loss_grads(cfg, _ref_params(arch), batch)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    got = port_loss_grads(tcfg, _flat(_ref_params(arch)), _to_port(batch))
    assert abs(got[0] - want[0]) <= 1e-5, (got[0], want[0])
    for k in ("loss", "aux"):
        assert abs(got[1][k] - want[1][k]) <= 1e-5, k
    _close_grads(got[2], want[2])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("remat,group", [("dots", 1), ("full", 1),
                                         ("full", 2), ("none", 2),
                                         ("dots", 2)])
def test_remat_modes_bit_equal(arch, remat, group):
    """Checkpointing recomputes, it never changes a number: the loss and
    every gradient under (remat, remat_group) equal those of (none, 1)."""
    base = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    flat = _flat(_ref_params(arch))
    batch = _to_port(_batch(dataclasses.replace(ref_smoke(arch),
                                                dtype="float32")))
    want = port_loss_grads(dataclasses.replace(base, remat="none"), flat,
                           batch, opts={"remat_group": 1})
    got = port_loss_grads(dataclasses.replace(base, remat=remat), flat,
                          batch, opts={"remat_group": group})
    assert got[0] == want[0]
    for k in want[2]:
        assert np.array_equal(got[2][k], want[2][k]), k


def test_chunked_ce_pads_the_last_chunk():
    """ce_chunk 24 over 32 positions: the last chunk is padded with label
    -1, which the loss does not score; equal to the reference's run with
    the same chunk, and to the port's unchunked loss within f32 rounding."""
    arch = "qwen1.5-4b"
    cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    batch = _batch(cfg)
    want = _ref_loss_grads(cfg, _ref_params(arch), batch, {"ce_chunk": 24})
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    got = port_loss_grads(tcfg, _flat(_ref_params(arch)), _to_port(batch),
                          {"ce_chunk": 24})
    whole = port_loss_grads(tcfg, _flat(_ref_params(arch)), _to_port(batch))
    assert abs(got[0] - want[0]) <= 1e-5
    _close_grads(got[2], want[2])
    assert abs(got[0] - whole[0]) <= 1e-5
    _close_grads(got[2], whole[2], tol=1e-5)


# ---------------------------------------------------------------- optimizer
def _tree(seed):
    """A mixed-dtype tree: f32 and bf16 matrices, a group-stacked (G, D)
    norm scale, a stacked (G, D, F) weight, an f32 vector."""
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"norm": ((3, 8), "bfloat16"),
                         "w": ((3, 8, 5), "bfloat16")},
              "embed": ((11, 8), "float32"), "final_norm": ((8,), "float32"),
              "head": ((8, 11), "bfloat16")}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        shape, dt = node
        return rng.standard_normal(shape).astype(np.float32), dt
    return build(shapes)


def _jnp(tree):
    return jax.tree.map(lambda a: jnp.asarray(a[0], a[1]), tree,
                        is_leaf=lambda x: isinstance(x, tuple))


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(a[0]).to(
        getattr(torch, a[1])), tree, is_leaf=lambda x: isinstance(x, tuple))


def _ulps_close(got, want, ulps=1):
    """Element-wise within ``ulps`` units in the last place of want's
    dtype."""
    for (path, g), w in zip(leaves_with_path(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        eps = float(jnp.finfo(w.dtype).eps)
        wf = w.astype(np.float32)
        gf = g.float().numpy()
        assert np.all(np.abs(gf - wf) <= ulps * eps * np.maximum(
            np.abs(wf), np.float32(jnp.finfo(w.dtype).tiny))), path


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Scaled (0.5) and untouched (1e3) gradient trees of mixed dtypes."""
    g = _tree(1)
    want, gn_want = ref_optim.clip_by_global_norm(_jnp(g), max_norm)
    got, gn = optim.clip_by_global_norm(_torch(g), max_norm)
    assert abs(float(gn) - float(gn_want)) <= 1e-6 * float(gn_want)
    _ulps_close(got, want)
    assert all(t.dtype == getattr(torch, str(np.asarray(w).dtype))
               for t, w in zip(optim.leaves(got), jax.tree.leaves(want)))


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(opt_dtype):
    """Three updates of a mixed-dtype tree with moments of ``opt_dtype``;
    weight decay on every leaf of ndim >= 2 (the stacked norm scale too)."""
    p_r, p_t = _jnp(_tree(2)), _torch(_tree(2))
    o_r = ref_optim.adamw_init(p_r, opt_dtype)
    o_t = optim.adamw_init(p_t, opt_dtype)
    for step in range(3):
        g = _tree(10 + step)
        lr = 1e-2 * (step + 1)
        p_r, o_r = ref_optim.adamw_update(p_r, _jnp(g), o_r,
                                          jnp.float32(lr))
        p_t, o_t = optim.adamw_update(p_t, _torch(g), o_t,
                                      torch.tensor(lr, dtype=torch.float32))
        _ulps_close(p_t, p_r)
        _ulps_close(o_t["m"], o_r["m"])
        _ulps_close(o_t["v"], o_r["v"])
        assert int(o_t["step"]) == int(o_r["step"]) == step + 1
        assert o_t["step"].dtype == torch.int32
    # the stacked (G, D) norm scale moved by its weight decay as well
    assert not np.array_equal(p_t["blocks"]["norm"].float().numpy(),
                              _tree(2)["blocks"]["norm"][0])


def test_adamw_slices_large_leaves_without_changing_a_bit(monkeypatch):
    """A leaf past SLICE elements is updated a slice of rows at a time:
    the same bits as the whole-leaf update."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.standard_normal((7, 6, 5)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((7, 6, 5)).astype(np.float32))
    runs = []
    for cap in (1 << 26, 64):
        monkeypatch.setattr(optim, "SLICE", cap)
        params = {"w": p.clone().to(torch.bfloat16)}
        opt = optim.adamw_init(params)
        for _ in range(2):
            params, opt = optim.adamw_update(params, {"w": g}, opt, 0.1)
        runs.append((params["w"].clone(), opt["m"]["w"].clone()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("kw", [dict(), dict(base_lr=3e-3, warmup=10,
                                            total=100),
                                dict(base_lr=1e-3, warmup=0, total=7,
                                     min_frac=0.0)])
def test_cosine_schedule_matches_reference(kw):
    """0 at step 0 (warm-up), the warm-up ramp, the cosine and its floor."""
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150, 20000):
        want = ref_optim.cosine_schedule(jnp.asarray(step, jnp.int32), **kw)
        got = optim.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                    **kw)
        assert got.dtype == torch.float32
        assert float(got) == float(want), (step, float(got), float(want))
        if step == 0 and kw.get("warmup", 100):
            assert float(got) == 0.0

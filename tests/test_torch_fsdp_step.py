"""The FSDP-strategy (ZeRO-3) sharded train step (``parallel/fsdp.py``) on
meshes of CPU shards, against the unsharded step of the same ``Model``.

The reference's own sharded step fails before it runs under jax 0.9
(``tests/test_multidevice.py::test_sharded_train_step_moe_ep``, an
embedding-sharding error), so no sharded JAX run exists to compare with.  Sharding must not change the math, so the oracle is the
port's unsharded ``build_train_step`` — the one ``tests/
test_torch_train_step.py`` holds to the reference's jitted step — with the
same mesh for its MoE, which splits the tokens as the sharded step does.
Cases: the reference test's own (llama4-maverick smoke, batch 8 × 16) and
a dense arch, in f32, on (data, model) meshes of (2, 1), (8, 1) and
(4, 2): loss within 1e-5, and every gradient leaf and every parameter and
moment after one AdamW step (rate 1e-2) within 1e-4 · max(1, max |g|) of
the leaf (the shards sum their gradients in another order).  The MoE case
on (4, 2) must run its expert exchange (all-to-all) and the counted
collective bytes must equal the layout's arithmetic; a checkpoint of a
sharded state restores unsharded and back."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.lm import Model
from repro_torch.models.params import numpy_params, params_from_reference
from repro_torch.parallel.fsdp import (StateLayout, build_sharded_train_step,
                                       shard_state, unshard_state)
from repro_torch.parallel.sharding import (FSDP_RULES, CollectiveCounter,
                                           make_act_sharder, make_mesh)
from repro_torch.training.optim import adamw_init
from repro_torch.training.train_step import build_train_step
from repro_torch.training.tree import leaves, leaves_with_path, path_key

CASES = [("llama4-maverick-400b-a17b", 2, 1), ("llama4-maverick-400b-a17b", 8, 1),
         ("llama4-maverick-400b-a17b", 4, 2), ("qwen1.5-4b", 2, 1),
         ("qwen1.5-4b", 8, 1), ("qwen1.5-4b", 4, 2)]
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def _state(cfg):
    p = params_from_reference(numpy_params(cfg, 0), cfg, "cpu")
    return {"params": p, "opt": adamw_init(p, cfg.opt_dtype)}


def _batch(cfg, b=8, s=16):
    rng = np.random.default_rng(0)
    return {k: torch.tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                            dtype=torch.int32) for k in ("tokens", "labels")}


def _sched(step):
    return torch.tensor(LR)


def _unsharded(cfg, mesh, batch):
    """The unsharded step's metrics, gradients and post-step state."""
    model = Model(cfg, device="cpu", mesh=mesh)
    state = _state(cfg)
    grads = {}

    def keep(g):
        grads.update({path_key(p): t.clone() for p, t in leaves_with_path(g)})
        return g
    state, m = build_train_step(model, lr_schedule=_sched,
                                grad_transform=keep)(state, batch)
    return m, grads, state


def _sharded(cfg, mesh, batch, **kw):
    model = Model(cfg, device="cpu",
                  act_shard=make_act_sharder(mesh, FSDP_RULES))
    shards = shard_state(_state(cfg), model, mesh)
    step = build_sharded_train_step(model, mesh, lr_schedule=_sched,
                                    keep_grads=True)
    with CollectiveCounter() as cc:
        shards, m = step(shards, batch)
    lay = StateLayout(model, mesh)
    grads = {path_key(p): t for p, t in leaves_with_path(
        lay.unshard_tree(m.pop("grads")))}
    return m, grads, unshard_state(shards, model, mesh), cc, lay


@pytest.mark.parametrize("arch,data,model", CASES)
def test_sharded_step_equals_the_unsharded_step(arch, data, model):
    cfg = _cfg(arch)
    mesh = make_mesh({"data": data, "model": model}, ["cpu"])
    batch = _batch(cfg)
    m0, g0, s0 = _unsharded(cfg, mesh, batch)
    m1, g1, s1, cc, _ = _sharded(cfg, mesh, batch)
    assert abs(float(m1["loss"]) - float(m0["loss"])) < 1e-5
    assert abs(float(m1["aux"]) - float(m0["aux"])) < 1e-5
    assert abs(float(m1["grad_norm"]) - float(m0["grad_norm"])) < 1e-5
    assert float(m1["lr"]) == float(m0["lr"])
    assert float(m1["step"]) == float(m0["step"]) == 1.0
    assert set(g1) == set(g0)
    for k, want in g0.items():
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        assert float((g1[k] - want.float()).abs().max()) <= tol, k
    for (p, a), (_, b) in zip(leaves_with_path(s1), leaves_with_path(s0)):
        key = path_key(p)
        gk = key.split("/", 2)[-1] if key.startswith("opt/") else \
            key.split("/", 1)[-1]
        tol = 1e-4 * max(1.0, float(g0[gk].abs().max())) if gk in g0 \
            else 0.0
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert float((a.float() - b.float()).abs().max()) <= tol, key
    if arch.startswith("llama4") and model > 1:
        assert cc.calls["all-to-all"] > 0 and cc.bytes["all-to-all"] > 0
    if data * model > 1:
        assert cc.calls["all-gather"] > 0 and cc.calls["reduce-scatter"] > 0


@pytest.mark.parametrize("data,model", [(2, 1), (4, 2)])
def test_counted_bytes_are_the_layouts_arithmetic(data, model):
    """Dense smoke config, no remat: each split leaf is gathered
    once per use (the embedding once, the head once, a stacked leaf once
    per group) with its block as the per-device operand, and its gradient
    reduce-scattered from the full slice; a replicated leaf's gradient is
    all-reduced; the loss's two sums and the clip's squared sum are
    all-reduced as one-element f32 tensors.  A leaf split on two dims is
    gathered dim by dim (the second gather's operand is the first's
    result) and reduce-scattered back in the reverse order."""
    cfg = _cfg("qwen1.5-4b")
    mesh = make_mesh({"data": data, "model": model}, ["cpu"])
    _, _, _, cc, lay = _sharded(cfg, mesh, _batch(cfg))
    G = Model(cfg, device="meta").dm.groups
    size = lambda e: int(np.prod([mesh.shape[a] for a in  # noqa: E731
                                  ((e,) if isinstance(e, str) else e)]))
    ag = rs = ar = 0
    for path, pl in lay.params.items():
        n = G if path[0] == "blocks" else 1
        full = int(np.prod(pl.shape)) * 4 // n          # f32, one slice
        if pl.gather_dims:
            assert not pl.replicated, path
            sizes = [size(pl.spec[d]) for d in pl.gather_dims]
            cur = full // int(np.prod(sizes))           # the block
            for z in sizes:                             # dim by dim
                ag += n * cur
                cur *= z
            for z in reversed(sizes):
                rs += n * cur
                cur //= z
        else:
            assert pl.replicated == ("data", "model"), path
            ar += n * full
    ar += 3 * 4
    assert cc.bytes["all-gather"] == ag
    assert cc.bytes["reduce-scatter"] == rs
    assert cc.bytes["all-reduce"] == ar
    assert cc.bytes["all-to-all"] == 0 and cc.bytes["collective-permute"] == 0


def test_remat_regathers_inside_the_checkpointed_region():
    """Under remat the recompute gathers each group's weights again, and
    the step's results stay those without remat."""
    base = _cfg("qwen1.5-4b")
    mesh = make_mesh({"data": 2, "model": 1}, ["cpu"])
    batch = _batch(base)
    m0, g0, _, c0, _ = _sharded(base, mesh, batch)
    m1, g1, _, c1, _ = _sharded(dataclasses.replace(base, remat="full"),
                                mesh, batch)
    G = Model(base, device="meta").dm.groups
    n_block = sum(1 for p, pl in StateLayout(Model(base, device="meta"),
                                             mesh).params.items()
                  if p[0] == "blocks" and pl.gather_dims)
    assert c1.calls["all-gather"] - c0.calls["all-gather"] == G * n_block
    assert c1.calls["reduce-scatter"] == c0.calls["reduce-scatter"]
    assert abs(float(m1["loss"]) - float(m0["loss"])) < 1e-6
    for k in g0:
        assert float((g1[k] - g0[k]).abs().max()) <= 1e-6, k


def test_sharded_checkpoints_cross_layouts(tmp_path):
    """A sharded state unsharded into a checkpoint restores to the state it
    came from; an unsharded checkpoint restored and sharded again is the
    same sharded state."""
    cfg = _cfg("llama4-maverick-400b-a17b")
    mesh = make_mesh({"data": 4, "model": 2}, ["cpu"])
    model = Model(cfg, device="cpu")
    state = _state(cfg)
    shards = shard_state(state, model, mesh)
    ckpt = CheckpointManager(str(tmp_path / "a"))
    ckpt.save(1, unshard_state(shards, model, mesh), blocking=True)
    back = ckpt.restore(state)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(state)))
    again = shard_state(back, model, mesh)
    assert all(torch.equal(a, b) for a, b in zip(leaves(again),
                                                 leaves(shards)))
    lay = StateLayout(model, mesh)
    blk = shards[5]["params"]["embed"]
    assert tuple(blk.shape) == tuple(
        n // 1 for n in state["params"]["embed"][lay.block(
            lay.params[("embed",)], 5)].shape)


def test_sharded_step_refuses_moments_apart_from_parameters():
    """On a mesh with a pod axis the ZeRO-1 rules put the moments over
    (pod, data, model) and the parameters over (data, model)."""
    cfg = _cfg("qwen1.5-4b")
    mesh = make_mesh({"pod": 2, "data": 2, "model": 2}, ["cpu"])
    with pytest.raises(NotImplementedError, match="pod"):
        build_sharded_train_step(Model(cfg, device="cpu"), mesh)

"""The TP strategy's train step (``build_sharded_train_step`` under
``DEFAULT_RULES``: ``parallel.tp.TrainHooks`` over the step of
``parallel/fsdp.py``) against the reference's own sharded step, and its
dry-run share, its refusals and its counted collectives.

The oracle (``tests/_torch_train_ref.py``) is the reference's
``jax.jit(build_train_step(model))`` of a ``Model`` built with its mesh and
``make_act_sharder(mesh, DEFAULT_RULES)`` on a ``make_mesh_compat`` mesh of
forced host devices, with its gradients from ``jax.grad`` of
``model.loss`` under the same shardings.  Cases: one arch per family at
(data 4, model 2); the MoE at a dropping capacity at (2, 2) (EP over
``model``) and (1, 8) (4 experts on 8 ranks: replicated experts), where
the per-shard token split decides the drops; llama4-maverick's smoke
config at (4, 2), the case of ``tests/test_multidevice.py::
test_sharded_train_step_moe_ep`` on an Auto mesh, which must run its
expert exchange (all-to-all) forward and backward; and a dense arch with
sequence parallelism.  Loss, aux, gradient norm, every gradient leaf and
every post-step parameter and moment within 1e-4 in f32, over two steps
(the second reads the updated, all-gathered parameters).

Also: a TP train cell of the dry-run counts a train step; the counted
bytes of one step per kind equal the arithmetic from the model's dims; the
dry-run's one-device share counts what the whole mesh moves per device;
a layout the step cannot run raises."""
import json
import math

import numpy as np
import pytest
import torch

from _torch_train_ref import (B, S, assert_close, case_cfg, port_model,
                              run_port, run_reference)
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.models.lm import Model
from repro_torch.models.params import ShardPlan
from repro_torch.parallel.fsdp import StateLayout, build_sharded_train_step
from repro_torch.parallel.sharding import (DEFAULT_RULES, CollectiveCounter,
                                           local_shape, make_act_sharder,
                                           make_mesh, spec_for_logical)
from repro_torch.training.train_step import init_train_state
from repro_torch.training.tree import leaves

D42 = {"data": 4, "model": 2}
#: (arch, axes, strategy, capacity factor or None, sp)
CASES = [("llama3-8b", D42, "tp", None, False),
         ("mixtral-8x7b", D42, "tp", None, False),
         ("mamba2-780m", D42, "tp", None, False),
         ("jamba-1.5-large-398b", D42, "tp", None, False),
         ("seamless-m4t-large-v2", D42, "tp", None, False),
         ("llama-3.2-vision-11b", D42, "tp", None, False),
         ("mixtral-8x7b", {"data": 2, "model": 2}, "tp", 0.5, False),
         ("mixtral-8x7b", {"data": 1, "model": 8}, "tp", 0.5, False),
         ("llama4-maverick-400b-a17b", D42, "tp", None, False),
         ("qwen1.5-4b", D42, "tp", None, True)]


def _id(case):
    arch, axes, _, cf, sp = case
    return (f"{arch}-d{axes['data']}m{axes['model']}"
            + (f"-cf{cf}" if cf else "") + ("-sp" if sp else ""))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small torch ops, cores shared by workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_steps(tmp_path_factory):
    return run_reference(CASES, tmp_path_factory.mktemp("ref_tp_train"),
                         groups=3)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[_id(c) for c in CASES])
def test_tp_step_matches_the_reference_step(case, ref_steps):
    got, counters, lay = run_port(CASES[case])
    assert_close(got, ref_steps[case])
    assert not lay.zero1                  # no pod axis: moments stay put
    for cc in counters:
        assert cc.calls["reduce-scatter"] > 0 and cc.calls["all-reduce"] > 0
        if CASES[case][0].startswith("llama4"):
            # the expert exchange, forward and its adjoint in backward
            assert cc.calls["all-to-all"] >= 4 and cc.bytes["all-to-all"] > 0


# --------------------------------------------------------------- dry-run
def test_dryrun_counts_a_tp_train_cell(tmp_path):
    """A train cell under ``strategy="tp"`` (the ``tp`` variant) counts
    the TP train step: its flops over the chips reach the model's
    6·N·tokens (forward and backward; a decode's would be 2·N·batch) and
    its gradients reduce-scatter, which no serving program does."""
    dryrun.main(["--arch", "qwen1.5-4b", "--shape", "train_4k", "--variant",
                 "tp", "--smoke", "--results", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen1.5-4b__train_4k__pod16x16__tp.json")
                     .read_text())
    assert rec["meta"]["kind"] == "train"
    assert rec["cost"]["flops_per_device"] * rec["chips"] >= \
        rec["model_flops"] > 0
    assert rec["collectives"]["reduce-scatter"] > 0
    assert rec["collectives"]["all-reduce"] > 0       # the row-parallel sums
    cell = dryrun.build_cell("qwen1.5-4b", "decode_32k",
                             make_mesh({"data": 2, "model": 2}, ["meta"]),
                             smoke=True)
    assert cell.strategy == "tp" and cell.shape.kind == "decode"


@pytest.mark.parametrize("arch,axes", [("llama3-8b", {"data": 2, "model": 2}),
                                       ("llama4-maverick-400b-a17b", D42)])
def test_share_counts_what_the_mesh_moves(arch, axes, tmp_path):
    """The dry-run's ``--mesh ... --opt strategy=tp`` count of shard 0's
    share equals, per kind and call, what a full mesh of CPU shards
    running the same step moves per device."""
    cfg = get_smoke_config(arch)
    out = tmp_path / "share.json"
    dryrun.main(["--arch", arch, "--smoke", "--mesh",
                 ",".join(f"{k}={v}" for k, v in axes.items()), "--batch",
                 str(B), "--seq", str(S), "--opt", "strategy=tp", "--json",
                 str(out)])
    share = json.loads(out.read_text())
    mesh = make_mesh(axes, ["cpu"])
    model = Model(cfg, mesh=mesh, device="cpu",
                  act_shard=make_act_sharder(mesh, DEFAULT_RULES))
    shards = StateLayout(model, mesh, DEFAULT_RULES).shard(
        init_train_state(model, torch.Generator().manual_seed(0)))
    with CollectiveCounter() as cc:
        build_sharded_train_step(model, mesh, DEFAULT_RULES)(
            shards, _batch(cfg))
    assert cc.as_dict() == share["collectives"]
    assert cc.calls == share["calls"]
    assert share["param_bytes"] == sum(
        t.numel() * t.element_size() for t in leaves(shards[0]["params"]))


def _batch(cfg):
    rng = np.random.default_rng(0)
    return {k: torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                            dtype=torch.int32) for k in ("tokens", "labels")}


# ------------------------------------------------------ counted collectives
def test_counted_bytes_are_the_dims_arithmetic():
    """llama3-8b's smoke config (bf16, no remat) at (data 2, model 2), one
    step at 8 × 16 (``DEFAULT_RULES`` put the batch over (pod, data),
    which resolves to no split without a pod axis: every shard runs the
    whole batch), per device:

    * all-gather: each leaf's block, split over ``data``, once per use
      (the embedding, the head, a stacked leaf once per group); the CE's
      (max, sum of exponentials) per token, f32, in the forward and in the
      checkpointed slice's recompute;
    * reduce-scatter: the gradient of each gathered leaf (the gathered
      slice, in the leaf's dtype) back to its owners; the adjoint of the
      CE's gather;
    * all-reduce: the gradient of each leaf replicated over the mesh (the
      norms); the embedding's and each row-parallel output's (B/2, S, d)
      partial sums over ``model``, forward and adjoint; the label's logit
      in the forward, the recompute and the adjoint; the loss's two sums,
      the NLL sum's adjoint and the clip's squared sum (f32 scalars)."""
    cfg = get_smoke_config("llama3-8b")
    axes = {"data": 2, "model": 2}
    mesh = make_mesh(axes, ["cpu"])
    model = Model(cfg, mesh=mesh, device="cpu",
                  act_shard=make_act_sharder(mesh, DEFAULT_RULES))
    lay = StateLayout(model, mesh, DEFAULT_RULES)
    shards = lay.shard(init_train_state(model,
                                        torch.Generator().manual_seed(0)))
    with CollectiveCounter() as cc:
        build_sharded_train_step(model, mesh, DEFAULT_RULES)(
            shards, _batch(cfg))
    dm, G, es, M = model.dm, model.dm.groups, 2, 2
    bl = local_shape((B,), spec_for_logical(("batch",), (B,), mesh,
                                            DEFAULT_RULES), mesh)[0]
    assert bl == B
    ag = rs = ar = 0
    for path, pl in lay.params.items():
        n = G if path[0] == "blocks" else 1
        blk = math.prod(local_shape(pl.shape, pl.spec, mesh)) // n * es
        if pl.gather_dims:
            assert [pl.spec[d] for d in pl.gather_dims] == ["data"], path
            assert not pl.replicated, path
            ag += n * blk
            rs += n * blk * axes["data"]
        else:
            assert pl.replicated == ("data", "model"), path
            ar += n * blk
    ar += 2 * (1 + 2 * G) * bl * S * dm.d * es
    st = 2 * bl * S * 4                  # one rank's (max, sum), one slice
    ag += 2 * st
    rs += M * st
    ar += 3 * bl * S * 4
    ar += 4 * 4
    assert cc.bytes["all-gather"] == ag
    assert cc.bytes["reduce-scatter"] == rs
    assert cc.bytes["all-reduce"] == ar
    assert cc.bytes["all-to-all"] == 0 and cc.bytes["collective-permute"] == 0


# ----------------------------------------------------------------- refusals
def test_layouts_the_step_cannot_run_raise():
    """Heads that do not divide the model axis (the unpadded plan's 2 KV
    heads over 4 ranks), a model axis that is not the mesh's last, and a
    model built on another mesh (or none) each raise: nothing falls back
    to the FSDP or the unsharded step."""
    cfg = case_cfg("llama3-8b")
    mesh = make_mesh({"data": 1, "model": 4}, ["cpu"])
    with pytest.raises(ValueError, match="cannot split"):
        build_sharded_train_step(Model(cfg, mesh=mesh, device="cpu"), mesh,
                                 DEFAULT_RULES)
    mesh = make_mesh({"model": 2, "data": 2}, ["cpu"])
    with pytest.raises(NotImplementedError, match="last"):
        build_sharded_train_step(Model(cfg, ShardPlan(tp=2), mesh=mesh,
                                       device="cpu"), mesh, DEFAULT_RULES)
    case = ("llama3-8b", {"data": 2, "model": 2}, "tp", None, False)
    other = make_mesh({"data": 2, "model": 2}, ["meta"])
    for model in (port_model(case), Model(cfg, ShardPlan(tp=2),
                                          device="cpu")):
        with pytest.raises(ValueError, match="mesh"):
            build_sharded_train_step(model, other, DEFAULT_RULES)

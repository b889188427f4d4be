"""Shared by ``tests/test_torch_tp_train.py`` and
``tests/test_torch_zero1_step.py``: the reference's own sharded train step
(run in a subprocess) and the port's sharded step on the same inputs, two
steps each, and the comparison of their losses, gradients and post-step
states.

The reference's step is ``jax.jit(build_train_step(model))`` of a
``Model`` built with its mesh and ``make_act_sharder(mesh, rules)``, its
state placed by ``tree_shardings`` (the moments with their parameters, as
its own sharded-step test places them, or on a pod mesh under the ZeRO-1
rules, ``"fsdp"`` -> ``rules["fsdp+"]``, as its dry-run does), on a
``make_mesh_compat`` mesh of forced host devices (Auto axis types;
XLA_FLAGS must be set before jax is imported, so in one subprocess); its
gradients are ``jax.grad`` of ``model.loss`` jitted under the same
shardings.  The port's parameters come from the same numpy draw through
``params_from_reference``.

The rate is a constant ``LR`` = 4e-5: on Adam's first step a parameter
moves by about the rate times the sign of its gradient, so where the two
programs' gradients of an element near 0 round to opposite signs the
parameters part by twice the rate; 4e-5 keeps that inside the 1e-4
tolerance.  The moments (0.1·g and 0.05·g², then mixed with the second
step's) carry the check of the update itself."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.specs import concrete_batch
from repro_torch.models.lm import Model
from repro_torch.models.params import (ShardPlan, numpy_params,
                                       params_from_reference)
from repro_torch.parallel.fsdp import StateLayout, build_sharded_train_step
from repro_torch.parallel.sharding import (STRATEGIES, CollectiveCounter,
                                           make_act_sharder, make_mesh)
from repro_torch.training.optim import adamw_init
from repro_torch.training.tree import leaves_with_path, path_key

B, S, STEPS = 8, 16, 2
LR = 4e-5
TOL = 1e-4

_REF = """
    import dataclasses, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.registry import get_smoke_config
    from repro.models.lm import Model
    from repro.models.params import ShardPlan, logical_axes, unflatten
    from repro.parallel.sharding import (STRATEGIES, batch_logical,
                                         make_act_sharder, make_mesh_compat,
                                         set_mesh_compat, spec_for_logical,
                                         tree_shardings)
    from repro.training.optim import adamw_init
    from repro.training.train_step import build_train_step

    def flat(tree, pre=""):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out.update(flat(v, f"{pre}{k}/"))
            else:
                out[f"{pre}{k}"] = np.asarray(v, np.float32)
        return out

    for i in map(int, sys.argv[2].split(",")):
        arch, axes, strat, cf, sp = CASES[i]
        z = np.load(f"{sys.argv[1]}/in{i}.npz")
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        rules = STRATEGIES[strat]
        mesh = make_mesh_compat(tuple(axes.values()), tuple(axes))
        plan = ShardPlan(tp=axes["model"] if strat == "tp" else 1,
                         fsdp=axes["data"], dp=axes.get("pod", 1))
        model = Model(cfg, plan, mesh=mesh, opts={"sp": sp},
                      act_shard=make_act_sharder(mesh, rules))
        lax_tree = logical_axes(cfg, plan)
        params = unflatten({k[2:]: jnp.asarray(z[k]) for k in z.files
                            if k.startswith("p:")})
        psh = tree_shardings(lax_tree, params, mesh, rules)
        zrules = dict(rules)
        zrules["fsdp"] = rules["fsdp+"]
        msh = (tree_shardings(lax_tree, params, mesh, zrules)
               if "pod" in axes else psh)
        opt = adamw_init(params, cfg.opt_dtype)
        state = {"params": jax.device_put(params, psh),
                 "opt": {"m": jax.device_put(opt["m"], msh),
                         "v": jax.device_put(opt["v"], msh),
                         "step": opt["step"]}}
        state_sh = {"params": psh, "opt": {"m": msh, "v": msh,
                                           "step": NamedSharding(mesh, P())}}
        blog = batch_logical(cfg, "train")
        batches = [{k.split(":", 1)[1]: jnp.asarray(z[k]) for k in z.files
                    if k.startswith(f"b{s}:")} for s in range(STEPS)]
        bsh = {k: NamedSharding(mesh, spec_for_logical(
            blog[k], v.shape, mesh, rules)) for k, v in batches[0].items()}
        out = {}
        with set_mesh_compat(mesh):
            grad = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]),
                           in_shardings=(psh, bsh), out_shardings=psh)
            step = jax.jit(build_train_step(
                model, lr_schedule=lambda s: jnp.asarray(LR, jnp.float32)),
                in_shardings=(state_sh, bsh), out_shardings=(state_sh, None))
            for s, batch in enumerate(batches):
                batch = jax.device_put(batch, bsh)
                out.update({f"{s}g:{k}": v for k, v in
                            flat(grad(state["params"], batch)).items()})
                state, m = step(state, batch)
                out.update({f"{s}m:{k}": np.asarray(m[k], np.float32)
                            for k in ("loss", "aux", "grad_norm")})
                out.update({f"{s}s:{k}": v for k, v in flat(state).items()})
        np.savez(f"{sys.argv[1]}/out{i}.npz", **out)
"""


def case_cfg(arch, cf=None):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


def case_plan(axes, strat) -> ShardPlan:
    return ShardPlan(tp=axes["model"] if strat == "tp" else 1,
                     fsdp=axes["data"], dp=axes.get("pod", 1))


def case_inputs(case, seed: int = 5):
    """(cfg, plan, numpy parameters, the steps' batches) of a case."""
    arch, axes, strat, cf, _ = case
    cfg, plan = case_cfg(arch, cf), case_plan(axes, strat)
    flat = dict(numpy_params(cfg, seed, plan))
    batches = [concrete_batch(cfg, "train", B, S,
                              np.random.default_rng(seed + 1 + s),
                              device="cpu") for s in range(STEPS)]
    return cfg, plan, flat, batches


def run_reference(cases, tmp, groups=1):
    """The reference's records of ``cases``: per step its metrics
    (``"{s}m:..."``), gradients (``"{s}g:..."``) and post-step state
    (``"{s}s:params/..."``, ``opt/m/...``), as float32 arrays.  ``groups``
    subprocesses share the cases and run at once."""
    for i, case in enumerate(cases):
        _, _, flat, batches = case_inputs(case)
        np.savez(tmp / f"in{i}.npz",
                 **{f"p:{k}": v for k, v in flat.items()},
                 **{f"b{s}:{k}": v.numpy() for s, b in enumerate(batches)
                    for k, v in b.items()})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"))
    code = (f"CASES = {cases!r}\nSTEPS = {STEPS}\nLR = {LR!r}\n"
            + textwrap.dedent(_REF))
    idx = list(range(len(cases)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp),
         ",".join(map(str, idx[g::groups]))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for g in range(groups) if idx[g::groups]]
    for p in procs:
        log, _ = p.communicate(timeout=900)
        assert p.returncode == 0, log
    return [dict(np.load(tmp / f"out{i}.npz")) for i in idx]


def port_model(case, mesh=None):
    arch, axes, strat, cf, sp = case
    mesh = mesh or make_mesh(axes, ["cpu"])
    return Model(case_cfg(arch, cf), case_plan(axes, strat), mesh=mesh,
                 device="cpu", opts={"sp": sp},
                 act_shard=make_act_sharder(mesh, STRATEGIES[strat]))


def run_port(case):
    """The port's sharded step of ``case`` on CPU shards, two steps:
    (records keyed as ``run_reference``'s, the steps' collective
    counters, the layout)."""
    _, axes, strat, _, _ = case
    cfg, plan, flat, batches = case_inputs(case)
    rules = STRATEGIES[strat]
    model = port_model(case)
    mesh = model.mesh
    p = params_from_reference(flat, cfg, "cpu", plan)
    lay = StateLayout(model, mesh, rules)
    shards = lay.shard({"params": p, "opt": adamw_init(p, cfg.opt_dtype)})
    step = build_sharded_train_step(
        model, mesh, rules, lr_schedule=lambda s: torch.tensor(LR),
        keep_grads=True)
    out, counters = {}, []
    for s, batch in enumerate(batches):
        with CollectiveCounter() as cc:
            shards, m = step(shards, batch)
        counters.append(cc)
        grads = lay.unshard_tree(m.pop("grads"), places=lay.moments)
        out.update({f"{s}g:{path_key(k)}": v.float().numpy()
                    for k, v in leaves_with_path(grads)})
        out.update({f"{s}m:{k}": m[k].float().numpy()
                    for k in ("loss", "aux", "grad_norm")})
        out.update({f"{s}s:{path_key(k)}": v.float().numpy()
                    for k, v in leaves_with_path(lay.unshard(shards))})
    return out, counters, lay


def assert_close(got, want, tol=TOL):
    """Every record of ``want`` in ``got``, each within ``tol``."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for k in sorted(want):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                   err_msg=k)

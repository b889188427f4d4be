"""The TP serving program (``parallel/tp.py``) against the reference's own
TP program, and its placement, long-context decode and counted
collectives.

The reference's program is GSPMD's reading of ``DEFAULT_RULES``:
``jax.jit(model.prefill)`` and ``model.decode`` of a ``Model`` built with
its mesh and ``make_act_sharder(mesh, DEFAULT_RULES)``, the parameters
placed by ``tree_shardings``, on a ``make_mesh_compat`` mesh of forced host
devices (Auto axis types, as the reference's dry-run makes its mesh;
XLA_FLAGS must be set before jax is imported, so in one subprocess).  One arch per family
at (data 4, model 2), and the MoE at a dropping capacity at (2, 2) (EP over
``model``) and (1, 8) (4 experts on 8 ranks: replicated experts), where
the per-shard token split decides the drops.  Logits and every gathered
cache leaf after the prefill and 3 teacher-forced decode steps within 1e-4
in f32, the LM path's tolerance.

Also: the jamba smoke config's sequence-sharded decode (batch 1,
``cache_logical(long_context=True)``, (2, 2)) against the reference's
unsharded model across a data shard's boundary; every parameter and cache
block has its spec's shape and shard / unshard round-trip bit for bit; a
layout the program cannot run raises; and one decode step's counted
all-reduce and all-gather bytes equal the layout's arithmetic."""
import dataclasses
import functools
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.specs import concrete_batch
from repro_torch.models.lm import Model
from repro_torch.models.params import (ShardPlan, logical_axes, numpy_params,
                                       params_from_reference)
from repro_torch.parallel.fsdp import _get
from repro_torch.parallel.sharding import (DEFAULT_RULES, CollectiveCounter,
                                           cache_logical, local_shape,
                                           make_act_sharder, make_mesh,
                                           spec_for_logical)
from repro_torch.parallel.tp import TPServe

B, S, STEPS = 4, 16, 3
TOL = 1e-4
#: (arch, data, model, capacity factor or None)
REF_TP_CASES = [("llama3-8b", 4, 2, None), ("mixtral-8x7b", 4, 2, None),
                ("mamba2-780m", 4, 2, None),
                ("jamba-1.5-large-398b", 4, 2, None),
                ("seamless-m4t-large-v2", 4, 2, None),
                ("llama-3.2-vision-11b", 4, 2, None),
                ("mixtral-8x7b", 2, 2, 0.5), ("mixtral-8x7b", 1, 8, 0.5)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small torch ops, cores shared by workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, cf=None):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


def _case_inputs(arch, D, M, cf):
    """Parameters (numpy, the plan's padded shapes), the batch and the fed
    tokens of a case."""
    cfg, plan = _cfg(arch, cf), ShardPlan(tp=M, fsdp=D)
    flat = dict(numpy_params(cfg, 5, plan))
    batch = concrete_batch(cfg, "prefill", B, S, np.random.default_rng(6),
                           device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (STEPS, B))
    return cfg, plan, flat, batch, toks.astype(np.int32)


def _tp(cfg, plan, axes, long_context=False, sp=False):
    """The TP program of ``cfg`` on CPU shards over ``axes``."""
    mesh = make_mesh(axes, ["cpu"])
    model = Model(cfg, plan, mesh=mesh, opts={"sp": sp}, device="cpu",
                  act_shard=make_act_sharder(mesh, DEFAULT_RULES))
    return TPServe(model, long_context=long_context)


def _np(t):
    return t.float().numpy().copy()


def tp_trace(prog, flat, batch, toks, cache_len):
    """The TP program's logits and gathered caches after the prefill and
    each fed token."""
    cfg = prog.cfg
    shards = prog.shard_params(params_from_reference(flat, cfg, "cpu",
                                                     prog.model.plan))
    S0 = batch["tokens"].shape[1]
    enc = batch["frames"].shape[1] if "frames" in batch else None
    lay = prog.cache_layout(batch["tokens"].shape[0], cache_len, enc)
    out = []
    caches, logits = prog.prefill(shards, batch, cache_len)
    for i in range(len(toks) + 1):
        out.append((_np(logits), {k: _np(v) for k, v in
                                  lay.unshard_tree(caches).items()}))
        if i < len(toks):
            logits, caches = prog.decode(shards, caches, S0 + i,
                                         torch.from_numpy(toks[i]))
    return out


def assert_trace_close(got, want, tol=TOL):
    for step, ((lg, cg), (lw, cw)) in enumerate(zip(got, want)):
        assert lg.shape == lw.shape and set(cg) == set(cw), step
        np.testing.assert_allclose(lg, lw, atol=tol, rtol=0,
                                   err_msg=f"logits, step {step}")
        for k in cw:
            assert cg[k].shape == cw[k].shape, (step, k)
            np.testing.assert_allclose(cg[k], cw[k], atol=tol, rtol=0,
                                       err_msg=f"cache {k}, step {step}")


# ------------------------------------------------- the reference's program
_REF_TP = """
    import dataclasses, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs.registry import get_smoke_config
    from repro.models.lm import Model
    from repro.models.params import ShardPlan, logical_axes, unflatten
    from repro.parallel.sharding import (DEFAULT_RULES, make_act_sharder,
                                         make_mesh_compat, set_mesh_compat,
                                         tree_shardings)
    for i, (arch, D, M, cf) in enumerate(CASES):
        z = np.load(f"{sys.argv[1]}/in{i}.npz")
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        plan = ShardPlan(tp=M, fsdp=D)
        mesh = make_mesh_compat((D, M), ("data", "model"))
        model = Model(cfg, plan, mesh=mesh,
                      act_shard=make_act_sharder(mesh, DEFAULT_RULES))
        params = unflatten({k[2:]: jnp.asarray(z[k]) for k in z.files
                            if k.startswith("p:")})
        params = jax.device_put(params, tree_shardings(
            logical_axes(cfg, plan), params, mesh, DEFAULT_RULES))
        batch = {k[2:]: jnp.asarray(z[k]) for k in z.files
                 if k.startswith("b:")}
        S = batch["tokens"].shape[1]
        out = {}
        with set_mesh_compat(mesh):
            cache, logits = jax.jit(
                lambda p, b: model.prefill(p, b, S + STEPS + 1))(params, batch)
            decode = jax.jit(model.decode)
            for step in range(len(z["toks"]) + 1):
                out[f"l{step}"] = np.asarray(logits)
                out.update({f"c{step}:{k}": np.asarray(v, np.float32)
                            for k, v in cache.items()})
                if step < len(z["toks"]):
                    logits, cache = decode(params, cache,
                                           jnp.asarray(S + step, jnp.int32),
                                           jnp.asarray(z["toks"][step]))
        np.savez(f"{sys.argv[1]}/out{i}.npz", **out)
"""


@pytest.fixture(scope="module")
def ref_tp(tmp_path_factory):
    """The reference's TP program's traces of ``REF_TP_CASES``."""
    d = tmp_path_factory.mktemp("ref_tp")
    for i, case in enumerate(REF_TP_CASES):
        _, _, flat, batch, toks = _case_inputs(*case)
        np.savez(d / f"in{i}.npz", toks=toks,
                 **{f"p:{k}": v for k, v in flat.items()},
                 **{f"b:{k}": v.numpy() for k, v in batch.items()})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"))
    code = (f"CASES = {REF_TP_CASES!r}\nSTEPS = {STEPS}\n"
            + textwrap.dedent(_REF_TP))
    r = subprocess.run([sys.executable, "-c", code, str(d)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    out = []
    for i in range(len(REF_TP_CASES)):
        z = np.load(d / f"out{i}.npz")
        out.append([(z[f"l{s}"], {k.split(":", 1)[1]: z[k] for k in z.files
                                  if k.startswith(f"c{s}:")})
                    for s in range(STEPS + 1)])
    return out


@pytest.mark.parametrize("case", range(len(REF_TP_CASES)),
                         ids=[f"{a}-d{D}m{M}" + (f"-cf{cf}" if cf else "")
                              for a, D, M, cf in REF_TP_CASES])
def test_tp_matches_the_reference_tp_program(case, ref_tp):
    arch, D, M, cf = REF_TP_CASES[case]
    cfg, plan, flat, batch, toks = _case_inputs(arch, D, M, cf)
    got = tp_trace(_tp(cfg, plan, {"data": D, "model": M}), flat, batch,
                   toks, S + STEPS + 1)
    assert_trace_close(got, ref_tp[case])


# ------------------------------------------------ the long-context decode
def test_sequence_sharded_decode_matches_reference():
    """jamba's smoke config at batch 1 with the KV sequence over ``data``
    (cache of 32 positions, 16 per rank): the prefill of 13 tokens and 5
    decode steps at 13..17, which cross the ranks' boundary at 16, against
    the reference's unsharded model with the same plan."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke_config as ref_smoke
    from repro.models.lm import Model as RefModel
    from repro.models.params import ShardPlan as RefPlan
    D, M, S0, L, steps = 2, 2, 13, 32, 5
    arch = "jamba-1.5-large-398b"
    cfg, plan = _cfg(arch), ShardPlan(tp=M, fsdp=D)
    flat = dict(numpy_params(cfg, 8, plan))
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                               (1, S0 + steps))
    tokens = tokens.astype(np.int32)
    ref = RefModel(dataclasses.replace(ref_smoke(arch), dtype="float32"),
                   RefPlan(tp=M, fsdp=D))
    from repro.models.params import unflatten
    rp = unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    cache, logits = jax.jit(lambda p, b: ref.prefill(p, b, L))(
        rp, {"tokens": jnp.asarray(tokens[:, :S0])})
    decode = jax.jit(ref.decode)
    want = []
    for i in range(steps + 1):
        want.append((np.asarray(logits), {k: np.asarray(v, np.float32)
                                          for k, v in cache.items()}))
        if i < steps:
            logits, cache = decode(rp, cache, jnp.asarray(S0 + i, jnp.int32),
                                   jnp.asarray(tokens[:, S0 + i]))
    prog = _tp(cfg, plan, {"data": D, "model": M}, long_context=True)
    assert prog.kv_axes(1) == ("data",)
    got = tp_trace(prog, flat, {"tokens": torch.from_numpy(tokens[:, :S0])},
                   [tokens[:, S0 + i] for i in range(steps)], L)
    assert_trace_close(got, want)


# ------------------------------------------------------------ placement
@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b", "mamba2-780m",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
@pytest.mark.parametrize("axes", [{"data": 2, "model": 2},
                                  {"pod": 2, "data": 1, "model": 2}],
                         ids=["d2m2", "p2d1m2"])
def test_blocks_have_their_spec_shapes(arch, axes):
    """Every parameter block and every block of a prefill's cache has the
    shape ``spec_for_logical`` gives under ``DEFAULT_RULES`` (the pod mesh
    splits the batch), and shard -> unshard is the identity bit for bit
    (parameters and caches).  The run itself checks each group's output
    and the logits' blocks through the ``ActSharder``."""
    cfg = _cfg(arch)
    M = axes["model"]
    plan = ShardPlan(tp=M, fsdp=axes["data"])
    mesh = make_mesh(axes, ["cpu"])
    model = Model(cfg, plan, mesh=mesh, device="cpu",
                  act_shard=make_act_sharder(mesh, DEFAULT_RULES))
    prog = TPServe(model)
    flat = dict(numpy_params(cfg, 5, plan))
    params = params_from_reference(flat, cfg, "cpu", plan)
    shards = prog.shard_params(params)
    lax_tree = logical_axes(cfg, plan)
    for path, pl in prog.layout.places.items():
        shp = tuple(_get(params, path).shape)
        want = local_shape(shp, spec_for_logical(_get(lax_tree, path), shp,
                                                 mesh, DEFAULT_RULES), mesh)
        assert all(tuple(_get(sh, path).shape) == want for sh in shards), path
    back = prog.unshard_params(shards)
    for path in prog.layout.places:
        assert torch.equal(_get(back, path), _get(params, path)), path
    batch = concrete_batch(cfg, "prefill", B, S, np.random.default_rng(6),
                           device="cpu")
    caches, logits = prog.prefill(shards, batch, S + 2)
    assert logits.shape == (B, model.dm.vocab)
    enc = batch["frames"].shape[1] if "frames" in batch else None
    lay = prog.cache_layout(B, S + 2, enc)
    clog = cache_logical(cfg)
    for (k,), pl in lay.places.items():
        want = local_shape(pl.shape, spec_for_logical(
            clog[k], pl.shape, mesh, DEFAULT_RULES), mesh)
        assert all(tuple(c[k].shape) == want for c in caches), k
        if "pod" in axes:                   # the batch over (pod, data)
            assert pl.spec[clog[k].index("batch")] is not None, k
    whole = lay.unshard_tree(caches)
    again = lay.shard_tree(whole)
    for c, a in zip(caches, again):
        assert all(torch.equal(c[k], a[k]) for k in c)


def test_layouts_the_program_cannot_run_raise():
    """Heads that do not divide the model axis (the unpadded plan's 2 KV
    heads over 4 ranks), a mesh whose model axis is not last, and SSM heads
    that do not divide (8 over 16 ranks) each raise: no fallback."""
    cfg = _cfg("llama3-8b")
    mesh = make_mesh({"data": 1, "model": 4}, ["cpu"])
    with pytest.raises(ValueError, match="cannot split"):
        TPServe(Model(cfg, ShardPlan(), mesh=mesh, device="cpu"))
    mesh = make_mesh({"model": 2, "data": 2}, ["cpu"])
    with pytest.raises(NotImplementedError, match="last"):
        TPServe(Model(cfg, ShardPlan(tp=2), mesh=mesh, device="cpu"))
    mesh = make_mesh({"data": 1, "model": 16}, ["meta"])
    with pytest.raises(ValueError, match="SSM heads"):
        TPServe(Model(_cfg("mamba2-780m"), ShardPlan(tp=16), mesh=mesh,
                      device="meta"))


# ----------------------------------------------------- counted collectives
def test_decode_collectives_equal_the_layout_arithmetic():
    """The dry-run's one-device share of a llama3-8b smoke decode step
    (bf16, batch 4 at cache 32) on (pod 2, data 2, model 2) counts, per
    device: all-reduces of the embedding and of each layer's two
    row-parallel outputs, one (B/2, 1, d) block each; all-gathers of every
    weight's data-split block (each layer's wq, wk, wv, wo, w_in, w_gate,
    w_out; the embedding and the head) and of the logits, (B/2, V/2) f32
    over model then (B/2, V) over the batch axes.  A full CPU mesh running
    the same step counts the same."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import count_program
    cfg = get_smoke_config("llama3-8b")
    axes = {"pod": 2, "data": 2, "model": 2}
    Bd, L = 4, 32
    plan = ShardPlan(tp=2, fsdp=2, dp=2)
    shape = ShapeConfig("cell", "decode", L, Bd)
    build, run = dryrun._tp_share(cfg, shape, make_mesh(axes, ["meta"]),
                                  DEFAULT_RULES, plan, {})
    got = count_program(build, run)
    dm = Model(cfg, plan, device="meta").dm
    es, d, bl = 2, dm.d, Bd // 4              # the batch over pod × data
    layer = (d // 2) * (dm.h * dm.hd // 2 * 2 + dm.kh * dm.hd // 2 * 2
                        + 3 * dm.f // 2)
    want_ar = (1 + 2 * dm.groups) * bl * d * es
    want_ag = ((dm.groups * layer + 2 * (dm.vocab // 2) * (d // 2)) * es
               + bl * (dm.vocab // 2) * 4 + bl * dm.vocab * 4)
    assert got["collectives"]["all-reduce"] == want_ar
    assert got["collectives"]["all-gather"] == want_ag
    assert got["collectives"]["reduce-scatter"] == 0
    # the full mesh of CPU shards moves the same per device
    mesh = make_mesh(axes, ["cpu"])
    model = Model(cfg, plan, mesh=mesh, device="cpu",
                  act_shard=make_act_sharder(mesh, DEFAULT_RULES))
    prog = TPServe(model)
    shards = prog.shard_params(params_from_reference(
        numpy_params(cfg, 5, plan), cfg, "cpu", plan))
    caches = prog.cache_layout(Bd, L).shard_tree(model.init_cache(Bd, L))
    with CollectiveCounter() as cc:
        prog.decode(shards, caches, L - 1, torch.zeros(Bd, dtype=torch.int32))
    assert cc.as_dict() == got["collectives"] and cc.calls == got["calls"]
    assert math.prod(axes.values()) == len(shards)

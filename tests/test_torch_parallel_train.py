"""The port's training-side parallel paths on CPU meshes
(``make_mesh(S, ["cpu"])``): the GPipe schedule against the sequential
composition (the reference test's limits, 1e-5 forward and 1e-4 on the
gradients), the tiled ``all_to_all``, and the MoE's expert-parallel and
fallback mesh paths against the local path (1e-4: the shards sum the same
terms, in other orders) and against the reference's ``moe_ffn`` on a mesh
of forced host devices (1e-4).

The MoE's aux loss is the mean over the shards of each shard's own aux
(the reference's ``pmean``): the load-balance term is not linear in the
tokens, so it is held against that mean, and the output and its
gradients against the local path."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import moe
from repro_torch.models.lm import Model
from repro_torch.models.params import ShardPlan, numpy_params, \
    params_from_reference, resolve_dims
from repro_torch.parallel.pipeline import gpipe
from repro_torch.parallel.sharding import all_to_all, make_mesh
from test_torch_train import port_loss_grads


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small torch ops, cores shared by workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- gpipe
@pytest.mark.parametrize("S,M", [(4, 8), (4, 2), (2, 5), (1, 3)])
def test_gpipe_forward_and_grads_match_sequential(S, M):
    B, D = 2, 16
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.standard_normal((S, D, D)) * .3, dtype=torch.float32,
                     requires_grad=True)
    b = torch.tensor(rng.standard_normal((S, D)) * .1, dtype=torch.float32,
                     requires_grad=True)
    x = torch.tensor(rng.standard_normal((M, B, D)), dtype=torch.float32)
    pipe = gpipe(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                 make_mesh(S, ["cpu"], axis="pp"), "pp", S, M)
    y = pipe({"w": w, "b": b}, x)
    ref = x
    for s in range(S):
        ref = torch.tanh(ref @ w[s] + b[s])
    assert y.shape == (M, B, D)
    assert float((y - ref).detach().abs().max()) < 1e-5
    g1 = torch.autograd.grad((y ** 2).sum(), [w, b])
    g2 = torch.autograd.grad((ref ** 2).sum(), [w, b])
    assert max(float((a - c).abs().max()) for a, c in zip(g1, g2)) < 1e-4


def test_gpipe_needs_a_pp_mesh_of_the_stages():
    with pytest.raises(ValueError, match="pp"):
        gpipe(lambda p, h: h, make_mesh(2, ["cpu"]), "pp", 2, 4)
    with pytest.raises(ValueError, match="3 shards"):
        gpipe(lambda p, h: h, make_mesh(2, ["cpu"], axis="pp"), "pp", 3, 4)


# ---------------------------------------------------------------- all_to_all
@pytest.mark.parametrize("S", [2, 4])
def test_all_to_all_is_the_tiled_exchange(S):
    """out[r] = concat over sources s (in order) of slice r of parts[s]."""
    rng = np.random.default_rng(S)
    parts = [torch.tensor(rng.standard_normal((4 * S, 3, 2)))
             for _ in range(S)]
    mesh = make_mesh(S, ["cpu"])
    out = all_to_all(parts, mesh, split_dim=0, concat_dim=1)
    for r in range(S):
        want = np.concatenate([p.numpy()[4 * r:4 * (r + 1)] for p in parts],
                              axis=1)
        assert np.array_equal(out[r].numpy(), want)
    back = all_to_all(out, mesh, split_dim=1, concat_dim=0)
    assert all(torch.equal(a, b) for a, b in zip(back, parts))
    with pytest.raises(ValueError, match="equal slices"):
        all_to_all([torch.zeros(3, 2)] * S, mesh, 0, 1)


# ---------------------------------------------------------------- MoE
def _moe_case(cf=None, seed=0, b=4, s=8):
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                              dtype="float32")
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    dm = resolve_dims(cfg, ShardPlan())
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    t = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                               requires_grad=True)
    p = {"router": t(rng.standard_normal((d, e))),
         "w_in": t(rng.standard_normal((e, d, f)) * .1),
         "w_gate": t(rng.standard_normal((e, d, f)) * .1),
         "w_out": t(rng.standard_normal((e, f, d)) * .1),
         "norm": t(np.ones(d))}
    x = t(rng.standard_normal((b, s, d)))
    return cfg, dm, p, x


def _run(cfg, dm, p, x, mesh):
    y, aux = moe.moe_ffn(x, p, cfg, dm, mesh)
    grads = torch.autograd.grad((y ** 2).sum(), [x, *p.values()])
    return y.detach(), aux.detach(), grads


def _per_shard(cfg, p, x, S):
    """``_moe_local`` on each of S token shards: (y, mean aux)."""
    from repro_torch.models.layers import norm
    with torch.no_grad():
        xt = norm(x, p, cfg.norm).reshape(-1, cfg.d_model)
        parts = [moe._moe_local(c, p["router"], p["w_in"], p["w_gate"],
                                p["w_out"], cfg.moe_top_k,
                                cfg.capacity_factor)
                 for c in torch.chunk(xt, S)]
    return (torch.cat([q[0] for q in parts]).reshape(x.shape),
            torch.stack([q[1] for q in parts]).mean())


@pytest.mark.parametrize("S", [2, 4])
def test_moe_expert_parallel_equals_local(S):
    """No token dropped (capacity factor 4 = the experts): y and every
    gradient equal the local path's; aux is the shards' mean."""
    cfg, dm, p, x = _moe_case()
    assert dm.e % S == 0
    want = _run(cfg, dm, p, x, None)
    got = _run(cfg, dm, p, x, make_mesh(S, ["cpu"]))
    assert float((got[0] - want[0]).abs().max()) < 1e-4
    assert abs(float(got[1] - _per_shard(cfg, p, x, S)[1])) < 1e-5
    for a, c in zip(got[2], want[2]):
        assert float((a - c).abs().max()) < 1e-4


@pytest.mark.parametrize("S", [2, 4, 3])
def test_moe_mesh_with_drops_equals_local_per_token_shard(S):
    """At a dropping capacity each shard routes its own tokens with its own
    capacity: the mesh path (EP at S = 2, 4; the replicated-expert
    fallback at S = 3, where 3 does not divide the 4 experts) equals
    ``_moe_local`` run on each token shard, aux averaged over the shards."""
    cfg, dm, p, x = _moe_case(cf=0.5, b=6)
    y, aux, _ = _run(cfg, dm, p, x, make_mesh(S, ["cpu"]))
    want_y, want_aux = _per_shard(cfg, p, x, S)
    assert float((y - want_y).abs().max()) < 1e-4
    assert abs(float(aux - want_aux)) < 1e-5
    with torch.no_grad():
        local = moe.moe_ffn(x, p, cfg, dm, None)[0]
    assert float((local - want_y).abs().max()) > 1e-3    # drops differ


def test_moe_mesh_with_indivisible_tokens_equals_local():
    """5 tokens on 2 shards: every shard takes them all (the reference's
    replicated token spec), so the result is the local path's."""
    cfg, dm, p, x = _moe_case(b=1, s=5)
    want = _run(cfg, dm, p, x, None)
    got = _run(cfg, dm, p, x, make_mesh(2, ["cpu"]))
    assert float((got[0] - want[0]).abs().max()) < 1e-4
    for a, c in zip(got[2], want[2]):
        assert float((a - c).abs().max()) < 1e-4


# The reference's ``moe_ffn`` on a (data D, model S) mesh of forced host
# devices (as tests/test_multidevice.py runs it: XLA_FLAGS must be set
# before jax is imported, so in a subprocess): on (1, S) EP at S = 2, 4,
# the replicated-expert fallback at S = 3, against the port's one-axis
# mesh of S shards; on (4, 2) the tokens over both axes and EP within each
# model group, against the port's two-axis mesh; no drops and a dropping
# capacity.
REF_MOE_CASES = [(1, 2, None), (1, 4, None), (1, 2, 0.5), (1, 4, 0.5),
                 (1, 3, 0.5), (4, 2, None), (4, 2, 0.5)]
_REF_MOE = """
    import dataclasses, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.registry import get_smoke_config
    from repro.models.moe import moe_ffn
    from repro.models.params import ShardPlan, resolve_dims
    from repro.parallel.sharding import set_mesh_compat
    out = {}
    for i, (D, S, cf) in enumerate(CASES):
        z = np.load(f"{sys.argv[1]}/in{i}.npz")
        cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                                  dtype="float32")
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        dm = resolve_dims(cfg, ShardPlan())
        mesh = Mesh(np.array(jax.devices()[:D * S]).reshape(D, S),
                    ("data", "model"))
        x = jnp.asarray(z["x"])
        p = {k: jnp.asarray(z[k]) for k in z.files if k != "x"}
        names = sorted(p)
        def f(x, *ws):
            y, aux = moe_ffn(x, dict(zip(names, ws)), cfg, dm, mesh=mesh)
            return (y ** 2).sum(), (y, aux)
        with set_mesh_compat(mesh):
            g, (y, aux) = jax.jit(jax.grad(f, argnums=tuple(
                range(1 + len(names))), has_aux=True))(x, *(p[k] for k in names))
        np.savez(f"{sys.argv[1]}/out{i}.npz", y=np.asarray(y),
                 aux=np.asarray(aux), x_grad=np.asarray(g[0]),
                 **{k + "_grad": np.asarray(a) for k, a in zip(names, g[1:])})
"""


@pytest.fixture(scope="module")
def ref_moe_mesh(tmp_path_factory):
    """The reference's mesh outputs and gradients for ``REF_MOE_CASES``,
    on the inputs of ``_moe_case``."""
    d = tmp_path_factory.mktemp("ref_moe")
    for i, (_, _, cf) in enumerate(REF_MOE_CASES):
        _, _, p, x = _moe_case(cf=cf, b=6)
        np.savez(d / f"in{i}.npz", x=x.detach().numpy(),
                 **{k: v.detach().numpy() for k, v in p.items()})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"))
    code = f"CASES = {REF_MOE_CASES!r}\n" + textwrap.dedent(_REF_MOE)
    r = subprocess.run([sys.executable, "-c", code, str(d)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return [dict(np.load(d / f"out{i}.npz"))
            for i in range(len(REF_MOE_CASES))]


@pytest.mark.parametrize("case", range(len(REF_MOE_CASES)),
                         ids=[f"S{S}-cf{cf}" if D == 1 else f"d{D}m{S}-cf{cf}"
                              for D, S, cf in REF_MOE_CASES])
def test_moe_mesh_matches_the_reference_mesh(case, ref_moe_mesh):
    """The port's mesh path against the reference's ``shard_map`` on the
    same inputs: y, aux (per-shard capacity, the dump row, the ``pmean``)
    and every gradient of sum(y^2) within 1e-4."""
    D, S, cf = REF_MOE_CASES[case]
    want = ref_moe_mesh[case]
    cfg, dm, p, x = _moe_case(cf=cf, b=6)
    mesh = (make_mesh(S, ["cpu"]) if D == 1 else
            make_mesh({"data": D, "model": S}, ["cpu"]))
    y, aux, grads = _run(cfg, dm, p, x, mesh)
    assert np.abs(y.numpy() - want["y"]).max() < 1e-4
    assert abs(float(aux) - float(want["aux"])) < 1e-4
    for k, g in zip(["x", *p], grads):
        assert np.abs(g.numpy() - want[k + "_grad"]).max() < 1e-4, k


@pytest.mark.parametrize("arch,S", [("mixtral-8x7b", 2), ("mixtral-8x7b", 4),
                                    ("jamba-1.5-large-398b", 2)])
def test_model_loss_on_a_mesh_equals_no_mesh(arch, S):
    """``Model(mesh=...).loss``: the cross entropy and its gradients equal
    those without a mesh (the smoke configs drop no token); aux is finite
    and the total is ce + 0.01 aux."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    flat = list(numpy_params(cfg, 2))
    rng = np.random.default_rng(1)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (2, 16)),
                             dtype=torch.int32) for k in ("tokens", "labels")}
    want = port_loss_grads(cfg, flat, batch, of="loss")
    got = port_loss_grads(cfg, flat, batch, mesh=make_mesh(S, ["cpu"]),
                          of="loss")
    assert abs(got[1]["loss"] - want[1]["loss"]) < 1e-5
    assert np.isfinite(got[1]["aux"]) and abs(
        got[0] - (got[1]["loss"] + 0.01 * got[1]["aux"])) < 1e-5
    for k in want[2]:
        assert np.abs(got[2][k] - want[2][k]).max() < 1e-4, k

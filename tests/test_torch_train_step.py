"""The port's training half in bf16 and its train step, against the
reference's.

* bf16, one architecture per family (smoke config): the f32 init rounded
  to each leaf's dtype.  The relative L2 distance of the port's whole
  gradient (every leaf, concatenated) from the reference's bf16 run is at
  most twice the distance of the reference's own bf16 run from its f32 run
  on the same (rounded) parameters: bf16 keeps 8 mantissa bits and the
  packages round intermediate values at different points.  The loss is one
  number, whose two bf16 errors may by chance be far apart in size (their
  ratio ran 0.04-2.2 over these six configs), so its limit is twice the
  larger of that distance and 2^-8, one bf16 unit of the loss.
* ``build_train_step``, llama3-8b smoke in f32, three steps at the
  launcher's peak rate (1e-2 after a one-step warm-up), plain, with
  ``micro_batches=2`` and with the int8 ``grad_transform``, against the
  reference's jitted step: loss, aux and gradient norm within 1e-5
  relative at every step, the rate bit-equal, and every parameter and
  moment within 1e-5 after the three steps.  With the int8 compression a
  gradient element next to a quantization step may round to the other
  step in one package: its AdamW update then differs by up to the rate,
  so there at most 0.1 % of the parameters may differ by more than 1e-5,
  none by more than twice the rates' sum.
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
from repro.models.lm import Model as RefModel
from repro.runtime.fault_tolerance import \
    make_compressed_grad_transform as ref_compress
from repro.training.optim import adamw_init as ref_adamw_init
from repro.training.optim import cosine_schedule as ref_cosine
from repro.training.train_step import build_train_step as ref_build
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.lm import Model
from repro_torch.models.params import params_from_reference
from repro_torch.runtime.fault_tolerance import make_compressed_grad_transform
from repro_torch.training.optim import cosine_schedule
from repro_torch.training.train_step import build_train_step, init_train_state
from repro_torch.training.tree import leaves_with_path, path_key
from test_torch_train import (FAMILY_ARCHS, _batch, _flat, _ref_loss_grads,
                              _ref_params, _to_port, port_loss_grads)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cat(grads):
    return np.concatenate([grads[k].ravel() for k in sorted(grads)])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_reference_bf16(arch):
    cfg = ref_smoke(arch)                              # bf16
    shapes = RefModel(cfg).param_shapes()
    params = jax.tree.map(lambda a, s: a.astype(s.dtype), _ref_params(arch),
                          shapes)
    batch = _batch(cfg)
    ref = _ref_loss_grads(cfg, params, batch)
    own = _ref_loss_grads(dataclasses.replace(cfg, dtype="float32"),
                          jax.tree.map(lambda a: a.astype(jnp.float32),
                                       params), batch)
    got = port_loss_grads(get_smoke_config(arch), _flat(params),
                          _to_port(batch))
    assert _rel(got[0], ref[0]) <= 2 * max(_rel(ref[0], own[0]), 2 ** -8), (
        got[0], ref[0], own[0])
    assert _rel(_cat(got[2]), _cat(ref[2])) <= 2 * _rel(_cat(ref[2]),
                                                       _cat(own[2]))


SCHEDULE = dict(base_lr=1e-2, warmup=1, total=100)


@pytest.mark.parametrize("variant", ["plain", "micro2", "int8"])
def test_train_steps_match_reference(variant):
    arch = "llama3-8b"
    cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    micro = 2 if variant == "micro2" else 1
    ref_model = RefModel(cfg)
    ref_step = jax.jit(ref_build(
        ref_model, lr_schedule=functools.partial(ref_cosine, **SCHEDULE),
        micro_batches=micro,
        grad_transform=ref_compress() if variant == "int8" else None))
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    port_step = build_train_step(
        Model(tcfg, device="cpu"),
        lr_schedule=functools.partial(cosine_schedule, **SCHEDULE),
        micro_batches=micro,
        grad_transform=(make_compressed_grad_transform()
                        if variant == "int8" else None))
    params = _ref_params(arch)
    rs = {"params": params, "opt": ref_adamw_init(params)}
    tp = params_from_reference(_flat(params), tcfg, "cpu")
    ts = {"params": tp, "opt": {"m": jax.tree.map(torch.zeros_like, tp),
                                "v": jax.tree.map(torch.zeros_like, tp),
                                "step": torch.zeros((), dtype=torch.int32)}}
    rng = np.random.default_rng(0)
    lrs = []
    for i in range(3):
        b = ref_batch(cfg, "train", 4, 16, rng)
        if micro > 1:
            b = {k: v.reshape(micro, -1, *v.shape[1:]) for k, v in b.items()}
        rs, rm = ref_step(rs, b)
        ts, tm = port_step(ts, _to_port(b))
        assert set(tm) == set(rm)
        for k in ("loss", "aux", "grad_norm"):
            assert abs(float(tm[k]) - float(rm[k])) <= 1e-5 * max(
                1.0, abs(float(rm[k]))), (i, k, float(tm[k]), float(rm[k]))
        assert float(tm["lr"]) == float(rm["lr"]) and \
            float(tm["step"]) == float(rm["step"]) == i + 1
        lrs.append(float(rm["lr"]))
    assert int(ts["opt"]["step"]) == 3
    want = {"params": _flat(rs["params"]), "m": _flat(rs["opt"]["m"]),
            "v": _flat(rs["opt"]["v"])}
    for name, tree in (("params", ts["params"]), ("m", ts["opt"]["m"]),
                       ("v", ts["opt"]["v"])):
        for path, t in leaves_with_path(tree):
            d = np.abs(t.numpy() - want[name][path_key(path)])
            if variant == "int8" and name == "params":
                assert (d > 1e-5).mean() <= 1e-3, path
                assert d.max() <= 2 * sum(lrs), path
            elif variant != "int8":
                assert d.max() <= 1e-5 * max(1.0, float(np.abs(
                    want[name][path_key(path)]).max())), (name, path)


def test_init_train_state_shapes_and_dtypes():
    """The reference's state tree: params of the spec's dtypes, moments of
    ``opt_dtype``, an int32 0-d step, on the model's device."""
    cfg = dataclasses.replace(get_smoke_config("jamba-1.5-large-398b"),
                              opt_dtype="bfloat16")
    model = Model(cfg, device="cpu")
    st = init_train_state(model, torch.Generator().manual_seed(0))
    want = RefModel(dataclasses.replace(
        ref_smoke("jamba-1.5-large-398b"), opt_dtype="bfloat16")).param_shapes()
    flat_want = {path_key(tuple(getattr(k, "key", k) for k in p)): s
                 for p, s in jax.tree_util.tree_leaves_with_path(want)}
    got = dict((path_key(p), t) for p, t in leaves_with_path(st["params"]))
    assert set(got) == set(flat_want)
    for k, s in flat_want.items():
        assert tuple(got[k].shape) == s.shape and \
            str(got[k].dtype) == f"torch.{s.dtype}", k
    for p, t in leaves_with_path(st["opt"]["m"]):
        assert t.dtype == torch.bfloat16 and not t.any()
    assert st["opt"]["step"].dtype == torch.int32 and \
        st["opt"]["step"].ndim == 0

"""The SSD's ``ssd_dtype="bfloat16"`` option (the reference's
``ssd_chunked(dtype16=True)``: the intra-chunk decay and weight tensors
held in bf16, every sum in f32) on the two families that run the SSD,
mamba2-780m's and jamba's smoke configs with f32 parameters, against the
reference under the same option: prefill then four decode steps (logits
and caches), and the loss with its gradients.

Tolerances are ``tests/test_torch_lm_model.py``'s bf16 cases': the
relative L2 distance of the port's result from the reference's, both with
the option, is at most twice the distance of the reference's run with the
option from its run without it (the packages round the bf16 tensors at
different points).  The loss is one number, so its limit is twice the
larger of that distance and 2^-8 (``tests/test_torch_train_step.py``'s
rule).  Twice the option's own effect cannot tell a port that drops the
option from one that keeps it, so each result must also lie nearer the
reference's run with the option than its run without it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.launch.specs import concrete_batch as ref_batch
from repro.models.lm import Model as RefModel
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.lm import Model
from repro_torch.models.params import params_from_reference
from test_torch_lm_model import _cat, _flat, _np, _ref_params, _rel, _to_port
from test_torch_train import _ref_loss_grads, port_loss_grads
from test_torch_train import _to_port as _to_port_train

ARCHS = ["mamba2-780m", "jamba-1.5-large-398b"]
OPTS = {"ssd_dtype": "bfloat16"}
B, S, STEPS = 2, 16, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(arch, opts, toks=None):
    cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    ref = RefModel(cfg, opts=opts)
    params = _ref_params(arch)
    batch = ref_batch(cfg, "prefill", B, S, np.random.default_rng(0))
    cache, logits = jax.jit(lambda p, b: ref.prefill(p, b, S + STEPS))(
        params, batch)
    decode = jax.jit(ref.decode)
    out, fed = [], []
    for i in range(STEPS + 1):
        out.append((_np(logits), {k: _np(v) for k, v in cache.items()}))
        if i == STEPS:
            break
        fed.append(np.array(jnp.argmax(logits[:, :cfg.vocab_size], -1),
                            np.int32) if toks is None else toks[i])
        logits, cache = decode(params, cache, jnp.asarray(S + i, jnp.int32),
                               jnp.asarray(fed[-1]))
    return out, batch, fed


def _port(arch, batch, toks):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    port = Model(cfg, device="cpu", opts=OPTS)
    tp = params_from_reference(_flat(_ref_params(arch)), cfg, "cpu")
    out = []
    with torch.inference_mode():
        cache, logits = port.prefill(tp, _to_port(batch, torch.float32),
                                     cache_len=S + STEPS)
        for i in range(STEPS + 1):
            out.append((_np(logits), {k: _np(v) for k, v in cache.items()}))
            if i < STEPS:
                logits, cache = port.decode(tp, cache, S + i,
                                            torch.from_numpy(toks[i]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_ssd16_prefill_and_decode_match_reference(arch):
    out_r, batch, toks = _reference(arch, OPTS)
    out_f = _reference(arch, None, toks)[0]
    out_t = _port(arch, batch, toks)
    moved = 0.0
    for step in range(STEPS + 1):
        (lr, cr), (lt, ct), (lf, cf) = out_r[step], out_t[step], out_f[step]
        moved = max(moved, _rel(lr, lf))
        assert _rel(lt, lr) <= 2 * _rel(lr, lf), step
        assert _rel(_cat(ct), _cat(cr)) <= 2 * _rel(_cat(cr), _cat(cf)), step
        assert _rel(lt, lr) < _rel(lt, lf), step
        assert _rel(_cat(ct), _cat(cr)) < _rel(_cat(ct), _cat(cf)), step
    assert moved > 0           # the option changes the reference's numbers


def _rel_all(a, b):
    ka = sorted(a)
    x = np.concatenate([a[k].ravel() for k in ka])
    y = np.concatenate([b[k].ravel() for k in ka])
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


@pytest.mark.parametrize("arch", ARCHS)
def test_ssd16_loss_and_grads_match_reference(arch):
    cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    batch = ref_batch(cfg, "train", B, S, np.random.default_rng(0))
    params = _ref_params(arch)
    lr16, _, gr16 = _ref_loss_grads(cfg, params, batch, opts=OPTS)
    lr32, _, gr32 = _ref_loss_grads(cfg, params, batch)
    lt, _, gt = port_loss_grads(tcfg, _flat(params), _to_port_train(batch),
                                opts=OPTS)
    d_ref = abs(lr16 - lr32) / abs(lr32)
    assert abs(lt - lr16) / abs(lr16) <= 2 * max(d_ref, 2.0 ** -8)
    assert _rel_all(gt, gr16) <= 2 * _rel_all(gr16, gr32)
    assert abs(lt - lr16) < abs(lt - lr32)
    assert _rel_all(gt, gr16) < _rel_all(gt, gr32)

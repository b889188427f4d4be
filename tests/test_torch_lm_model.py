"""The port's LM ``Model`` against the reference's, all ten architectures at
their smoke configs: parameters drawn by the reference's ``Model.init``
cross into the port through ``params_from_reference``, the batch is the
reference's ``concrete_batch``, and both run prefill then four decode
steps on the same tokens.

Tolerances:
* f32 (every arch): logits and every cache leaf within 1e-4 absolute, after
  the prefill and after each decode step — the packages sum in another
  order, nothing else differs.
* bf16 (one arch per family): the relative L2 distance of the port's logits
  (and of its whole cache) from the reference's is at most twice the
  distance of the reference's own bf16 run from its f32 run on the same
  parameters.  bf16 keeps 8 bits of mantissa, and the two packages round
  intermediate values at different points (XLA fuses elementwise chains);
  in a routed layer one ulp in a router logit may send a token to another
  expert, which both packages' bf16 runs do against their f32 runs alike.

Also the launcher's lm mode, the batch maker and the parameter carrier."""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.launch.specs import concrete_batch as ref_batch
from repro.models.lm import Model as RefModel
from repro_torch.configs.registry import get_smoke_config, list_archs
from repro_torch.launch import serve
from repro_torch.launch.specs import concrete_batch
from repro_torch.models.lm import Model
from repro_torch.models.params import (DTYPES, build_param_specs,
                                       params_from_reference)

ROOT = Path(__file__).resolve().parent.parent
B, S, STEPS = 2, 16, 4
#: one architecture per family for the bf16 cases
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
        out.update(_flat(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out


def _np(t):
    """A host copy in f32 (the port's decode writes its cache in place)."""
    return t.float().numpy().copy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _to_port(batch, dtype):
    return {k: torch.from_numpy(np.array(v)) if v.dtype == jnp.int32 else
            torch.from_numpy(np.array(v, np.float32)).to(dtype)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's ``Model.init`` of the f32 smoke config."""
    cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    return RefModel(cfg).init(jax.random.key(1))


def _reference(arch, dtype, params, toks=None):
    """The reference's logits and caches after the prefill and after each
    of STEPS decode steps, and the tokens it fed: ``toks``, or greedy."""
    cfg = dataclasses.replace(ref_smoke(arch), dtype=dtype)
    ref = RefModel(cfg)
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


def _port(arch, dtype, params, batch, toks):
    """The port's run on the reference's parameters, batch and tokens."""
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    port = Model(tcfg, device="cpu")
    tp = params_from_reference(_flat(params), tcfg, "cpu")
    out = []
    with torch.inference_mode():
        cache, logits = port.prefill(tp, _to_port(batch, DTYPES[dtype]),
                                     cache_len=S + STEPS)
        for i in range(STEPS + 1):
            out.append((_np(logits), {k: _np(v) for k, v in cache.items()}))
            if i < STEPS:
                logits, cache = port.decode(tp, cache, S + i,
                                            torch.from_numpy(toks[i]))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_prefill_and_decode_match_reference_f32(arch):
    out_r, batch, toks = _reference(arch, "float32", _ref_params(arch))
    out_t = _port(arch, "float32", _ref_params(arch), batch, toks)
    for step, ((lr, cr), (lt, ct)) in enumerate(zip(out_r, out_t)):
        assert lt.shape == lr.shape and set(ct) == set(cr), step
        np.testing.assert_allclose(lt, lr, atol=1e-4, rtol=0,
                                   err_msg=f"logits, step {step}")
        for k in cr:
            assert ct[k].shape == cr[k].shape, (step, k)
            np.testing.assert_allclose(ct[k], cr[k], atol=1e-4, rtol=0,
                                       err_msg=f"cache {k}, step {step}")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cat(cache):
    return np.concatenate([cache[k].ravel() for k in sorted(cache)])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_and_decode_match_reference_bf16(arch):
    """The f32 init cast to bf16; the reference's own bf16 error is its f32
    run on those bf16 values (upcast), fed the bf16 run's tokens."""
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), _ref_params(arch))
    out_r, batch, toks = _reference(arch, "bfloat16", params)
    out_t = _port(arch, "bfloat16", params, batch, toks)
    out_f = _reference(arch, "float32",
                       jax.tree.map(lambda a: a.astype(jnp.float32), params),
                       toks)[0]
    for step in range(STEPS + 1):
        (lr, cr), (lt, ct), (lf, cf) = out_r[step], out_t[step], out_f[step]
        assert _rel(lt, lr) <= 2 * _rel(lr, lf), step
        assert _rel(_cat(ct), _cat(cr)) <= 2 * _rel(_cat(cr), _cat(cf)), step


@pytest.mark.parametrize("arch", list_archs())
def test_init_cache_matches_reference(arch):
    """The empty cache's leaves: the reference's names, shapes and dtypes."""
    want = RefModel(ref_smoke(arch)).init_cache(3, 24, abstract=True)
    got = Model(get_smoke_config(arch), device="cpu").init_cache(3, 24)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype) == f"torch.{w.dtype}", k
        assert not got[k].any(), k


# ---------------------------------------------------------------- launcher
def test_launcher_lm_mode_prints_the_reference_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
         "--device", "cpu", "--arch", "qwen1.5-4b", "--new-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[serve] qwen1.5-4b: batch=64 decoded 4 "
                               "tokens in ") and lines[0].endswith(" tok/s)")
    assert lines[1].startswith("[serve] sample continuation ids: [")
    assert len(eval(lines[1].split(": ", 1)[1])) == 5


@pytest.mark.parametrize("arch", list_archs())
def test_launcher_lm_mode_serves_every_arch(arch, capsys):
    toks = serve.main(["--mode", "lm", "--device", "cpu", "--arch", arch,
                       "--max-batch", "4", "--new-tokens", "3"])
    assert toks.shape == (4, 4) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < get_smoke_config(arch).vocab_size)).all()
    assert "sample continuation ids" in capsys.readouterr().out


# ---------------------------------------------------------------- helpers
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b", "llama3-8b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_concrete_batch_matches_reference(arch, kind):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    want = ref_batch(dataclasses.replace(ref_smoke(arch), dtype="float32"),
                     kind, 3, 20, np.random.default_rng(4))
    got = concrete_batch(cfg, kind, 3, 20, np.random.default_rng(4),
                         device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == (torch.int32 if want[k].dtype == jnp.int32
                                else torch.float32), k
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_params_from_reference_checks_paths_and_shapes():
    cfg = get_smoke_config("mamba2-780m")
    flat = {p: np.zeros(s.shape, np.float32)
            for p, s in build_param_specs(cfg).items()}
    tree = params_from_reference(flat, cfg, "cpu")
    assert tree["blocks"]["ssm"]["a_log"].dtype == torch.float32
    assert tree["embed"].dtype == torch.bfloat16
    with pytest.raises(KeyError, match="missing"):
        params_from_reference({k: v for k, v in flat.items()
                               if k != "embed"}, cfg, "cpu")
    with pytest.raises(KeyError, match="unexpected"):
        params_from_reference(dict(flat, extra=np.zeros(1)), cfg, "cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(dict(flat, embed=np.zeros((2, 2))), cfg, "cpu")

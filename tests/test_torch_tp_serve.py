"""The TP serving program (``parallel/tp.py``) against the reference's
unsharded ``Model`` with the same ``ShardPlan``, all ten architectures'
smoke configs in f32: the prefill (cache of seq + 4 positions) and 3
teacher-forced decode steps on CPU shards (``make_mesh({"data": D,
"model": M}, ["cpu"])``) at (data, model) = (2, 2) and (1, 4) (at (1, 4)
the smoke configs' 2 KV heads are padded to 4), with sequence parallelism
at (1, 2), and at (pod 2, data 1, model 2), where the batch splits
(``DEFAULT_RULES`` puts it on ``(pod, data)``, so a mesh without a pod
axis serves the whole batch on every data rank).  Logits and every gathered cache leaf within 1e-4
(the LM path's f32 tolerance: the shards sum the row-parallel partials in
another order).  Parameters drawn by the reference's ``Model.init`` cross
into the port through ``params_from_reference``.  SP moves the same sums
through a reduce-scatter instead of an all-reduce, so its run must equal
the sp=False run bit for bit."""
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
from repro.models.params import ShardPlan as RefPlan
from repro_torch.configs.registry import get_smoke_config, list_archs
from repro_torch.models.params import ShardPlan
from repro_torch.parallel.sharding import CollectiveCounter
from test_torch_tp_mesh import _tp, assert_trace_close, tp_trace

B, S, STEPS = 2, 16, 3
#: (mesh axes, sp)
MESHES = {"d2m2": ({"data": 2, "model": 2}, False),
          "d1m4": ({"data": 1, "model": 4}, False),
          "d1m2-sp": ({"data": 1, "model": 2}, True),
          "p2d1m2": ({"pod": 2, "data": 1, "model": 2}, False)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small torch ops, cores shared by workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        p = f"{pre}/{k}" if pre else k
        out.update(_flat(v, p) if isinstance(v, dict) else
                   {p: np.asarray(v, np.float32)})
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch, tp):
    """The reference's unsharded f32 model with ``ShardPlan(tp=tp)``: its
    parameters (flat numpy), batch, the tokens it fed (greedy) and its
    logits and caches after the prefill and each decode step."""
    cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    ref = RefModel(cfg, RefPlan(tp=tp))
    params = ref.init(jax.random.key(3))
    batch = ref_batch(cfg, "prefill", B, S, np.random.default_rng(4))
    cache, logits = jax.jit(lambda p, b: ref.prefill(p, b, S + STEPS + 1))(
        params, batch)
    decode = jax.jit(ref.decode)
    out, toks = [], []
    for i in range(STEPS + 1):
        out.append((np.asarray(logits, np.float32),
                    {k: np.asarray(v, np.float32) for k, v in cache.items()}))
        if i == STEPS:
            break
        toks.append(np.array(jnp.argmax(logits[:, :cfg.vocab_size], -1),
                             np.int32))
        logits, cache = decode(params, cache, jnp.asarray(S + i, jnp.int32),
                               jnp.asarray(toks[-1]))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return _flat(params), batch, np.stack(toks), out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_tp_prefill_and_decode_match_reference(arch, mesh):
    axes, sp = MESHES[mesh]
    M = axes["model"]
    flat, batch, toks, want = _reference(arch, M)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    plan = ShardPlan(tp=M, fsdp=axes["data"], dp=axes.get("pod", 1))
    with CollectiveCounter() as cc:
        got = tp_trace(_tp(cfg, plan, axes, sp=sp), flat, batch, toks,
                       S + STEPS + 1)
    assert_trace_close(got, want)
    assert cc.bytes["all-reduce"] > 0 and cc.bytes["all-gather"] > 0
    if sp:        # the SP run moves its stream by reduce-scatters ...
        assert cc.bytes["reduce-scatter"] > 0
        # ... of the same sums as the plain run's all-reduces
        plain = tp_trace(_tp(cfg, plan, axes), flat, batch, toks,
                         S + STEPS + 1)
        for (lg, cg), (lp, cp) in zip(got, plain):
            assert np.array_equal(lg, lp)
            assert all(np.array_equal(cg[k], cp[k]) for k in cp)
    else:
        assert cc.bytes["reduce-scatter"] == 0

"""The LM scaffold's layers in the port against the reference's, on the
same seeded numpy inputs: the norms, RoPE, both MLPs, the embedding and
the head (tied and untied), flash attention (causal, sliding window, GQA,
``kv_valid``, a query offset, chunks that do not divide the sequence),
decode attention, the SSD scan and its decode step, the local MoE at a
capacity that drops tokens, and the parameter count of all ten full
configs.  f32 throughout; tolerances are stated per test (the two packages
sum in another order, nothing more)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
import repro.models.layers as RL
import repro.models.moe as RM
import repro.models.ssm as RS
import repro_torch.models.attention as TA
import repro_torch.models.layers as TL
import repro_torch.models.moe as TM
import repro_torch.models.ssm as TS
from repro.configs.registry import get_config as ref_config
from repro.models.params import count_params as ref_count
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.models.params import count_params

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small torch ops, and with
    the test workers sharing the cores, more threads only add waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(fn_t, fn_r, *arrays, **kw):
    """The port's function on torch tensors, the reference's on jnp arrays,
    both back as numpy."""
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    want = fn_r(*(jnp.asarray(a) for a in arrays), **kw)
    return got, want


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("name", ["rmsnorm", "layernorm", "rope", "swiglu",
                                  "gelu", "embed", "logits", "logits_tied"])
def test_layer_matches_reference(name):
    rng = np.random.default_rng(len(name))
    x = _normal(rng, 2, 6, 4, 16)
    d = x.reshape(2, 6, 64)
    p = {"w_in": _normal(rng, 64, 32) / 8, "w_gate": _normal(rng, 64, 32) / 8,
         "w_out": _normal(rng, 32, 64) / 6, "embed": _normal(rng, 50, 64),
         "lm_head": _normal(rng, 64, 50)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    scale, bias = _normal(rng, 64), _normal(rng, 64)
    pos = rng.integers(0, 5000, (2, 6)).astype(np.int32)
    tok = rng.integers(0, 50, (2, 6)).astype(np.int32)
    got, want = {
        "rmsnorm": lambda: _both(TL.rmsnorm, RL.rmsnorm, d, scale),
        "layernorm": lambda: _both(TL.layernorm, RL.layernorm, d, scale, bias),
        "rope": lambda: _both(TL.apply_rope, RL.apply_rope, x, pos,
                              theta=500000.0),
        "swiglu": lambda: (TL.mlp(torch.from_numpy(d), tp, "swiglu"),
                           RL.mlp(jnp.asarray(d), jp, "swiglu")),
        "gelu": lambda: (TL.mlp(torch.from_numpy(d), tp, "gelu"),
                         RL.mlp(jnp.asarray(d), jp, "gelu")),
        "embed": lambda: _both(TL.embed_tokens, RL.embed_tokens, tok,
                               p["embed"]),
        "logits": lambda: (TL.lm_logits(torch.from_numpy(d), tp, False),
                           RL.lm_logits(jnp.asarray(d), jp, False)),
        "logits_tied": lambda: (TL.lm_logits(torch.from_numpy(d), tp, True),
                                RL.lm_logits(jnp.asarray(d), jp, True)),
    }[name]()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("case", [
    dict(S=50, H=4, Kh=4, causal=True, q_chunk=16, kv_chunk=32),
    dict(S=50, H=4, Kh=4, causal=False, q_chunk=128, kv_chunk=8),
    dict(S=40, H=8, Kh=2, causal=True, q_chunk=16, kv_chunk=16),
    dict(S=40, H=8, Kh=2, causal=True, window=8, q_chunk=16, kv_chunk=16),
    dict(S=37, H=6, Kh=3, causal=True, window=5, q_chunk=7, kv_chunk=11),
    dict(S=33, H=4, Kh=1, causal=True, kv_valid=21, q_chunk=8, kv_chunk=8),
    dict(S=24, Skv=40, H=4, Kh=2, causal=True, q_offset=16, q_chunk=8,
         kv_chunk=16),
    dict(S=20, Skv=9, H=4, Kh=2, causal=False, q_chunk=6, kv_chunk=4),
])
def test_flash_attention_matches_reference(case):
    case = dict(case)
    rng = np.random.default_rng(len(str(case)))
    S, H, Kh = case.pop("S"), case.pop("H"), case.pop("Kh")
    Skv = case.pop("Skv", S)
    q = _normal(rng, 2, S, H, 16)
    k, v = _normal(rng, 2, Skv, Kh, 16), _normal(rng, 2, Skv, Kh, 16)
    got, want = _both(TA.flash_attention, RA.flash_attention, q, k, v, **case)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_flash_attention_gqa_grouping_is_kh_major():
    """Query head h reads kv head h // G: repeating each kv head G times
    next to itself (``repeat_interleave``) gives the same result."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_normal(rng, 1, 24, 8, 8))
    k = torch.from_numpy(_normal(rng, 1, 24, 2, 8))
    v = torch.from_numpy(_normal(rng, 1, 24, 2, 8))
    got = TA.flash_attention(q, k, v, q_chunk=8, kv_chunk=8)
    want = TA.flash_attention(q, k.repeat_interleave(4, dim=2),
                              v.repeat_interleave(4, dim=2), q_chunk=8,
                              kv_chunk=8)
    assert torch.allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cur_len,window", [(1, 0), (13, 0), (20, 0),
                                            (13, 4), (20, 64)])
def test_decode_attention_matches_reference(cur_len, window):
    rng = np.random.default_rng(cur_len * 7 + window)
    q1 = _normal(rng, 3, 1, 8, 16)
    k, v = _normal(rng, 3, 20, 2, 16), _normal(rng, 3, 20, 2, 16)
    got, want = _both(TA.decode_attention, RA.decode_attention, q1, k, v,
                      cur_len=cur_len, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# ---------------------------------------------------------------- SSD
@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 48), (20, 128)])
def test_ssd_chunked_matches_reference(s, chunk):
    rng = np.random.default_rng(s + chunk)
    b, h, p, n = 2, 3, 4, 8
    x = _normal(rng, b, s, h, p)
    dt = np.log1p(np.exp(_normal(rng, b, s, h)))            # softplus > 0
    a = -np.exp(_normal(rng, h) * 0.5).astype(np.float32)
    bm, cm = _normal(rng, b, s, n), _normal(rng, b, s, n)
    (y, st), (yr, str_) = _both(TS.ssd_chunked, RS.ssd_chunked,
                                x, dt.astype(np.float32), a, bm, cm,
                                chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(str_), atol=1e-4,
                               rtol=1e-5)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(5)
    b, h, p, n = 3, 4, 5, 6
    args = (_normal(rng, b, h, p, n), _normal(rng, b, h, p),
            np.abs(_normal(rng, b, h)), -np.abs(_normal(rng, h)),
            _normal(rng, b, n), _normal(rng, b, n))
    (y, st), (yr, str_) = _both(TS.ssd_decode_step, RS.ssd_decode_step, *args)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=ATOL, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(str_), atol=ATOL,
                               rtol=0)


# ---------------------------------------------------------------- MoE
@pytest.mark.parametrize("t,k,e,cf", [(64, 2, 4, 4.0),   # smoke: no drop
                                      (64, 2, 8, 1.25),  # mixtral's factor
                                      (96, 1, 4, 0.5),   # top-1, heavy drop
                                      (40, 2, 4, 0.75)])
def test_moe_local_matches_reference(t, k, e, cf):
    """Routing, which tokens each capacity keeps, and the combined output;
    the dropped-token cases drop some (asserted)."""
    rng = np.random.default_rng(t * e + k)
    d, f = 16, 24
    xt = _normal(rng, t, d)
    router = _normal(rng, d, e)
    w_in, w_gate = _normal(rng, e, d, f) * 0.3, _normal(rng, e, d, f) * 0.3
    w_out = _normal(rng, e, f, d) * 0.3
    tx = [torch.from_numpy(a) for a in (xt, router)]
    gates, eidx, aux = TM._route(*tx, k)
    gr, er, auxr = RM._route(jnp.asarray(xt), jnp.asarray(router), k)
    assert np.array_equal(eidx.numpy(), np.asarray(er))
    np.testing.assert_allclose(gates.numpy(), np.asarray(gr), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(auxr), rtol=1e-5)
    c = TM._capacity(t, k, e, cf)
    assert c == RM._capacity(t, k, e, cf)
    buf, (tok_s, slot, keep, order) = TM._sort_dispatch(tx[0], eidx, e, c)
    bufr, (tok_r, slot_r, keep_r, order_r) = RM._sort_dispatch(
        jnp.asarray(xt), er, e, c)
    for got, want in ((tok_s, tok_r), (slot, slot_r), (keep, keep_r),
                      (order, order_r)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(buf.numpy(), np.asarray(bufr))
    assert keep.all() == (cf >= e)
    y, _ = TM._moe_local(*tx, *(torch.from_numpy(w) for w in
                                (w_in, w_gate, w_out)), k, cf)
    yr, _ = RM._moe_local(jnp.asarray(xt), jnp.asarray(router),
                          jnp.asarray(w_in), jnp.asarray(w_gate),
                          jnp.asarray(w_out), k, cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4, rtol=0)


def test_route_ties_keep_the_lower_expert():
    """Equal router logits: both packages pick the lowest expert indices."""
    xt = np.ones((5, 4), np.float32)
    router = np.zeros((4, 6), np.float32)
    router[:, 3] = 0.5
    eidx = TM._route(torch.from_numpy(xt), torch.from_numpy(router), 3)[1]
    er = RM._route(jnp.asarray(xt), jnp.asarray(router), 3)[1]
    assert np.array_equal(eidx.numpy(), np.asarray(er))
    assert eidx[0].tolist() == [3, 0, 1]


def test_moe_ffn_runs_on_a_mesh():
    """``moe_ffn`` refuses no mesh: on a 2-shard CPU mesh it runs, and with
    no token dropped its output equals the local path's
    (``tests/test_torch_parallel_train.py`` holds the mesh paths in full)."""
    import dataclasses
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.params import ShardPlan, resolve_dims
    from repro_torch.parallel.sharding import make_mesh
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                              dtype="float32")
    dm = resolve_dims(cfg, ShardPlan())
    g = torch.Generator().manual_seed(0)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": torch.randn(d, e, generator=g),
         "w_in": torch.randn(e, d, f, generator=g) * .1,
         "w_gate": torch.randn(e, d, f, generator=g) * .1,
         "w_out": torch.randn(e, f, d, generator=g) * .1,
         "norm": torch.ones(d)}
    x = torch.randn(2, 4, d, generator=g)
    y, aux = TM.moe_ffn(x, p, cfg, dm, make_mesh(2, ["cpu"]))
    assert float((y - TM.moe_ffn(x, p, cfg, dm)[0]).abs().max()) < 1e-5
    assert bool(torch.isfinite(aux))


# ---------------------------------------------------------------- params
@pytest.mark.parametrize("arch", list_archs())
def test_count_params_matches_reference(arch):
    cfg = get_config(arch)
    assert count_params(cfg) == ref_count(ref_config(arch))
    assert (count_params(cfg, active_only=True)
            == ref_count(ref_config(arch), active_only=True))
    assert cfg.n_params() == ref_config(arch).n_params()

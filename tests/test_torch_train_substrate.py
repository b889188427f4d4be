"""The port's training substrate against the reference's: the checkpoint
manager (the reference's own cases, cross-loads both ways with bf16 leaves,
index checkpoints), the token stream, the prefetcher, the straggler monitor,
the heartbeat and the int8 gradient compression."""
import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as RefManager
from repro.core.rfann import RNSGIndex as RefIndex
from repro.data.tokens import SyntheticTokenStream as RefStream
from repro.data.tokens import TokenStreamConfig as RefStreamConfig
from repro.runtime import fault_tolerance as ref_ft
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.rfann import RNSGIndex
from repro_torch.data.tokens import (Prefetcher, SyntheticTokenStream,
                                     TokenStreamConfig)
from repro_torch.index.io import IndexCorruptionError
from repro_torch.models.lm import Model
from repro_torch.runtime.fault_tolerance import (Heartbeat, StragglerMonitor,
                                                 int8_compress_decompress,
                                                 make_compressed_grad_transform)
from repro_torch.training.train_step import build_train_step, init_train_state
from repro_torch.training.tree import leaves, leaves_with_path, path_key


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small torch ops, cores shared by workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- checkpoint
def _state(seed=0):
    """The reference test's state, as the port's tensors."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                           rng.standard_normal((8, 4)).astype(np.float32)),
                       "b": torch.from_numpy(rng.standard_normal(4)).to(
                           torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _same(a, b):
    for (pa, x), (pb, y) in zip(leaves_with_path(a), leaves_with_path(b)):
        assert pa == pb
        assert x.dtype == y.dtype and x.shape == y.shape, pa
        assert torch.equal(x, y), pa


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    st = _state()
    for step in (10, 20, 30, 40):
        ckpt.save(step, st, blocking=True, extra={"note": "x"})
    assert ckpt.all_steps() == [30, 40]          # gc kept last 2
    back = ckpt.restore({"params": {k: torch.zeros_like(v) for k, v in
                                    st["params"].items()},
                         "opt": {"step": torch.zeros((), dtype=torch.int32)}})
    _same(st, back)
    assert ckpt.meta()["step"] == 40 and ckpt.meta()["note"] == "x"


def test_checkpoint_async_and_atomic(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(5, _state(1), blocking=False)
    ckpt.wait()
    assert ckpt.latest_step() == 5
    # a stale tmp file never shadows a real checkpoint
    (tmp_path / "tmp.99.npz").write_bytes(b"garbage")
    assert ckpt.latest_step() == 5


def test_checkpoint_async_failure_surfaces_on_wait(tmp_path, monkeypatch):
    from repro_torch.checkpoint import checkpoint as mod

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(mod.np, "savez", boom)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(3, _state(), blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ckpt.wait()
    assert ckpt.all_steps() == []


def test_async_save_holds_its_step_while_the_next_step_runs(tmp_path,
                                                            monkeypatch):
    """An async save of a train state, then one more train step (which
    updates the params and moments in place) before the write starts: the
    checkpoint holds the saved step's state bit for bit."""
    from repro_torch.checkpoint import checkpoint as mod
    stepped, savez = threading.Event(), mod.np.savez

    def gated(*a, **k):                  # the write starts after the step
        assert stepped.wait(60)
        savez(*a, **k)
    monkeypatch.setattr(mod.np, "savez", gated)

    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
    model = Model(cfg, device="cpu")
    step_fn = build_train_step(model)
    state = init_train_state(model, torch.Generator().manual_seed(0))
    stream = SyntheticTokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2))
    batches = [{k: torch.as_tensor(v) for k, v in stream.batch_at(i).items()}
               for i in range(2)]
    state, _ = step_fn(state, batches[0])
    saved = {path_key(p): x.clone() for p, x in leaves_with_path(state)}

    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, state, blocking=False)
    state, _ = step_fn(state, batches[1])
    stepped.set()
    ckpt.wait()
    moved = [k for p, x in leaves_with_path(state)
             if not torch.equal(x, saved[k := path_key(p)])]
    assert "opt/m/blocks/attn/wq" in moved and "params/embed" in moved
    back = ckpt.restore(state)
    for p, x in leaves_with_path(back):
        assert torch.equal(x, saved[path_key(p)]), path_key(p)


def test_elastic_restore_onto_a_device_and_into_arrays(tmp_path):
    """The template's dtypes come back on ``device``; a host-array
    template leaf comes back as a host array."""
    ckpt = CheckpointManager(str(tmp_path))
    st = _state(2)
    ckpt.save(1, st, blocking=True)
    back = ckpt.restore(st, device="cpu")
    _same(st, back)
    assert all(t.device.type == "cpu" for t in leaves(back))
    arr = ckpt.restore({"params": {"w": np.zeros((8, 4), np.float64),
                                   "b": np.zeros(4, np.float32)},
                        "opt": {"step": np.zeros((), np.int64)}})
    assert arr["params"]["w"].dtype == np.float64
    assert np.array_equal(arr["params"]["w"], st["params"]["w"].numpy())
    assert int(arr["opt"]["step"]) == 7


def test_checkpoint_keys_are_the_reference_paths(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(2, {"params": {"blocks": {"attn": {"wq": torch.zeros(2, 3)}}},
                  "opt": {"step": torch.tensor(1, dtype=torch.int32)}},
              blocking=True)
    with np.load(tmp_path / "step_0000000002.npz") as z:
        assert sorted(z.files) == ["__meta__", "opt/step",
                                   "params/blocks/attn/wq"]
        assert z["opt/step"].dtype == np.int32


def test_checkpoint_restore_mismatch_names_path_and_step(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(7, {"w": np.zeros(3)}, blocking=True)
    with pytest.raises(KeyError, match=r"step 7 .*no entry for tree path "
                                       r"'missing'"):
        cm.restore({"missing": np.zeros(3)}, step=7)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": np.zeros(3)})


def test_checkpoint_restore_does_not_leak_fds(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"w": torch.arange(8.0)}, blocking=True)
    fd_dir = "/proc/self/fd"
    before = len(os.listdir(fd_dir))
    for _ in range(32):
        cm.restore({"w": torch.zeros(8)})
        cm.meta()
        cm.restore_flat()
    assert len(os.listdir(fd_dir)) <= before + 2


def _ref_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": jnp.asarray(rng.standard_normal((8, 4)),
                                        jnp.float32),
                       "b": jnp.asarray(rng.standard_normal(4), jnp.bfloat16),
                       "blocks": {"norm": jnp.asarray(
                           rng.standard_normal((3, 4)), jnp.bfloat16)}},
            "opt": {"m": {"w": jnp.asarray(rng.standard_normal((8, 4)),
                                           jnp.bfloat16)},
                    "step": jnp.asarray(11, jnp.int32)}}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(
        np.asarray(a, np.float32)).to(torch.bfloat16)
        if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_load(tmp_path, writer):
    """Either package's checkpoint restores in the other, bf16 leaves
    included (stored as f32, re-narrowed on restore), bit for bit; both
    write the same keys and the same arrays."""
    ref_st = _ref_state(3)
    port_st = _to_torch(ref_st)
    RefManager(str(tmp_path / "r")).save(4, ref_st, blocking=True)
    CheckpointManager(str(tmp_path / "p")).save(4, port_st, blocking=True)
    with np.load(tmp_path / "r" / "step_0000000004.npz") as zr, \
            np.load(tmp_path / "p" / "step_0000000004.npz") as zp:
        assert sorted(zr.files) == sorted(zp.files)
        for k in zr.files:
            if k != "__meta__":
                assert zr[k].dtype == zp[k].dtype and \
                    np.array_equal(zr[k], zp[k]), k
    d = str(tmp_path / ("p" if writer == "port" else "r"))
    got_port = CheckpointManager(d).restore(
        jax.tree.map(torch.zeros_like, port_st))
    _same(port_st, got_port)
    got_ref = RefManager(d).restore(jax.tree.map(jnp.zeros_like, ref_st))
    for a, b in zip(jax.tree.leaves(ref_st), jax.tree.leaves(got_ref)):
        assert a.dtype == b.dtype and np.array_equal(
            np.asarray(a, np.float32), np.asarray(b, np.float32))
    assert RefManager(d).meta()["step"] == CheckpointManager(d).meta()[
        "step"] == 4


def _corpus(n, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def test_checkpoint_index_roundtrip_with_quantized(tmp_path):
    v, a = _corpus(300)
    idx = RNSGIndex.build(v, a, m=8, ef_spatial=8, ef_attribute=12,
                          device="cpu")
    idx.install_quantized("int8")
    idx.install_quantized("bf16")
    cm = CheckpointManager(str(tmp_path))
    cm.save_index(5, idx)
    got = cm.restore_index(device="cpu")
    assert isinstance(got, RNSGIndex)
    assert np.array_equal(np.asarray(got.g.nbrs), np.asarray(idx.g.nbrs))
    assert got.g.meta == idx.g.meta
    for p in ("int8", "bf16"):
        want = idx.substrate._quant[p]["data"]
        have = got.substrate._quant[p]["data"]
        assert want.dtype == have.dtype and torch.equal(want, have), p
    assert torch.equal(idx.substrate._quant["int8"]["scale"],
                       got.substrate._quant["int8"]["scale"])
    # the reference's manager restores the port's index checkpoint
    ref = RefManager(str(tmp_path)).restore_index()
    assert np.array_equal(np.asarray(ref.g.nbrs), np.asarray(idx.g.nbrs))


def test_reference_index_checkpoint_restores_in_the_port(tmp_path):
    v, a = _corpus(200)
    ref = RefIndex.build(v, a, m=8, ef_spatial=8, ef_attribute=12)
    RefManager(str(tmp_path)).save_index(2, ref)
    got = CheckpointManager(str(tmp_path)).restore_index(device="cpu")
    assert np.array_equal(np.asarray(got.g.nbrs), np.asarray(ref.g.nbrs))


def test_checkpoint_restore_index_requires_index_manifest(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"w": np.zeros(2)}, blocking=True)
    with pytest.raises(KeyError, match="save_index"):
        cm.restore_index(device="cpu")


def test_checkpoint_manager_corrupt_npz_names_step(tmp_path):
    v, a = _corpus(96)
    idx = RNSGIndex.build(v, a, m=8, ef_spatial=8, ef_attribute=8,
                          device="cpu")
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save_index(7, idx, blocking=True)
    path = tmp_path / "step_0000000007.npz"
    path.write_bytes(path.read_bytes()[:100])           # truncate the zip
    with pytest.raises(IndexCorruptionError) as e:
        cm.restore_index(7, device="cpu")
    assert "step 7" in str(e.value) and path.name in str(e.value)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("markov", [True, False])
@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1), (4, 3)])
def test_token_stream_bit_equal_to_reference(markov, n_hosts, host_id):
    for seed in (0, 5):
        kw = dict(vocab_size=97, seq_len=16, global_batch=8, n_hosts=n_hosts,
                  host_id=host_id, seed=seed, markov_order=markov)
        ref, port = RefStream(RefStreamConfig(**kw)), \
            SyntheticTokenStream(TokenStreamConfig(**kw))
        assert np.array_equal(ref._next, port._next)
        for step in (0, 1, 7, 1000):
            want, got = ref.batch_at(step), port.batch_at(step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in want:
                assert got[k].dtype == want[k].dtype == np.int32
                assert np.array_equal(got[k], want[k]), (seed, step, k)
        it = port.iter_from(3)
        assert np.array_equal(next(it)["tokens"], ref.batch_at(3)["tokens"])


def test_prefetcher_preserves_order_and_raises_the_source_error():
    it = iter([{"i": np.asarray(i)} for i in range(10)])
    assert [int(b["i"]) for b in Prefetcher(it, depth=3)] == list(range(10))

    def bad():
        yield 1
        raise ValueError("source broke")
    p = Prefetcher(bad(), depth=1)
    assert next(p) == 1
    with pytest.raises(ValueError, match="source broke"):
        next(p)


# ---------------------------------------------------------------- runtime
def test_straggler_monitor_verdicts_equal_reference():
    rng = np.random.default_rng(0)
    ref = ref_ft.StragglerMonitor(n_hosts=5, evict_after=3)
    port = StragglerMonitor(n_hosts=5, evict_after=3)
    for i in range(40):
        t = rng.uniform(0.9, 1.1, 5)
        if 5 <= i < 20:
            t[3] += 2.5                         # host 3 straggles, then heals
        if i % 7 == 0:
            t[1] += 4.0                         # a one-step spike
        assert port.record(t) == ref.record(t), i
        assert np.array_equal(port.flags, ref.flags)
    assert list(port.history) == list(ref.history)


def test_straggler_monitor_flags_evicts_and_recovers():
    mon = StragglerMonitor(n_hosts=4, evict_after=3)
    for _ in range(6):
        out = mon.record(np.asarray([1.0, 1.0, 1.0, 3.5]))
    assert out["stragglers"] == [3] and out["evict"] == [3]
    for _ in range(10):
        out = mon.record(np.asarray([1.0, 1.0, 1.0, 1.0]))
    assert mon.flags[3] == 0 and out["evict"] == []


def test_heartbeat_verdicts_equal_reference():
    now = time.monotonic()
    ref, port = ref_ft.Heartbeat(4, timeout=1.0), Heartbeat(4, timeout=1.0)
    for hb in (ref, port):
        hb.beat(0, now)
        hb.beat(1, now - 0.5)
        hb.beat(2, now - 5.0)
        hb.beat(3, now - 1.0)
    for t in (now, now + 0.6, now + 2.0):
        assert port.dead_hosts(t) == ref.dead_hosts(t)
    assert port.dead_hosts(now) == [2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_compression_bit_equal_to_reference(dtype):
    rng = np.random.default_rng(1)
    for i in range(20):
        a = (rng.standard_normal((32, 17)) * 10.0 ** rng.uniform(-4, 3)
             ).astype(np.float32)
        if i == 0:
            a[:] = 0.0                                  # the 1e-12 floor
        want = np.asarray(ref_ft.int8_compress_decompress(
            jnp.asarray(a, getattr(jnp, dtype))), np.float32)
        got = int8_compress_decompress(
            torch.from_numpy(a).to(getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype)
        assert np.array_equal(got.float().numpy(), want), i
    g = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    gq = int8_compress_decompress(g)
    assert float((gq - g).abs().max()) <= float(g.abs().max()) / 127 * 0.5 \
        + 1e-6
    tree = make_compressed_grad_transform()({"a": {"b": g}, "c": g[:2]})
    assert torch.equal(tree["a"]["b"], gq) and torch.equal(tree["c"],
                                                           int8_compress_decompress(g[:2]))

"""The port's write-ahead log (``repro_torch.streaming.wal``) against the
reference's: byte-identical records and segments, logs and checkpoints
written by either package recovering in the other to the same
``index_state``, torn tails, and the crash-point sweep over the port's
insert / delete / checkpoint / compaction lifecycle (``CrashOps``)."""
import threading

import numpy as np
import pytest
import torch

from repro.index import io as jio
from repro.streaming import StreamingRFANN as JStream
from repro.streaming import wal as jwal
from repro_torch.index import io
from repro_torch.streaming import (CrashOps, InjectedCrash,
                                   ReadOnlyIndexError, StreamingRFANN,
                                   WriteAheadLog)
from repro_torch.streaming import wal as walmod

_BUILD = dict(m=8, ef_spatial=8, ef_attribute=8)
_D = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small torch ops, cores shared by workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, _D)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.fixture(scope="module")
def base_ckpt(tmp_path_factory):
    """One pristine streaming index, checkpointed once by the port; every
    crash run and every oracle restores from here."""
    p = tmp_path_factory.mktemp("walbase") / "base"
    vecs, attrs = _corpus()
    io.save_index(StreamingRFANN(vecs, attrs, max_delta=10_000,
                                 device="cpu", **_BUILD), p)
    return p


def _load(p):
    return io.load_index(p, device="cpu")


def _state_equal(fa, ma, fb, mb) -> bool:
    sa, sb = ma["streaming"], mb["streaming"]
    if sa["next_id"] != sb["next_id"] or set(fa) != set(fb):
        return False
    return all(np.array_equal(np.asarray(fa[k]), np.asarray(fb[k]))
               for k in fa)


# ---------------------------------------------------------------- records
def _write_log(mod, d, segment_bytes=4 << 20):
    w = mod.WriteAheadLog(d, sync="always", segment_bytes=segment_bytes)
    vec = np.arange(_D, dtype=np.float32) - 1.5
    for i in range(5):
        w.append_insert(7 + i, 0.25 * i, vec * i)
    w.append_delete(8)
    w.append_barrier(3, 2)
    w.rotate()
    w.append_insert(-3, -1e30, vec)
    w.seal()
    w.close()


@pytest.mark.parametrize("segment_bytes", [4 << 20, 96])
def test_segments_byte_identical_and_cross_replay(tmp_path, segment_bytes):
    """One append sequence writes the same segment files in both packages,
    and each package replays the other's log to the same records."""
    _write_log(walmod, tmp_path / "port", segment_bytes)
    _write_log(jwal, tmp_path / "ref", segment_bytes)
    segs = [p.name for p in walmod.list_segments(tmp_path / "port")]
    assert segs == [p.name for p in jwal.list_segments(tmp_path / "ref")]
    assert len(segs) > 1
    for name in segs:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes())
    for a, b in ((walmod, "ref"), (jwal, "port")):
        got = list(a.replay(tmp_path / b))
        want = list(jwal.replay(tmp_path / "ref"))
        assert [(r.lsn, r.op, r.ext_id, r.generation, r.watermark)
                for r in got] == [(r.lsn, r.op, r.ext_id, r.generation,
                                   r.watermark) for r in want]
        for r, s in zip(got, want):
            assert r.attr == s.attr
            assert (r.vector is None) == (s.vector is None)
            if r.vector is not None:
                assert np.array_equal(r.vector, s.vector)
    assert walmod.describe(tmp_path / "port") == jwal.describe(
        tmp_path / "ref")


def test_record_encoding_equal():
    rec = dict(lsn=41, op=walmod.OP_INSERT, ext_id=2**40, attr=-0.5,
               vector=np.linspace(-1, 1, 9, dtype=np.float32))
    assert walmod._encode(walmod.WalRecord(**rec)) == jwal._encode(
        jwal.WalRecord(**rec))
    for op, kw in ((walmod.OP_DELETE, dict(ext_id=-9)),
                   (walmod.OP_BARRIER, dict(generation=5, watermark=40)),
                   (walmod.OP_SEAL, {})):
        assert walmod._encode(walmod.WalRecord(7, op, **kw)) == jwal._encode(
            jwal.WalRecord(7, op, **kw))


def test_lsn_resumes_and_segments_gc(tmp_path):
    w = WriteAheadLog(tmp_path / "w", sync="always", segment_bytes=64)
    for i in range(12):
        w.append_insert(i, 0.0, np.zeros(_D, np.float32))
    assert w.segment_count > 1 and w.gc(0) == 0
    assert w.gc(12) == w._seq and w.segment_count == 1
    w.close()
    w2 = WriteAheadLog(tmp_path / "w", sync="always")
    assert w2.next_lsn == 13 and w2.append_delete(3) == 13
    w2.close()
    assert walmod.last_lsn(tmp_path / "w") == 13
    with pytest.raises(ValueError, match="sync="):
        WriteAheadLog(tmp_path / "x", sync="sometimes")


def test_concurrent_appends_keep_lsn_in_file_order(tmp_path):
    w = WriteAheadLog(tmp_path / "w", sync="none", segment_bytes=1 << 20)
    vec = np.zeros(_D, np.float32)
    start = threading.Barrier(3)

    def mutate(tid):
        start.wait()
        for i in range(200):
            w.append_insert(tid * 200 + i, 0.0, vec)

    def barriers():
        start.wait()
        for g in range(200):
            w.append_barrier(g, 0)

    ts = [threading.Thread(target=mutate, args=(t,)) for t in (0, 1)]
    ts.append(threading.Thread(target=barriers))
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    w.close()
    assert [r.lsn for r in jwal.replay(tmp_path / "w")] == list(
        range(1, 601))


def test_torn_tail_truncates_in_either_package(tmp_path):
    w = WriteAheadLog(tmp_path / "w", sync="always")
    for i in range(4):
        w.append_insert(i, 0.0, np.zeros(_D, np.float32))
    w.close()
    seg = walmod.list_segments(tmp_path / "w")[-1]
    good = seg.stat().st_size
    with open(seg, "ab") as f:
        f.write(b"\x40\x00\x00\x00\xde\xad")       # half a record
    assert [r.lsn for r in jwal.replay(tmp_path / "w")] == [1, 2, 3, 4]
    assert [r.lsn for r in walmod.replay(tmp_path / "w", truncate=True)] \
        == [1, 2, 3, 4]
    assert seg.stat().st_size == good
    w2 = WriteAheadLog(tmp_path / "w", sync="always")
    assert w2.append_delete(0) == 5
    w2.close()


# -------------------------------------------------- streaming integration
def _churn(idx, n_base):
    """Inserts, a delete of a delta row and of a base row, a checkpoint,
    then more mutations left only in the WAL tail."""
    added = [idx.insert(np.full(_D, i, np.float32), float(i) / 7)
             for i in range(6)]
    idx.delete(added[0])
    idx.delete(3)
    idx.checkpoint()
    for i in range(6, 9):
        idx.insert(np.full(_D, -i, np.float32), -float(i) / 5)
    idx.delete(n_base - 1)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_checkpoint_and_wal_recover_in_both_packages(tmp_path, writer):
    """A checkpoint + WAL tail written by either package recovers in each
    to the same index_state, equal to the writer's live state."""
    vecs, attrs = _corpus()
    if writer == "port":
        idx = StreamingRFANN(vecs, attrs, max_delta=10_000, device="cpu",
                             **_BUILD)
        state = io.index_state
    else:
        idx = JStream(vecs, attrs, max_delta=10_000, **_BUILD)
        state = jio.index_state
    idx.attach_wal(tmp_path / "wal", sync="always")
    idx.set_checkpoint_path(str(tmp_path / "ckpt"))
    _churn(idx, len(vecs))
    want = state(idx)
    idx.close()
    got = StreamingRFANN.recover(tmp_path / "ckpt", tmp_path / "wal",
                                 attach=False, device="cpu")
    ref = JStream.recover(tmp_path / "ckpt", tmp_path / "wal", attach=False)
    assert got.replay_wal(tmp_path / "wal") == 0       # idempotent
    fa, ma = io.index_state(got)
    fb, mb = jio.index_state(ref)
    assert _state_equal(fa, ma, fb, mb)
    assert _state_equal(fa, ma, *want)
    assert sorted(got._id_loc) == sorted(ref._id_loc)


def test_checkpoint_writes_barrier_and_gcs(base_ckpt, tmp_path):
    idx = _load(base_ckpt)
    idx.attach_wal(tmp_path / "wal", sync="always", segment_bytes=128)
    idx.set_checkpoint_path(str(tmp_path / "ckpt"))
    for i in range(10):
        idx.insert(np.full(_D, i, np.float32), float(i))
    assert idx._wal.segment_count > 1
    idx.checkpoint()
    d = walmod.describe(tmp_path / "wal")
    assert d["barrier_watermark"] == idx.applied_lsn and d["segments"] == 1
    rec = StreamingRFANN.recover(tmp_path / "ckpt", tmp_path / "wal",
                                 attach=False, device="cpu")
    assert sorted(rec._id_loc) == sorted(idx._id_loc)


def test_wal_failure_degrades_to_read_only(base_ckpt, tmp_path):
    class _DeadDisk(walmod.FileOps):
        def write(self, fd, data):
            raise OSError(28, "No space left on device")

    idx = _load(base_ckpt)
    idx.attach_wal(tmp_path / "wal", sync="always")
    idx.insert(np.zeros(_D, np.float32), 0.0)
    idx._wal.ops = _DeadDisk()
    with pytest.warns(UserWarning, match="read-only"), \
            pytest.raises(ReadOnlyIndexError):
        idx.insert(np.ones(_D, np.float32), 1.0)
    assert idx.read_only and idx.stats()["read_only"] == 1
    with pytest.raises(ReadOnlyIndexError):
        idx.delete(0)
    res = idx.search(np.zeros((1, _D), np.float32),
                     np.array([[-10.0, 10.0]], np.float32), k=3)
    assert res.ids.shape == (1, 3)


def test_set_compaction_policy_validation(base_ckpt):
    idx = _load(base_ckpt)
    for kw, msg in ((dict(max_delta=0), "max_delta=0"),
                    (dict(compact_every=-1), "compact_every=-1")):
        with pytest.raises(ValueError, match=msg):
            idx.set_compaction_policy(**kw)
    before = (idx.max_delta, idx.compact_every)
    with pytest.raises(ValueError):
        idx.set_compaction_policy(max_delta=-1, compact_every=5)
    assert (idx.max_delta, idx.compact_every) == before


# ---------------------------------------------------------- crash sweeps
def _script():
    """Inserts, deletes of delta and base rows, and a mid-script
    checkpoint ("C", not a mutation) — the reference sweep's script."""
    rng = np.random.default_rng(42)
    ops = [("I", 1000 + i, rng.standard_normal(_D).astype(np.float32),
            float(rng.standard_normal())) for i in range(8)]
    ops += [("D", 3), ("D", 1002), ("C",)]
    ops += [("I", 1000 + i, rng.standard_normal(_D).astype(np.float32),
             float(rng.standard_normal())) for i in range(8, 12)]
    return ops + [("D", 7), ("D", 1005)]


_MUTS = [op for op in _script() if op[0] != "C"]


def _apply(idx, op):
    if op[0] == "I":
        idx.insert(op[2], op[3], ext_id=op[1])
    elif op[0] == "D":
        idx.delete(op[1])


def _oracle_state(base_ckpt, m, _cache={}):
    key = (str(base_ckpt), m)
    if key not in _cache:
        ora = _load(base_ckpt)
        for op in _MUTS[:m]:
            _apply(ora, op)
        _cache[key] = io.index_state(ora)
    return _cache[key]


def _run_to_crash(base_ckpt, rundir, crash_at):
    idx = _load(base_ckpt)
    co = CrashOps(crash_at)
    acked, crashed = 0, False
    try:
        idx.attach_wal(rundir / "wal", sync="always", ops=co)
        idx.set_checkpoint_path(str(rundir / "ckpt"))
        for op in _script():
            if op[0] == "C":
                idx.checkpoint()
            else:
                _apply(idx, op)
                acked += 1
    except InjectedCrash:
        crashed = True
    return acked, crashed, co.ops


def test_crash_sweep_mutations_and_checkpoint(base_ckpt, tmp_path):
    """Kill the WAL at every durability-relevant syscall of the script;
    recovery equals the oracle at the acknowledged prefix (or one more:
    the in-flight record may have reached the disk), and the reference
    recovers the same directories to the same state."""
    acked, crashed, total = _run_to_crash(base_ckpt, tmp_path / "probe", -1)
    assert not crashed and acked == len(_MUTS) and total > 0
    for cat in range(total):
        rundir = tmp_path / f"r{cat}"
        acked, crashed, _ = _run_to_crash(base_ckpt, rundir, cat)
        assert crashed, f"crash_at={cat} never fired"
        if not io.is_index_dir(rundir / "ckpt"):
            assert acked == 0
            continue
        rec = StreamingRFANN.recover(rundir / "ckpt", rundir / "wal",
                                     attach=False, device="cpu")
        fr, mr = io.index_state(rec)
        candidates = {acked, min(acked + 1, len(_MUTS))}
        assert any(_state_equal(fr, mr, *_oracle_state(base_ckpt, m))
                   for m in candidates), f"crash_at={cat}"
        if cat % 5 == 0:        # the reference reads the same directories
            j = JStream.recover(rundir / "ckpt", rundir / "wal",
                                attach=False)
            assert _state_equal(fr, mr, *jio.index_state(j)), cat


def test_crash_sweep_compaction_checkpoint(base_ckpt, tmp_path,
                                           monkeypatch):
    """Crash at every WAL syscall of the checkpoint that follows a
    compaction: the compacted, fully-mutated state recovers bit-identically
    and the whole live set survives."""
    monkeypatch.setattr(threading, "excepthook", lambda args: None)

    def run(rundir, crash_at, do_compact):
        idx = _load(base_ckpt)
        co = CrashOps(crash_at)
        idx.attach_wal(rundir / "wal", sync="always", ops=co)
        idx.set_checkpoint_path(str(rundir / "ckpt"))
        for op in _MUTS:
            _apply(idx, op)
        if do_compact:
            idx.compact(wait=True)  # InjectedCrash lands in the worker
        return co

    t0 = run(tmp_path / "p0", -1, False).ops
    t1 = run(tmp_path / "p1", -1, True).ops
    assert t1 > t0
    ora = _load(base_ckpt)
    for op in _MUTS:
        _apply(ora, op)
    ora.compact(wait=True)
    fo, mo = io.index_state(ora)
    for cat in range(t0, t1):
        rundir = tmp_path / f"c{cat}"
        run(rundir, cat, True)
        rec = StreamingRFANN.recover(rundir / "ckpt", rundir / "wal",
                                     attach=False, device="cpu")
        fr, mr = io.index_state(rec)
        assert _state_equal(fr, mr, fo, mo), f"crash_at={cat}"
        assert sorted(rec._id_loc) == sorted(ora._id_loc)

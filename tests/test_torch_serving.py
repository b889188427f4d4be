"""The port's serving engine (``repro_torch.serving.engine``) and serve
launcher (``repro_torch.launch.serve``) against the reference's: the same
request stream through both engines gives the same ids, cache keys, hit /
miss / dedup counts and metric names; the launcher's rfann mode runs end to
end on the CPU, restores the index it persisted (readable by the
reference), and its streaming mode drains on SIGTERM and restarts; a port
process SIGKILLed mid-churn recovers in both packages to one live set."""
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.rfann import RNSGIndex as JIndex
from repro.data.ann import make_attrs, make_vectors, selectivity_ranges
from repro.index import io as jio
from repro.obs import MetricsRegistry as JRegistry
from repro.serving.engine import RFANNEngine as JEngine
from repro.streaming import StreamingRFANN as JStream
from repro_torch.core.construction import graph_from_arrays
from repro_torch.core.rfann import RNSGIndex
from repro_torch.launch import serve
from repro_torch.obs import CORE_FAMILIES, MetricsRegistry, parse_prometheus
from repro_torch.serving.engine import RFANNEngine
from repro_torch.streaming import StreamingRFANN

ROOT = Path(__file__).resolve().parent.parent
N, D = 256, 16
FIELDS = ("vecs", "attrs", "nbrs", "order", "centroid", "dist_c", "rmq")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small torch ops, cores shared by workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair():
    vecs, attrs = make_vectors(N, D, seed=0), make_attrs(N, seed=0)
    ref = JIndex.build(vecs, attrs, m=16, ef_spatial=16, ef_attribute=24)
    port = RNSGIndex(graph_from_arrays(
        {f: np.asarray(getattr(ref.g, f)) for f in FIELDS}, "cpu"))
    return ref, port, attrs


def _rounds(eng, stream):
    """Submit each round as one burst (one dynamic batch: the round fills
    ``max_batch`` well inside ``max_wait_ms``) and wait for it."""
    out = []
    for qv, rg in stream:
        futs = [eng.submit(qv[i], rg[i]) for i in range(len(qv))]
        out.append([f.result(timeout=120) for f in futs])
    return out


@pytest.mark.parametrize("plan,ef", [("graph", 32), ("auto", N)])
def test_engines_serve_one_stream_alike(plan, ef):
    """Rounds of 8 requests (duplicates inside a round, repeats of earlier
    rounds) through both engines, each with a cache: equal ids per request,
    equal cache keys and counts, equal batch, dedup and hit totals, and the
    same metric names in both registries."""
    ref, port, attrs = _pair()
    rng = np.random.default_rng(3)
    pool_q = make_vectors(12, D, seed=5)
    pool_r = selectivity_ranges(attrs, 12, 0.1, seed=6)
    stream = []
    for _ in range(4):
        pick = rng.integers(0, 12, 8)
        stream.append((pool_q[pick], pool_r[pick]))
    kw = dict(k=5, ef=ef, plan=plan, max_batch=8, max_wait_ms=500.0,
              cache_bytes=1 << 20, trace_sample_every=2)
    engines = (RFANNEngine(port, metrics=MetricsRegistry(), **kw),
               JEngine(ref, metrics=JRegistry(), **kw))
    try:
        got, want = (_rounds(e, stream) for e in engines)
    finally:
        for e in engines:
            e.close()
    for rg, rw in zip(got, want):
        for a, b in zip(rg, rw):
            assert np.array_equal(a.ids, b.ids)
            assert np.allclose(a.dists, b.dists, rtol=1e-5, atol=1e-4)
    e_got, e_want = engines
    assert list(e_got.cache._d) == list(e_want.cache._d)
    assert e_got.cache.snapshot() == e_want.cache.snapshot()
    for s in ("served", "batches", "cache_hits", "dedup_hits"):
        assert getattr(e_got.stats, s) == getattr(e_want.stats, s), s
    assert e_got.stats.batches == 4 and e_got.stats.dedup_hits > 0
    s_got, s_want = e_got.metrics(), e_want.metrics()
    assert sorted(s_got) == sorted(s_want)
    for sec in s_want:
        assert sorted(s_got[sec]) == sorted(s_want[sec]), sec
    for name in ("engine_requests_total", "queries_total",
                 "cache_hit_rows_total", "cache_miss_rows_total",
                 "cache_dedup_rows_total"):
        assert s_got["counters"][name] == s_want["counters"][name], name
    assert {"resolve", "dispatch", "stitch"} <= set(
        e_got.last_trace.names())


def test_engine_concurrent_submits_and_swap_index():
    """Client threads all served and counted; a swap invalidates the cache
    and later answers come from the new index."""
    _, port, attrs = _pair()
    other = RNSGIndex.build(make_vectors(N, D, seed=1), attrs, m=16,
                            ef_spatial=16, ef_attribute=24, device="cpu")
    eng = RFANNEngine(port, k=5, ef=32, plan="auto", max_batch=16,
                      max_wait_ms=1.0, cache_bytes=1 << 20)
    try:
        qs = np.random.default_rng(0).standard_normal(
            (3, 12, D)).astype(np.float32)
        errs = []

        def client(t):
            try:
                for f in [eng.submit(qs[t, i], (0.2, 0.8))
                          for i in range(12)]:
                    assert f.result(timeout=60).ids.shape == (5,)
            except Exception as e:
                errs.append(e)

        ts = [threading.Thread(target=client, args=(t,)) for t in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs and eng.stats.served == 36
        assert eng.metrics()["counters"]["queries_total"] == 36
        eng.swap_index(other)
        assert len(eng.cache) == 0 and eng.cache.invalidations == 1
        got = eng.submit(qs[0, 0], (0.2, 0.8)).result(timeout=60)
        want = other.search(qs[0, :1], np.asarray([[0.2, 0.8]], np.float32),
                            k=5, ef=32, plan="auto")
        assert np.array_equal(got.ids, want.ids[0])
    finally:
        eng.close()


def test_engine_close_persists_index_and_calibration(tmp_path):
    """``close()`` writes the served index (read back by the reference)
    and the planner's calibration."""
    _, port, attrs = _pair()
    port.install_quantized("int8")
    eng = RFANNEngine(port, k=5, ef=32, precision="int8", max_wait_ms=1.0,
                      index_path=str(tmp_path / "idx"), index_save_shards=2,
                      calibration_path=str(tmp_path / "cal.json"))
    qv = make_vectors(4, D, seed=9)
    for i in range(4):
        eng.submit(qv[i], (0.1, 0.9)).result(timeout=60)
    eng.close()
    assert json.loads((tmp_path / "cal.json").read_text())
    ref = jio.load_index(tmp_path / "idx")
    assert np.array_equal(np.asarray(ref.g.nbrs), port.g.nbrs.numpy())
    assert "int8" in ref.substrate._quant


def test_engine_forwards_compaction_policy():
    rng = np.random.default_rng(6)
    s = StreamingRFANN(rng.standard_normal((96, 8)).astype(np.float32),
                       rng.random(96).astype(np.float32), m=8,
                       max_delta=10**9, device="cpu")
    with pytest.raises(ValueError, match=r"max_delta=0"):
        RFANNEngine(s, max_delta=0)
    eng = RFANNEngine(s, max_wait_ms=0.5, max_delta=7, compact_every=123)
    try:
        assert s.max_delta == 7 and s.compact_every == 123
        for _ in range(7):
            eng.insert(rng.standard_normal(8).astype(np.float32),
                       float(rng.random()))
        s.close()
        assert s.compactions == 1 and s.stats()["n_delta"] == 0
    finally:
        eng.close()
        s.close()


# ----------------------------------------------------------------- launcher
_SMALL = ["--device", "cpu", "--n", "1024", "--dim", "16", "--m", "16"]


def test_launcher_rfann_end_to_end_and_restore(tmp_path, capsys):
    """Build, serve, persist; then restore (no rebuild) at int8 / bw 4; the
    metrics dump holds every core family; the reference reads the index."""
    idx, cal, prom = (str(tmp_path / x) for x in ("idx", "cal.json",
                                                  "m.prom"))
    common = _SMALL + ["--requests", "96", "--cache-mb", "4",
                       "--index-path", idx, "--index-shards", "4",
                       "--calibration", cal, "--metrics-path", prom]
    first = serve.main(common)
    out = capsys.readouterr().out
    assert "building RNSG index" in out and "index persisted" in out
    assert first["served"] == 96 and first["recall"] > 0.9
    assert first["restored"] is None and "live_ids" not in first
    assert first["summary"]["served"] == 96
    names = {n for n, _ in parse_prometheus(Path(prom).read_text())}
    for fam in CORE_FAMILIES:
        assert any(n == fam or n.startswith(fam + "_") for n in names), fam
    assert json.loads(Path(prom + ".json").read_text())["engine"]
    ref = jio.load_index(idx)
    assert ref.g.n == 1024
    again = serve.main(common + ["--precision", "int8", "--beam-width", "4",
                                 "--rate", "2000"])
    out = capsys.readouterr().out
    assert "restored index" in out and "(no rebuild)" in out
    assert again["restored"]["seconds"] >= 0
    assert again["recall"] > 0.9
    assert "int8" in jio.load_index(idx).substrate._quant


def test_launcher_refuses_other_slices(capsys):
    """Every mode and option the launcher names is served now: ``--mode lm``
    (the LM-scaffold slice) returns its tokens, ``--build-shards`` (the
    multi-device slice) builds through the sharded constructor."""
    toks = serve.main(["--mode", "lm", "--device", "cpu", "--max-batch", "2",
                       "--new-tokens", "2"])
    assert toks.shape == (2, 3)
    assert "sample continuation ids" in capsys.readouterr().out
    rec = serve.main(_SMALL + ["--requests", "16", "--build-shards", "2"])
    assert rec["served"] == 16
    assert "building RNSG index (2 shards)" in capsys.readouterr().out


def test_launcher_imports_no_lm_code():
    code = ("import sys\n"
            "import repro_torch.launch.serve\n"
            "bad = [m for m in sys.modules if m.startswith(("
            "'repro_torch.models', 'repro_torch.configs', 'jax', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_launcher_streaming_record_carries_restore_and_live_set(tmp_path):
    """The streaming launcher's record: after a build no restore and the
    final live set; a restart on the same directories reports the WAL
    records it replayed and the live set right after the replay, whose
    digest is the corpus rows' at those ids (ext id = corpus row)."""
    from repro_torch.data.ann import make_attrs as p_attrs
    from repro_torch.data.ann import make_vectors as p_vectors
    argv = ["--device", "cpu", "--n", "400", "--dim", "8", "--m", "8",
            "--max-delta", "64", "--requests", "64", "--wal-dir",
            str(tmp_path / "wal"), "--index-path", str(tmp_path / "ckpt")]
    first = serve.main(argv)
    assert first["restored"] is None
    ids = first["live_ids"]
    assert np.array_equal(ids, np.unique(ids)) and len(ids) > 320
    vecs, attrs = p_vectors(400, 8, seed=0), p_attrs(400, seed=0)
    assert first["live_digest"] == serve.live_digest(ids, attrs[ids],
                                                     vecs[ids])
    again = serve.main(argv[:argv.index("--requests")] + ["--requests", "8"]
                       + argv[argv.index("--requests") + 2:])
    got = again["restored"]
    assert got["replayed"] == 0         # a clean shutdown checkpoints all
    assert np.array_equal(got["live_ids"], ids)
    assert got["live_digest"] == first["live_digest"]
    assert again["live_digest"] == serve.live_digest(
        again["live_ids"], attrs[again["live_ids"]],
        vecs[again["live_ids"]])


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_launcher_streaming_sigterm_drains_and_restarts(tmp_path):
    """SIGTERM on the port's streaming server: graceful drain, WAL sealed,
    index checkpointed, exit 0; a restart restores and replays the WAL,
    and the reference recovers the same directories to the same live
    set."""
    wal, ckpt = tmp_path / "wal", tmp_path / "ckpt"
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
            "rfann", "--device", "cpu", "--n", "400", "--dim", "8", "--m",
            "8", "--max-delta", "64", "--requests", "100000", "--rate", "40",
            "--wal-dir", str(wal), "--index-path", str(ckpt)]
    proc = subprocess.Popen(argv, env=_child_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    deadline = time.time() + 240
    try:
        while time.time() < deadline:
            if (ckpt / "manifest.json").exists() and wal.is_dir() \
                    and any(wal.iterdir()):
                break
            assert proc.poll() is None, "serve exited before starting"
            time.sleep(0.2)
        time.sleep(3.0)                         # let churn land in the WAL
        proc.terminate()
        out = proc.communicate(timeout=180)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"serve did not exit cleanly:\n{out[-2000:]}"
    assert "SIGTERM: draining" in out and "index persisted" in out
    port = StreamingRFANN.recover(ckpt, wal, attach=False, device="cpu")
    ref = JStream.recover(ckpt, wal, attach=False)
    assert sorted(port._id_loc) == sorted(ref._id_loc)
    argv2 = argv[:argv.index("--requests")] + [
        "--requests", "16", "--wal-dir", str(wal), "--index-path", str(ckpt)]
    out2 = subprocess.run(argv2, env=_child_env(), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, timeout=240,
                          check=True).stdout.decode(errors="replace")
    assert "restored index" in out2 and "replayed" in out2


def test_port_churn_survives_sigkill_in_both_packages(tmp_path):
    """The port's engine churns with a WAL in a child process that is
    SIGKILLed mid-churn: the port and the reference each recover the
    checkpoint + WAL tail to the same live set, which holds every
    acknowledged mutation."""
    child_py = Path(__file__).with_name("_torch_wal_churn_child.py")
    spec = importlib.util.spec_from_file_location(
        "_wal_churn_child", Path(__file__).with_name("_wal_churn_child.py"))
    child = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(child)
    wal, ckpt, ack = tmp_path / "wal", tmp_path / "ckpt", tmp_path / "ack"
    proc = subprocess.Popen(
        [sys.executable, str(child_py), str(wal), str(ckpt), str(ack)],
        env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    target, acked = 120, 0
    deadline = time.time() + 240
    try:
        while time.time() < deadline:
            if ack.exists():
                ints = [int(x) for x in ack.read_text().split()
                        if x.isdigit()]
                acked = ints[-1] if ints else 0
                if acked >= target:
                    break
            if proc.poll() is not None:
                break
            time.sleep(0.05)
    finally:
        proc.kill()                             # SIGKILL mid-churn
        out = proc.communicate(timeout=60)[0]
    assert acked >= target, out.decode(errors="replace")[-2000:]
    port = StreamingRFANN.recover(ckpt, wal, attach=False, device="cpu")
    ref = JStream.recover(ckpt, wal, attach=False)
    got = set(port._id_loc)
    assert got == set(ref._id_loc)
    n = len(child.script())
    assert any(got == child.live_after(m) for m in range(acked, n + 1)), (
        f"recovered live set matches no prefix >= acked={acked}")
    res = port.search(np.zeros((1, child.D), np.float32),
                      np.array([[-10.0, 10.0]], np.float32), k=5)
    assert all(int(i) in got for i in res.ids[0] if i >= 0)

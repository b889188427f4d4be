"""The port's index directory format (``repro_torch.index.io``) against the
reference's (``repro.index.io``): a directory written by either package,
int8 and bf16 corpora included, loads in the other to the same
``index_state``; one state saved by each writes the same bytes; restore
lands on an explicit device; corruption is named as the reference names
it; and ``RNSGIndex.save(shards=...)`` / ``load`` of a directory work."""
import json
import os

import numpy as np
import pytest
import torch

from repro.core.rfann import RNSGIndex as JIndex
from repro.index import io as jio
from repro.streaming import StreamingRFANN as JStream
from repro_torch.core.construction import graph_from_arrays
from repro_torch.core.rfann import RNSGIndex
from repro_torch.index import io
from repro_torch.streaming import StreamingRFANN

D = 16
FIELDS = ("vecs", "attrs", "nbrs", "order", "centroid", "dist_c", "rmq")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small torch ops, cores shared by workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n, d=D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def _same_state(a, b):
    """Two (flat, manifest) pairs hold the same arrays and manifest."""
    fa, ma = a
    fb, mb = b
    assert sorted(fa) == sorted(fb)
    for key in fa:
        x, y = np.asarray(fa[key]), np.asarray(fb[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert np.array_equal(x, y), key
    assert json.loads(json.dumps(ma)) == json.loads(json.dumps(mb))


def _rnsg_pair(n=300, precisions=("int8", "bf16")):
    v, a = _corpus(n)
    ref = JIndex.build(v, a, m=8, ef_spatial=8, ef_attribute=12)
    arrays = {f: np.asarray(getattr(ref.g, f)) for f in FIELDS}
    arrays.update(build_seconds=ref.g.build_seconds, meta=dict(ref.g.meta))
    port = RNSGIndex(graph_from_arrays(arrays, "cpu"))
    for p in precisions:
        ref.install_quantized(p)
        port.install_quantized(p)
    return ref, port


def _stream_pair(n=200, precisions=("int8",)):
    """A reference streaming index with tombstones and a delta, and the
    port's restored from its state."""
    v, a = _corpus(n)
    ref = JStream(v, a, m=8, ef_spatial=8, ef_attribute=8, max_delta=10**6)
    for p in precisions:
        ref.install_quantized(p)
    rng = np.random.default_rng(3)
    for _ in range(12):
        ref.insert(rng.normal(size=D).astype(np.float32),
                   float(rng.normal()))
    for e in (1, 5, n + 4):                  # two base rows + one delta row
        ref.delete(e)
    flat, man = jio.index_state(ref)
    port = io.index_from_state({k: np.asarray(x) for k, x in flat.items()},
                               man, device="cpu")
    return ref, port


def _files(p):
    return {f: (p / f).read_bytes() for f in sorted(os.listdir(p))}


@pytest.mark.parametrize("shards", [1, 3])
def test_rnsg_dir_bytes_equal_the_reference(tmp_path, shards):
    """One index state, quantized corpora included, saved by each package:
    the same file names and bytes, manifest and CRCs included."""
    ref, port = _rnsg_pair()
    _same_state(io.index_state(port), jio.index_state(ref))
    io.save_index(port, tmp_path / "port", shards=shards)
    jio.save_index(ref, tmp_path / "ref", shards=shards)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_rnsg_dir_cross_loads(tmp_path, writer):
    """Written by either package, read by both: the same index_state, and
    the port's restored index searches as the index it was saved from, at
    f32, int8 and bf16."""
    ref, port = _rnsg_pair()
    p = tmp_path / "idx"
    (io.save_index(port, p, shards=2) if writer == "port"
     else jio.save_index(ref, p, shards=2))
    got_port, got_ref = io.load_index(p, device="cpu"), jio.load_index(p)
    assert got_port.g.vecs.device.type == "cpu"
    assert got_port.substrate._quant["bf16"]["data"].dtype == torch.bfloat16
    _same_state(io.index_state(got_port), jio.index_state(got_ref))
    _same_state(io.index_state(got_port), jio.index_state(ref))
    rng = np.random.default_rng(2)
    q = rng.normal(size=(12, D)).astype(np.float32)
    r = np.sort(rng.normal(size=(12, 2)).astype(np.float32), axis=1)
    for plan in ("graph", "scan"):
        for prec in ("f32", "int8", "bf16"):
            want = port.search(q, r, k=4, plan=plan, precision=prec)
            have = got_port.search(q, r, k=4, plan=plan, precision=prec)
            assert np.array_equal(want.ids, have.ids), (plan, prec)
            assert np.array_equal(want.dists, have.dists), (plan, prec)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_streaming_dir_cross_loads(tmp_path, writer):
    ref, port = _stream_pair()
    _same_state(io.index_state(port), jio.index_state(ref))
    p = tmp_path / "s"
    (io.save_index(port, p, shards=2) if writer == "port"
     else jio.save_index(ref, p, shards=2))
    got_port, got_ref = io.load_index(p, device="cpu"), jio.load_index(p)
    assert isinstance(got_port, StreamingRFANN)
    assert got_port._precisions == {"int8"}
    assert got_port._view.n_tombstones == 2
    _same_state(io.index_state(got_port), jio.index_state(got_ref))
    rng = np.random.default_rng(4)
    q = rng.normal(size=(10, D)).astype(np.float32)
    r = np.sort(rng.normal(size=(10, 2)).astype(np.float32), axis=1)
    for prec in ("f32", "int8"):
        want = got_ref.search(q, r, k=4, plan="scan", precision=prec)
        have = got_port.search(q, r, k=4, plan="scan", precision=prec)
        assert np.array_equal(want.ids, have.ids), prec
    nid = got_port.insert(np.zeros(D, np.float32), 0.0)
    assert nid == ref._next_id           # ids keep advancing from the ckpt


def test_streaming_dir_bytes_equal_the_reference(tmp_path):
    ref, port = _stream_pair()
    io.save_index(port, tmp_path / "port")
    jio.save_index(ref, tmp_path / "ref")
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


@pytest.mark.parametrize("shards", [1, 4])
def test_rnsg_save_and_load_a_directory(tmp_path, shards):
    v, a = _corpus(400)
    idx = RNSGIndex.build(v, a, m=8, ef_spatial=8, ef_attribute=12,
                          device="cpu")
    idx.install_quantized("int8")
    p = str(tmp_path / "idx")
    idx.save(p, shards=shards)
    man = json.loads((tmp_path / "idx" / "manifest.json").read_text())
    if shards > 1:
        assert shards in {len(am["files"]) for am in man["arrays"].values()}
    got = RNSGIndex.load(p, device="cpu")
    rng = np.random.default_rng(2)
    q = rng.normal(size=(12, D)).astype(np.float32)
    r = np.sort(rng.normal(size=(12, 2)).astype(np.float32), axis=1)
    for plan in ("graph", "scan", "auto"):
        for prec in ("f32", "int8"):
            want = idx.search(q, r, k=4, plan=plan, precision=prec)
            have = got.search(q, r, k=4, plan=plan, precision=prec)
            assert np.array_equal(want.ids, have.ids), (plan, prec)
    if not torch.cuda.is_available():    # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RNSGIndex.load(p)


def test_generations_gc(tmp_path):
    v, a = _corpus(128)
    idx = RNSGIndex.build(v, a, m=8, ef_spatial=8, ef_attribute=8,
                          device="cpu")
    p = str(tmp_path / "d")
    m0 = io.save_index(idx, p, shards=2)
    m1 = io.save_index(idx, p, shards=3)
    assert (m0["gen"], m1["gen"]) == (0, 1)
    files = [f for f in os.listdir(p) if f != "manifest.json"]
    assert files and all(".g1." in f for f in files)
    got = io.load_index(p, device="cpu")
    assert torch.equal(got.g.nbrs, idx.g.nbrs)


def test_rnsg_load_rejects_streaming_dir(tmp_path):
    v, a = _corpus(128)
    s = StreamingRFANN(v, a, m=8, ef_spatial=8, ef_attribute=8,
                       device="cpu")
    p = str(tmp_path / "s")
    io.save_index(s, p)
    with pytest.raises(TypeError, match="StreamingRFANN"):
        RNSGIndex.load(p, device="cpu")


def _saved_dir(tmp_path, shards=1):
    v, a = _corpus(128)
    idx = RNSGIndex.build(v, a, m=8, ef_spatial=8, ef_attribute=8,
                          device="cpu")
    p = tmp_path / "d"
    io.save_index(idx, str(p), shards=shards)
    return p


def _corrupt_last_byte(p, key, i):
    man = json.loads((p / "manifest.json").read_text())
    fn = man["arrays"][key]["files"][i]
    blob = bytearray((p / fn).read_bytes())
    blob[-1] ^= 0xFF
    (p / fn).write_bytes(bytes(blob))
    return fn


def test_truncated_file_names_file_and_generation(tmp_path):
    p = _saved_dir(tmp_path)
    man = json.loads((p / "manifest.json").read_text())
    fn = man["arrays"]["graph/nbrs"]["files"][0]
    (p / fn).write_bytes((p / fn).read_bytes()[:16])
    with pytest.raises(io.IndexCorruptionError) as e:
        io.load_index(str(p), device="cpu")
    assert fn in str(e.value) and "manifest generation 0" in str(e.value)


def test_missing_file_names_file(tmp_path):
    p = _saved_dir(tmp_path)
    man = json.loads((p / "manifest.json").read_text())
    (p / man["arrays"]["graph/rmq"]["files"][0]).unlink()
    with pytest.raises(io.IndexCorruptionError, match="missing"):
        io.load_index(str(p), device="cpu")


def test_crc_mismatch_sharded_and_verified(tmp_path):
    p = _saved_dir(tmp_path / "a", shards=2)
    _corrupt_last_byte(p, "graph/vecs", 1)
    with pytest.raises(io.IndexCorruptionError, match="CRC32 mismatch"):
        io.load_index(str(p), device="cpu")
    p = _saved_dir(tmp_path / "b", shards=1)
    _corrupt_last_byte(p, "graph/vecs", 0)
    io.load_index(str(p), device="cpu")     # lazy mmap: not detected ...
    with pytest.raises(io.IndexCorruptionError, match="CRC32 mismatch"):
        io.load_index(str(p), device="cpu", verify=True)


def test_fsync_dir_tolerates_missing_and_plain_paths(tmp_path):
    io.fsync_dir(tmp_path)
    io.fsync_dir(tmp_path / "nope")
    f = tmp_path / "f.txt"
    f.write_text("x")
    io.fsync_dir(f)

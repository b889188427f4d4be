"""The port stands alone: it imports neither ``jax`` nor ``repro``, imports
without CUDA or ``nvcc``, and its entry points refuse to run on a missing
card instead of falling back to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
#: the port's scripts and benchmark driver, which stand alone like it
SCRIPTS = [ROOT / "benchmarks" / "run_torch.py",
           ROOT / "benchmarks" / "common_torch.py",
           ROOT / "benchmarks" / "hop_profile_torch.py",
           ROOT / "benchmarks" / "kernel_profile_torch.py",
           ROOT / "chip_smoke.py", ROOT / "ab_qps.py"]


def _imported_modules(py: Path):
    for node in ast.walk(ast.parse(py.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_repro():
    """Nor ``benchmarks.common``, which imports ``repro``."""
    offenders = []
    for py in sorted(PORT.rglob("*.py")) + SCRIPTS:
        for mod in _imported_modules(py):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro") or mod in (
                    "benchmarks.common", "benchmarks.run"):
                offenders.append(f"{py.relative_to(ROOT)}: {mod}")
    assert not offenders, offenders


def test_port_modules_all_present():
    want = ["kernels/ref.py", "kernels/range_scan.py", "kernels/gather_dist.py",
            "kernels/ops.py", "kernels/_build.py", "data/ann.py",
            "index/knn.py", "core/entry.py", "core/pruning.py",
            "core/construction.py", "core/beam.py", "search/request.py",
            "search/resolve.py", "planner/bucketing.py", "planner/cost.py",
            "planner/planner.py", "obs/trace.py", "search/substrate.py",
            "core/rfann.py", "kernels/quantize.py", "csrc/range_scan.cu",
            "csrc/gather_dist.cu", "csrc/corpus.cuh", "csrc/topk_key.cuh",
            "kernels/l2dist.py", "csrc/l2dist.cu", "index/baselines.py",
            "obs/metrics.py", "obs/export.py", "obs/profiler.py",
            "search/cache.py", "index/io.py", "serving/engine.py",
            "streaming/wal.py", "streaming/delta.py",
            "streaming/streaming.py", "runtime/fault_tolerance.py",
            "launch/serve.py", "core/exact.py", "configs/base.py",
            "configs/registry.py", "configs/llama3_8b.py",
            "configs/mixtral_8x7b.py", "configs/mamba2_780m.py",
            "configs/jamba_1_5_large_398b.py", "configs/starcoder2_15b.py",
            "configs/qwen1_5_4b.py", "configs/qwen2_5_14b.py",
            "configs/seamless_m4t_large_v2.py",
            "configs/llama_3_2_vision_11b.py",
            "configs/llama4_maverick_400b_a17b.py", "models/params.py",
            "models/layers.py", "models/attention.py", "models/ssm.py",
            "models/moe.py", "models/lm.py", "launch/specs.py",
            "data/tokens.py", "training/optim.py", "training/train_step.py",
            "training/tree.py", "checkpoint/checkpoint.py",
            "parallel/pipeline.py", "launch/train.py"]
    assert [p for p in want if not (PORT / p).exists()] == []


def test_imports_with_jax_blocked_and_no_cuda(tmp_path):
    """Every module, and the benchmark driver, imports in a fresh process
    where ``import jax`` fails, no CUDA device is visible and no ``nvcc`` is
    on the PATH."""
    mods = sorted(".".join(("repro_torch",) + p.relative_to(PORT)
                           .with_suffix("").parts).replace(".__init__", "")
                  for p in PORT.rglob("*.py"))
    mods += ["benchmarks.common_torch", "benchmarks.run_torch"]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k in sys.modules if sys.modules[k])\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               CUDA_VISIBLE_DEVICES="", PATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.rfann import RNSGIndex
    from repro_torch.index.baselines import (add_reverse_edges,
                                             connectivity_repair)
    from repro_torch.launch import serve
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models.lm import Model
    from repro_torch.data.ann import ground_truth, make_attrs, make_vectors
    from repro_torch.search import SearchSubstrate
    v, a = make_vectors(64, 4), make_attrs(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RNSGIndex.build(v, a, m=4, ef_spatial=4, ef_attribute=4)
    idx = RNSGIndex.build(v, a, m=4, ef_spatial=4, ef_attribute=4,
                          device="cpu")
    idx.save(str(tmp_path / "g.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RNSGIndex.load(str(tmp_path / "g.npz"))
    g = idx.g
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchSubstrate(g.vecs, g.nbrs, g.rmq, g.dist_c, g.order, g.attrs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ground_truth(v, a, v[:2], np.asarray([[0, 1], [0, 1]], np.float32), 2)
    res = RNSGIndex.load(str(tmp_path / "g.npz"), device="cpu").search(
        v[:2], np.asarray([[0, 1], [0, 1]], np.float32), k=3)
    assert res.ids.shape == (2, 3)
    nb = np.asarray(g.nbrs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        add_reverse_edges(nb, 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        connectivity_repair(nb, v[np.argsort(a, kind="stable")], 0)
    assert add_reverse_edges(nb, 6, device="cpu").shape == (64, 6)
    cfg = get_smoke_config("llama3-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        concrete_batch(cfg, "prefill", 2, 8, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--mode", "lm", "--new-tokens", "1"])
    assert Model(cfg, device="cpu").device.type == "cpu"
    from repro_torch.launch import train
    from repro_torch.training.train_step import init_train_state
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(Model(cfg), torch.Generator())
    st = init_train_state(Model(cfg, device="cpu"), torch.Generator())
    assert st["opt"]["step"].device.type == "cpu"
    assert train.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                       "--seq", "8", "--arch", "qwen1.5-4b"])[1]


def test_kernel_build_needs_nvcc(monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_kernel_library_name_follows_source_hash(tmp_path, monkeypatch):
    """An edited source (or header) gets a new library name, so a stale
    build is never loaded."""
    from repro_torch.kernels import _build
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.target(n) for n in _build.SIGNATURES}
    with open(tmp_path / "range_scan.cu", "a") as f:
        f.write("\n// edit\n")
    assert _build.target("range_scan") != before["range_scan"]
    assert _build.target("gather_dist") == before["gather_dist"]
    with open(tmp_path / "topk_key.cuh", "a") as f:
        f.write("\n// edit\n")
    assert _build.target("gather_dist") != before["gather_dist"]
    assert _build.target("gather_dist").parent == _build.BUILD_DIR


def test_serving_entry_points_raise_without_a_card(no_card, tmp_path):
    """The streaming index, the index directory restore and the serve
    launcher default to the card too."""
    from repro_torch.core.rfann import RNSGIndex
    from repro_torch.data.ann import make_attrs, make_vectors
    from repro_torch.index import io
    from repro_torch.launch import serve
    from repro_torch.streaming import DeltaView, StreamingRFANN
    v, a = make_vectors(64, 4), make_attrs(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingRFANN(v, a, m=4, ef_spatial=4, ef_attribute=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeltaView.empty(4)
    RNSGIndex.build(v, a, m=4, ef_spatial=4, ef_attribute=4,
                    device="cpu").save(str(tmp_path / "d"), shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        io.load_index(tmp_path / "d")
    assert io.load_index(tmp_path / "d", device="cpu").g.n == 64
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--n", "64", "--dim", "4", "--requests", "8"])

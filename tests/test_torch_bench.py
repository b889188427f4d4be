"""The port's benchmark driver (``benchmarks/run_torch.py``) at a tiny size
on the CPU: each ported bench writes the reference driver's columns (the
kernel table's TPU roofline becomes the card's bound, beside the library
yardstick and the device), exact methods score recall 1.0, output stays
under ``results/bench_torch/``, and an unknown bench refuses the run."""
import csv
from pathlib import Path

import numpy as np
import pytest
import torch

import benchmarks.common_torch as ct
import benchmarks.run_torch as rt
from benchmarks.common import recall_at_k as ref_recall_at_k

ROOT = Path(__file__).resolve().parent.parent
N, D, NQ = 512, 8, 20

#: the reference driver's columns, from the committed tables where there are
#: any (results/bench/*.csv), else from the dict keys of benchmarks/run.py
REF_COLUMNS = {
    "qps_recall": ["method", "workload", "ef", "recall", "qps"],
    "construction_time": ["method", "build_seconds"],
    "index_size": ["method", "index_mb"],
    "param_sensitivity": ["param", "value", "build_seconds", "recall", "qps",
                          "edges"],
    "vary_k": ["k", "recall", "qps"],
    "scalability": ["n", "build_seconds", "index_mb", "recall", "qps",
                    "mean_hops"],
    "kernels": ["kernel", "shape", "us_per_call", "gflops_at_wall",
                "tpu_roofline_us"],
}
for _name in ("planner", "search_substrate", "mesh_auto", "beam_width",
              "quantized", "async_cache", "streaming", "build", "wal"):
    with open(ROOT / "results" / "bench" / f"{_name}.csv") as _f:
        REF_COLUMNS[_name] = next(csv.reader(_f))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small torch ops, and with
    the test workers sharing the cores, more threads only add waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def results(tmp_path, monkeypatch):
    monkeypatch.setattr(ct, "RESULTS", tmp_path / "bench_torch")
    return tmp_path / "bench_torch"


@pytest.fixture(scope="module")
def methods():
    vecs, attrs = ct.dataset(N, D)
    return ct.build_methods(vecs, attrs, True, "cpu")


def _run(name, methods):
    if name in ("qps_recall",):
        return rt.bench_qps_recall(N, D, NQ, True, "cpu", methods)
    if name in ("construction_time", "index_size"):
        return getattr(rt, f"bench_{name}")(N, D, True, "cpu", methods)
    if name == "scalability":
        return rt.bench_scalability(D, NQ, True, "cpu")
    if name == "kernels":
        return rt.bench_kernels(True, "cpu")
    if name in ("wal", "build"):
        return getattr(rt, f"bench_{name}")(N, D, True, "cpu")
    return getattr(rt, f"bench_{name}")(N, D, NQ, True, "cpu")


@pytest.mark.parametrize("name", rt.ALL)
def test_bench_writes_the_reference_columns(name, methods, results):
    rows = _run(name, methods)
    want = REF_COLUMNS[name]
    if name == "kernels":
        want = [c if c != "tpu_roofline_us" else "bound_us" for c in want]
        want += ["library_us", "device"]
    assert rows and list(rows[0]) == want
    with open(results / f"{name}.csv") as f:
        table = list(csv.DictReader(f))
    assert len(table) == len(rows) and list(table[0]) == want
    if name == "qps_recall":
        brute = [r for r in rows if r["method"] == "brute"]
        assert len(brute) == 4 and all(r["recall"] == 1.0 for r in brute)
        assert {r["method"] for r in rows} == set(methods)
    if name == "planner":
        assert all(r["recall"] == 1.0 for r in rows if r["method"] == "brute")
    if name == "kernels":
        assert {r["kernel"] for r in rows} == {
            "l2dist", "l2dist_ref", "gather_dist", "gather_dist_ref"}
        assert all(r["device"] == "cpu" and r["bound_us"] > 0 for r in rows)
    if name in ("search_substrate", "beam_width", "quantized", "streaming",
                "wal", "build"):
        stem = {"search_substrate": "substrate", "beam_width": "beam",
                "quantized": "quant", "streaming": "stream",
                "wal": "wal", "build": "build"}[name]
        assert (results / f"BENCH_pt_{stem}.json").exists()
    if name == "async_cache":
        assert [(r["method"], r["plan"]) for r in rows] == [
            ("cache_repeat", "graph"), ("cache_repeat", "auto"),
            ("async_local_8shard", "graph"), ("async_local_8shard", "auto")]
        assert all(r["identical"] and r["detail"] == f"hits={NQ}"
                   for r in rows[:2])
        assert all(r["identical"] and r["detail"] == "seq->async"
                   for r in rows[2:])
    if name == "mesh_auto":
        assert {(r["method"], r["workload"]) for r in rows} == {
            (f"mesh_{p}", w) for p in ("graph", "auto")
            for w in ("narrow_1pct", "medium_10pct", "wide_50pct")}
        assert all(r["shards"] == 8 and r["devices"] == 1 for r in rows)
    if name == "build":
        assert [(r["method"], r["shards"]) for r in rows] == [
            ("build_single", 1), ("build_sharded", 1), ("build_sharded", 2),
            ("build_sharded", 4), ("build_sharded", 8), ("persist", 1),
            ("persist", 8)]
        assert all(r["identical"] == 1 for r in rows)
    if name == "streaming":
        assert [r["delta_frac_target"] for r in rows] == [0.0, 0.01, 0.05,
                                                          0.2]
        assert all(r["recall"] == 1.0 for r in rows)   # ef=64 >= every range
    if name == "wal":
        assert [r["sync"] for r in rows] == ["nowal", "none", "batch",
                                             "always"]
        always = rows[-1]
        assert always["fsyncs"] >= always["ops"] and rows[0]["fsyncs"] == 0


def test_recall_at_k_equals_the_reference_on_its_edge_cases():
    gt = np.asarray([[1, 2, 3], [4, -1, -1], [-1, -1, -1], [7, 8, 9]])
    gd = np.asarray([[0.1, 0.2, 0.3], [0.5, np.inf, np.inf],
                     [np.inf] * 3, [1.0, 2.0, 3.0]], np.float32)
    found = np.asarray([[3, 2, 11], [4, 5, 6], [1, 2, 3], [7, 8, 10]])
    fd = np.asarray([[0.3, 0.2, 0.3], [0.5, 0.6, 0.7], [0.1] * 3,
                     [1.0, 2.0, 3.000001]], np.float32)
    for kw in ({}, dict(gt_dists=gd, found_dists=fd),
               dict(gt_dists=gd, found_dists=fd, eps=1e-9)):
        assert ct.recall_at_k(found, gt, **kw) == ref_recall_at_k(found, gt,
                                                                  **kw)
    assert ct.recall_at_k(found, gt) == pytest.approx(5 / 7)
    assert ct.recall_at_k(found, gt, gt_dists=gd,
                          found_dists=fd) == pytest.approx(1.0)


@pytest.mark.parametrize("only", ["wal,bogus", "bogus"])
def test_unknown_bench_exits_non_zero(only, results, capsys):
    """A run that asks for an unknown bench refuses the whole run, a
    ported bench beside it included."""
    assert rt.main(["--only", only, "--device", "cpu"]) != 0
    out = capsys.readouterr()
    assert "name,us_per_call" not in out.out          # no empty table
    assert "unknown bench" in out.err
    assert not results.exists()


def test_multi_device_benches_through_main(results, capsys):
    """``--only mesh_auto,build,async_cache`` on the CPU writes the three
    tables: every sharded build identical to the single-device one, the
    async rows identical to the sequential ones."""
    assert rt.main(["--only", "mesh_auto,build,async_cache", "--device",
                    "cpu", "--n", str(N)]) == 0
    assert {p.name for p in results.iterdir()} == {
        "mesh_auto.csv", "build.csv", "async_cache.csv", "BENCH_pt_build.json"}
    tables = {}
    for name in ("mesh_auto", "build", "async_cache"):
        with open(results / f"{name}.csv") as f:
            tables[name] = list(csv.DictReader(f))
    assert [r["shards"] for r in tables["build"]
            if r["method"] == "build_sharded"] == ["1", "2", "4", "8"]
    assert all(r["identical"] == "1" for r in tables["build"])
    rows = [r for r in tables["async_cache"]
            if r["method"] == "async_local_8shard"]
    assert [r["plan"] for r in rows] == ["graph", "auto"]
    assert all(r["identical"] == "True" for r in rows)
    assert len(tables["mesh_auto"]) == 6
    out = capsys.readouterr().out
    assert "_bit_identical=True" in out and "_async_vs_seq=" in out


def test_main_writes_only_under_results(results, capsys):
    assert rt.main(["--only", "kernels", "--device", "cpu"]) == 0
    assert sorted(p.name for p in results.iterdir()) == ["kernels.csv"]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert any(line.startswith("kernel_l2dist,") for line in out)
    assert ct.RESULTS == results and results.parent.name != "bench"

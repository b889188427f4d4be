"""The harness on the CPU at a tiny size: cells found by name, a throwaway
configuration, mix and metric added as files alone, the result line's keys,
the import check, and ``correct`` coming out false under each fault the
cells can have (the program's plain paths, broken underneath) and under the
int8 configuration's control put in the program's place."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rfann_bench import run
from rfann_bench.spec import Spec

ROOT = Path(__file__).resolve().parents[1]
CELLS = ["sift1m-syn.batch-wide", "sift1m-syn-int8.batch-narrow"]
SEED = 2**31 + 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Tiny(Spec):
    """The committed cells at n = 1,024, d = 16 and short loops; with
    ``wide_scan``, n = 2,048 in two clusters and the narrow cell forced to
    the scan over windows of 2,048 and 1,024 rows, so that a window holds
    more rows of the query's cluster than the int8 pass keeps."""

    def __init__(self, root, wide_scan=False):
        super().__init__(root)
        self.wide_scan = wide_scan

    def config(self, name):
        c = super().config(name)
        c.update(n=1024, d=16, queries=160, m=16, ef_spatial=16,
                 ef_attribute=24)
        if self.wide_scan:
            c.update(n=2048, n_clusters=2)
        return c

    def traffic(self, name):
        t = super().traffic(name)
        t.update(ef=16, block=32, batch=32)
        if self.wide_scan:
            t.update(plan="scan", levels=[0, 1])
        return t


def _run(spec, cell, trace=False, seconds=0.2):
    ctx, corpus, peak = run.measure(spec, cell, SEED, seconds, trace, "cpu",
                                    0.0)
    checks = run.check(ctx, corpus, "cpu")
    return run.result_line(spec, ctx, checks, trace, peak, "cpu")


def test_every_cell_names_files_that_exist():
    spec = Spec(ROOT)
    for w in spec.doc["workloads"]:
        cfg = spec.config(w["config"])
        tr = spec.traffic(w["traffic"])
        assert cfg["precision"] in ("f32", "int8") and tr["loop"] == "batch"
        for control in cfg["controls"]:
            assert set(control) <= {"precision", "rerank"}
        for traced in (False, True):
            for m in spec.metrics(w["name"], traced):
                assert callable(spec.reader(m["name"]))
    assert {m["name"] for m in spec.metrics(CELLS[0], False)} == {
        "qps", "recall_at10", "p95_ms", "build_s", "setup_s"}
    assert {m["name"] for m in spec.metrics(CELLS[1], False)} == {
        "recall_at10", "device_qps", "build_s", "setup_s"}
    assert {m["name"] for m in spec.metrics(CELLS[1], True)} == {
        "scan_share", "scan_device_ms", "scan_roofline", "index_mb"}
    assert spec.reads_device(CELLS[1]) and not spec.reads_device(CELLS[0])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct_and_line_has_the_contract_keys(cell):
    spec = Tiny(ROOT)
    line = _run(spec, cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] and line["failed"] == 0, line
    # the CPU has no device records, so a device-trace metric reads nothing
    names = {m["name"] for m in spec.metrics(cell, False)
             if m["source"] != "device_trace"}
    assert set(line["metrics"]) == names
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    cfg = spec.config(spec.workload(cell)["config"])
    assert ("topk_gap" in line["checks"]) == ("topk_gap" in cfg["limits"])


def _fault(kind):
    """RNSGIndex.search_ranks broken underneath: every answer's first id
    altered where it is produced; half of each batch left out; the
    previous call's answers returned unchanged; or each window read only
    in its first half."""
    from repro_torch.core.rfann import RNSGIndex
    inner = RNSGIndex.search_ranks
    last = []

    def broken(self, queries, lo, hi, *a, **kw):
        if kind == "partial":
            lo, hi = np.asarray(lo), np.asarray(hi)
            hi = lo + (hi - lo) // 2
        res = inner(self, queries, lo, hi, *a, **kw)
        if kind == "altered":
            res.ids[:, 0] = (res.ids[:, 0] + 1) % self.g.n
        elif kind == "half":
            h = (len(res.ids) + 1) // 2
            res.ids[h:] = -1
            res.dists[h:] = np.inf
        elif kind == "stale":
            if last and last[0].ids.shape == res.ids.shape:
                res.ids, res.dists = last[0].ids, last[0].dists
            last[:] = [res]
        return res
    return broken


@pytest.mark.parametrize("kind", ["altered", "half", "stale"])
@pytest.mark.parametrize("cell", CELLS)
def test_correct_is_false_under_each_fault(monkeypatch, cell, kind):
    from repro_torch.core.rfann import RNSGIndex
    monkeypatch.setattr(RNSGIndex, "search_ranks", _fault(kind))
    line = _run(Tiny(ROOT), cell)
    assert not line["correct"], line["checks"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_a_scan_that_reads_part_of_each_window_fails_topk_gap(monkeypatch):
    """Windows wide enough that the half read still holds k rows: every
    id is in range with its exact distance, and only the top-k is wrong."""
    from repro_torch.core.rfann import RNSGIndex
    spec = Tiny(ROOT, wide_scan=True)
    assert _run(spec, CELLS[1])["correct"]
    monkeypatch.setattr(RNSGIndex, "search_ranks", _fault("partial"))
    line = _run(spec, CELLS[1])
    assert not line["correct"]
    c = line["checks"]
    assert c["dist_gap"]["value"] <= c["dist_gap"]["limit"]
    assert c["topk_gap"]["value"] > c["topk_gap"]["limit"]


def test_a_beam_over_part_of_each_window_shows_in_recall(monkeypatch):
    """The beam is approximate, so ``correct`` holds its answers to the
    guarantees alone; its quality is ``recall_at10``, under its bound."""
    from repro_torch.core.rfann import RNSGIndex
    sound = _run(Tiny(ROOT), CELLS[0])["metrics"]["recall_at10"]["value"]
    monkeypatch.setattr(RNSGIndex, "search_ranks", _fault("partial"))
    line = _run(Tiny(ROOT), CELLS[0])
    assert line["metrics"]["recall_at10"]["value"] < sound - 0.2


@pytest.mark.parametrize("which", [0, 1])
def test_the_int8_controls_in_the_programs_place_are_not_correct(which):
    """Step 2 through the harness: int4 survivors reranked exactly (the
    int8 path with one precision less), or int4 throughout, put in place of
    the program's answers; the sound program's line is correct, the
    control's is not."""
    spec = Tiny(ROOT, wide_scan=True)
    ctx, corpus, peak = run.measure(spec, CELLS[1], SEED, 0.2, False, "cpu",
                                    0.0)
    sound = run.check(ctx, corpus, "cpu")
    assert run.result_line(spec, ctx, sound, False, peak, "cpu")["correct"]
    control = ctx.config["controls"][which]
    ctl = run.check(ctx, corpus, "cpu", control=control)
    line = run.result_line(spec, ctx, ctl, False, peak, "cpu")
    assert not line["correct"]
    c = line["checks"]
    failed = {n for n, v in c.items() if v["value"] > v["limit"]}
    assert failed == ({"topk_gap"} if control.get("rerank") else
                      {"dist_gap", "topk_gap"})


def _copy(tmp_path):
    """The benchmark's files in ``tmp_path``: (BENCHMARK.json's document,
    the copy of the folder)."""
    shutil.copytree(ROOT / "rfann_bench", tmp_path / "rfann_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    return (json.loads((ROOT / "BENCHMARK.json").read_text()),
            tmp_path / "rfann_bench")


def test_a_new_config_mix_and_metric_are_files_alone(tmp_path):
    doc, b = _copy(tmp_path)
    cfg = json.loads((b / "configs" / "sift1m-syn.json").read_text())
    cfg.update(name="tiny-throwaway", n=1024, d=16, queries=64, m=16,
               ef_spatial=16, ef_attribute=24)
    (b / "configs" / "tiny-throwaway.json").write_text(json.dumps(cfg))
    (b / "traffic" / "mix-throwaway.json").write_text(json.dumps(dict(
        loop="batch", batch=32, block=32, levels=[0, 3], plan="auto", ef=16,
        k=10)))
    (b / "metrics" / "throwaway_metric.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.q_idx))\n")
    cell = "tiny-throwaway.mix-throwaway"
    doc["configs"].append(dict(name="tiny-throwaway", source="test",
                               file="rfann_bench/configs/tiny-throwaway.json",
                               reduced=[], why="test"))
    doc["workloads"].append(dict(name=cell, config="tiny-throwaway",
                                 traffic="mix-throwaway", chips=1, why="t"))
    doc["per_layer"].append(dict(name="throwaway_metric", unit="rows",
                                 better="higher", source="program_counter",
                                 layer="engine", moves="qps",
                                 workloads=[cell]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    line = _run(Spec(tmp_path), cell, trace=True)
    assert line["correct"]
    assert line["metrics"]["throwaway_metric"]["value"] > 0
    assert "breakdown" in line


def test_a_reader_that_loads_a_forbidden_module_leaves_no_result(
        tmp_path, monkeypatch, capsys):
    """The import check runs once every reader has loaded."""
    mod = "rfann_bench_throwaway_forbidden"
    monkeypatch.setattr(run, "FORBIDDEN", (mod,))
    monkeypatch.delitem(sys.modules, mod, raising=False)
    doc, b = _copy(tmp_path)
    (b / "metrics" / "throwaway_import.py").write_text(
        f"import sys, types\nsys.modules['{mod}'] = types.ModuleType('m')"
        "\n\n\ndef read(ctx):\n    return 1.0\n")
    doc["per_layer"].append(dict(name="throwaway_import", unit="u",
                                 better="higher", source="program_counter",
                                 layer="API", moves="qps",
                                 workloads=[CELLS[0]]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    spec = Tiny(tmp_path)
    ctx, corpus, peak = run.measure(spec, CELLS[0], SEED, 0.2, False, "cpu",
                                    0.0)
    assert run.report(spec, ctx, corpus, False, peak, "cpu") is not None
    assert run.report(spec, ctx, corpus, True, peak, "cpu") is None
    assert mod in capsys.readouterr().err
    monkeypatch.delitem(sys.modules, mod)


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    assert run.forbidden_modules(["repro_torch.core.rfann", "reprox",
                                  "jaxtyping", "rfann_bench.run"]) == []
    assert run.forbidden_modules(["repro.core.rfann", "jax.numpy", "flax",
                                  "jaxlib", "numpy"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_imports_neither_jax_nor_repro():
    code = ("import sys; from rfann_bench import run, limits; "
            "from rfann_bench.spec import Spec; s = Spec(run.ROOT); "
            "[s.reader(m['name']) for g in ('end_to_end', 'per_layer') "
            "for m in s.doc[g]]; "
            "import repro_torch.core.rfann; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_means_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""

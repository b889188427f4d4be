"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs[].file``), a traffic mix
(``rfann_bench/traffic/<traffic>.json``) and, through the metrics that list
it or list no cells, the readers it reports
(``rfann_bench/metrics/<metric>.py``, each a ``read(ctx)`` that returns a
number, or None where it finds nothing to read).  Adding a cell, a mix, a
configuration or a metric is adding files and entries: nothing here or in
the harness changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = "rfann_bench"


class Spec:
    def __init__(self, root):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers = {}

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / BENCH_DIR / "traffic" /
                           f"{name}.json").read_text())

    def metrics(self, cell: str, traced: bool) -> list:
        """The metric entries a cell reports: per-layer ones in a traced
        run, end-to-end ones otherwise."""
        group = self.doc["per_layer" if traced else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reads_device(self, cell: str) -> bool:
        """Whether an end-to-end metric of the cell is read from the device
        trace, so that its untraced runs are profiled too."""
        return any(m["source"] == "device_trace"
                   for m in self.metrics(cell, False))

    def reader(self, metric: str):
        path = self.root / BENCH_DIR / "metrics" / f"{metric}.py"
        fn = self._readers.get(path)
        if fn is None:
            spec = importlib.util.spec_from_file_location(
                f"{BENCH_DIR}_metric_{len(self._readers)}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            fn = self._readers[path] = mod.read
        return fn

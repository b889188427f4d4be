"""Readings that the limits of ``correct`` are set from.

    python3 -m rfann_bench.limits --seeds 11,12,13 --seconds 20 [--workloads a,b]
        [--also <cell>:bf16,...] [--trace 1]

For each seed: the corpus is made and the index built once (every cell of a
seed shares them: the configurations differ only in the precision that
``serve`` installs), then each cell runs its warm-up and window as a run
does, and its answers are judged; then each of the configuration's controls
(its ``"controls"``: the reference in the next precision down, with or
without an exact rerank of its survivors) is put in the program's place over
the same answered queries and judged alike.  With
``--also <cell>:<precision>``, that cell runs again with the program's own
path in that precision and is judged against its configuration's limits.  One JSON line
per (seed, cell): the program's numbers (lower readings), the control's
(upper ones), and the run's recall and rate.  Runs on the card; ``PERF.md``
gives the readings and the limits set from them.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from rfann_bench import run
from rfann_bench.spec import Spec


def _numbers(checks: dict) -> dict:
    return {name: v for name, (v, _) in checks.items()}


def readings(spec: Spec, cells, seed: int, seconds: float, device,
             trace: bool = False, also=()):
    """Yield one dict of readings per cell, on one build; ``also`` holds
    (cell, precision) pairs of further program runs."""
    from repro_torch.core.rfann import RNSGIndex
    dev = torch.device(device)
    graph = build_s = None
    for cell in cells:
        w = spec.workload(cell)
        cfg, tr = spec.config(w["config"]), spec.traffic(w["traffic"])
        corpus = run.make_corpus(cfg, tr, seed, dev)
        if graph is None:
            t = time.perf_counter()
            graph = RNSGIndex.build(corpus.vectors, corpus.attrs, device=dev,
                                    m=int(cfg["m"]),
                                    ef_spatial=int(cfg["ef_spatial"]),
                                    ef_attribute=int(cfg["ef_attribute"])).g
            run._sync(dev)
            build_s = time.perf_counter() - t
        out = dict(seed=seed, cell=cell, build_s=build_s)
        for precision in (cfg["precision"],) + tuple(
                p for c, p in also if c == cell):
            c = dict(cfg, precision=precision)
            t0 = time.perf_counter()
            ctx, peak = run.serve(RNSGIndex(graph), corpus, cell, c, tr,
                                  seconds, trace, dev, t0, build_s,
                                  profile=trace or spec.reads_device(cell))
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            checks = _numbers(run.check(ctx, corpus, dev))
            got = dict(answered=ctx.window.answered, failed=ctx.window.failed,
                       qps=ctx.window.answered / ctx.window.seconds,
                       recall=ctx.recall, peak=peak, **checks)
            if precision != cfg["precision"]:
                out[precision] = got
                continue
            out.update(got, limits=cfg["limits"])
            if ctx.device is not None:
                out.update(device_qps=ctx.window.answered / ctx.device.busy_s
                           if ctx.device.busy_s > 0 else None,
                           range_scan_s=ctx.device.seconds_of("range_scan"),
                           busy_s=ctx.device.busy_s,
                           window_s=ctx.device.window_s,
                           top_ops=ctx.device.top_ops(5),
                           idle_gaps=ctx.device.idle_gaps[:5])
            out["controls"] = []
            for control in cfg["controls"]:
                ctl = _numbers(run.check(ctx, corpus, dev, control=control))
                out["controls"].append(dict(control, recall=ctx.recall,
                                            **ctl))
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--workloads", default="")
    ap.add_argument("--also", default="")
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rfann_bench.limits: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec(run.ROOT)
    cells = ([c for c in args.workloads.split(",") if c] or
             [w["name"] for w in spec.doc["workloads"]])
    also = tuple(tuple(a.split(":")) for a in args.also.split(",") if a)
    for seed in (int(s) for s in args.seeds.split(",")):
        for out in readings(spec, cells, seed, args.seconds, "cuda",
                            bool(args.trace), also):
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

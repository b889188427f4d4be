"""Run one cell of the benchmark and print its result as the last line.

    python3 -m rfann_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the corpus and query pool from the seed, builds the index
(``build_s``), installs the quantized copy a configuration asks for, and
warms the cell's loop; ``setup_s`` runs from the process' start to the
window's first request.  The window runs the traffic for ``--seconds``
(under ``torch.profiler`` with ``--trace 1``, and in a cell that reports an
end-to-end metric read from the device trace).  Once it has closed and the
peak memory is read, the program is freed and the reference judges every
answer (``judge``).  With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones and a
``breakdown``; the numbers compared, beside their limits, come last in it
and on standard error.

The kernels build into ``build/`` in the checkout (the program's own
cache, at a fixed path); nothing is written elsewhere.  Exits non-zero with
no result where no card is present, where the cell asks for more cards than
there are, and where ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` was imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfann_bench import data, devtrace, judge, reference, traffic  # noqa: E402
from rfann_bench.spec import Spec  # noqa: E402

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Context:
    """What the metric readers read (``rfann_bench/metrics``)."""
    cell: str
    config: dict
    traffic: dict
    window: traffic.Window
    setup_s: float
    build_s: float
    index_stats: dict
    pool_lo: np.ndarray
    pool_hi: np.ndarray
    recall: Optional[float] = None
    device: Optional[devtrace.DeviceWindow] = None


def forbidden_modules(names=None) -> list:
    """Top-level names (before the first dot) of the loaded modules, or of
    ``names``, that are one of ``FORBIDDEN``, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def measure(spec: Spec, cell: str, seed: int, seconds: float, trace: bool,
            device, t_start: float):
    """Set-up and window of one cell: (Context, the corpus, peak memory
    bytes).  The index is freed before returning."""
    from repro_torch.core.rfann import RNSGIndex
    w = spec.workload(cell)
    cfg, tr = spec.config(w["config"]), spec.traffic(w["traffic"])
    dev = torch.device(device)
    corpus = make_corpus(cfg, tr, seed, dev)
    _sync(dev)
    t = time.perf_counter()
    index = RNSGIndex.build(corpus.vectors, corpus.attrs, device=dev,
                            m=int(cfg["m"]), ef_spatial=int(cfg["ef_spatial"]),
                            ef_attribute=int(cfg["ef_attribute"]))
    _sync(dev)
    build_s = time.perf_counter() - t
    ctx, peak = serve(index, corpus, cell, cfg, tr, seconds, trace, dev,
                      t_start, build_s,
                      profile=trace or spec.reads_device(cell))
    del index
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ctx, corpus, peak


def make_corpus(cfg: dict, tr: dict, seed: int, dev) -> data.Corpus:
    return data.make_corpus(cfg, int(cfg["queries"]), int(tr["block"]),
                            tr["levels"], seed, dev)


def serve(index, corpus, cell: str, cfg: dict, tr: dict, seconds: float,
          trace: bool, dev, t_start: float, build_s: float,
          profile: Optional[bool] = None):
    """The configuration's precision installed, the loop warmed, and the
    window (profiled where ``profile``, by default with ``trace``): (Context,
    peak memory bytes once the window has closed)."""
    precision = cfg["precision"]
    if precision != "f32":
        index.install_quantized(precision)
    prof = _profiler(dev) if (trace if profile is None else profile) \
        else None
    if prof is not None:
        prof.__enter__()
    try:
        win = traffic.run(tr["loop"], index, corpus, tr, precision, seconds,
                          prof=prof, traced=trace)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lo, hi = reference.rank_window(corpus.attrs, corpus.ranges)
    ctx = Context(cell, cfg, tr, win, setup_s=win.t0 - t_start,
                  build_s=build_s, index_stats=index.stats(),
                  pool_lo=lo, pool_hi=hi)
    if prof is not None:
        ctx.device = devtrace.read(prof, _trace_spans(win.traces))
    return ctx, peak


def check(ctx: Context, corpus, device, control: Optional[dict] = None):
    """Judge the window's answers against the reference (or, with a
    ``control``, one of the configuration's ``"controls"``, the reference's
    answers in that precision in their place, for the same queries and
    routes).  Sets ``ctx.recall``; returns {number: (value, limit)} for each
    number the configuration's ``limits`` name."""
    from repro_torch.planner import SCAN
    dev = torch.device(device)
    k = int(ctx.traffic["k"])
    v = torch.as_tensor(corpus.vectors, device=dev)
    a = torch.as_tensor(corpus.attrs, device=dev)
    gt_ids, gt_d = reference.topk_in_range(v, a, corpus.queries,
                                           corpus.ranges, k)
    w = ctx.window
    q_idx, ids, dists = w.q_idx, w.ids, w.dists
    if control is not None:
        c_ids, c_d = reference.topk_in_range(
            v, a, corpus.queries, corpus.ranges, k,
            precision=control["precision"], rerank=int(control.get(
                "rerank", 0)))
        ids, dists = c_ids[q_idx], c_d[q_idx]
    dist_gap, topk_gap = judge.gaps(v, corpus.attrs, corpus.queries,
                                    corpus.ranges, gt_d, q_idx, ids, dists)
    ctx.recall = judge.recall(gt_ids, q_idx, ids)
    del v, a
    limits = ctx.config["limits"]
    out = {"dist_gap": (float(dist_gap.max()) if len(dist_gap) else 1.0,
                        float(limits["dist_gap"]))}
    scan = w.strategy == SCAN
    if "topk_gap" in limits and scan.any():
        out["topk_gap"] = (float(topk_gap[scan].max()),
                           float(limits["topk_gap"]))
    return out


def result_line(spec: Spec, ctx: Context, checks: dict, trace: bool,
                peak: int, device) -> dict:
    w = ctx.window
    correct = (w.failed == 0 and len(w.q_idx) > 0 and
               all(v <= lim for v, lim in checks.values()))
    metrics = {}
    for m in spec.metrics(ctx.cell, trace):
        val = spec.reader(m["name"])(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    dev = torch.device(device)
    out = {"correct": bool(correct), "attempted": int(w.attempted),
           "failed": int(w.failed), "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and ctx.device is not None:
        dw = ctx.device
        out["device"].update(busy_s=dw.busy_s, window_s=dw.window_s)
        out["breakdown"] = {"device_ops": [[n, s] for n, s in dw.top_ops()],
                            "idle_gaps": [[n, s] for n, s
                                          in dw.idle_gaps[:10]]}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in checks.items()}
    return out


def _trace_spans(traces) -> list:
    """The program's trace spans as (start ns, end ns, "trace.<name>") in
    the profiler's clock (the wall clock's nanoseconds)."""
    off = time.time_ns() - time.perf_counter_ns()
    return [(int(sp.t0 * 1e9) + off, int(sp.t1 * 1e9) + off,
             f"trace.{sp.name}") for tr in traces for sp in tr.spans]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profiler(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def report(spec: Spec, ctx: Context, corpus, trace: bool, peak: int,
           device) -> Optional[dict]:
    """Judge the window, read the cell's metrics and write the numbers
    compared, beside their limits, as the last lines on standard error:
    the result line, or None (with the reason on standard error) where a
    forbidden module was loaded by then, the metric readers included."""
    checks = check(ctx, corpus, device)
    line = result_line(spec, ctx, checks, trace, peak, device)
    bad = forbidden_modules()
    if bad:
        print(f"rfann_bench: the run imported {', '.join(bad)}",
              file=sys.stderr)
        return None
    print(f"recall_at10 {ctx.recall!r} over {ctx.window.answered} answers "
          f"judged", file=sys.stderr)
    for name, (v, lim) in checks.items():
        print(f"{name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    return line

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec(ROOT)
    chips = int(spec.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rfann_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" present", file=sys.stderr)
        return 2
    trace = bool(args.trace)
    ctx, corpus, peak = measure(spec, args.workload, args.seed, args.seconds,
                                trace, "cuda", T_START)
    line = report(spec, ctx, corpus, trace, peak, "cuda")
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

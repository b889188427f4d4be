"""Benchmark driver of the PyTorch port — one function per paper
table/figure, the counterpart of ``benchmarks/run.py`` over ``repro_torch``.

  PYTHONPATH=src python -m benchmarks.run_torch [--full] [--only qps_recall,...]
                                                [--n N] [--device cuda|cpu]

Prints ``name,us_per_call,derived`` CSV summary lines (full per-point tables
land in results/bench_torch/*.csv).  Every index is built and searched on
``--device`` (default the card; ``cpu`` runs the kernels' plain PyTorch
versions, and its times are CPU times).  An unknown bench name exits
non-zero.

``mesh_auto``, ``build`` and ``async_cache``'s ``async_local_8shard`` rows
run the multi-device path: their shards are placed round-robin on
``--device``, so on one card all eight shards share it (the reference
re-execs itself with eight fake host devices instead).

The paper's tables (``qps_recall`` through ``quantized``) time RNSG's plain
beams (``use_kernel=False``), the path the baselines' searches share and
these tables have always measured; ``kernels`` times the kernels alone.
``async_cache`` and ``streaming`` search with the device default (the fused
kernels on the card), the path the serving engine runs.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmarks.common_torch import (build_methods, build_seconds, dataset,
                                     emit, emit_bench_json, gt_for,
                                     recall_at_k, timed_search, workloads)
from repro_torch.core.rfann import RNSGIndex
from repro_torch.data.ann import mixed_workload, selectivity_ranges
from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import make_mesh

#: H100 SXM peaks for the kernel bounds: HBM3 bytes/s, f32 FLOP/s outside
#: the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bench_qps_recall(n, d, nq, quick, device, methods=None):
    """Paper Fig. 6: QPS vs recall per method × workload (ef sweep)."""
    vecs, attrs = dataset(n, d)
    methods = methods or build_methods(vecs, attrs, quick, device)
    wls = workloads(attrs, nq)
    k = 10
    rows = []
    for wname, ranges in wls.items():
        qv = dataset(nq, d, seed=91)[0]
        gt = gt_for(vecs, attrs, qv, ranges, k, device)
        for mname, ix in methods.items():
            for ef in ((16, 32, 64, 128) if mname != "brute" else (0,)):
                (ids, _, *_), qps = timed_search(ix, qv, ranges, k,
                                                 max(ef, k), use_kernel=False)
                rows.append(dict(method=mname, workload=wname, ef=ef,
                                 recall=round(recall_at_k(ids, gt), 4),
                                 qps=round(qps, 1)))
    emit("qps_recall", rows, quiet=True)
    return rows


def bench_construction_time(n, d, quick, device, methods=None):
    """Paper Fig. 7: index construction time."""
    vecs, attrs = dataset(n, d)
    methods = methods or build_methods(vecs, attrs, quick, device)
    rows = [dict(method=m, build_seconds=round(build_seconds(ix), 2))
            for m, ix in methods.items()]
    emit("construction_time", rows, quiet=True)
    return rows


def bench_index_size(n, d, quick, device, methods=None):
    """Paper Fig. 8: index memory (graph structure bytes; vectors excluded
    uniformly — every method stores the same payload)."""
    vecs, attrs = dataset(n, d)
    methods = methods or build_methods(vecs, attrs, quick, device)
    rows = [dict(method=m, index_mb=round(ix.index_bytes / 2**20, 3))
            for m, ix in methods.items()]
    emit("index_size", rows, quiet=True)
    return rows


def bench_param_sensitivity(n, d, nq, quick, device):
    """Paper Fig. 9/10: RNSG sensitivity to ef_attribute / ef_spatial / m."""
    vecs, attrs = dataset(n, d)
    qv = dataset(nq, d, seed=91)[0]
    ranges, _ = mixed_workload(attrs, nq, seed=1)
    k = 10
    gt = gt_for(vecs, attrs, qv, ranges, k, device)
    base = dict(m=16, ef_spatial=16, ef_attribute=24)
    sweeps = {"ef_attribute": (8, 24, 48), "ef_spatial": (8, 16, 32),
              "m": (8, 16, 32)}
    rows = []
    for pname, vals in sweeps.items():
        for v in vals:
            kw = dict(base, **{pname: v})
            ix = RNSGIndex.build(vecs, attrs, device=device, **kw)
            (ids, _, st), qps = timed_search(ix, qv, ranges, k, 64,
                                             use_kernel=False)
            rows.append(dict(param=pname, value=v,
                             build_seconds=round(ix.g.build_seconds, 2),
                             recall=round(recall_at_k(ids, gt), 4),
                             qps=round(qps, 1),
                             edges=ix.n_edges))
    emit("param_sensitivity", rows, quiet=True)
    return rows


def bench_vary_k(n, d, nq, quick, device):
    """Paper Fig. 11: recall/QPS across k."""
    vecs, attrs = dataset(n, d)
    ix = RNSGIndex.build(vecs, attrs, m=16, ef_spatial=16, ef_attribute=24,
                         device=device)
    qv = dataset(nq, d, seed=91)[0]
    ranges, _ = mixed_workload(attrs, nq, seed=1)
    rows = []
    for k in (1, 10, 20, 50):
        gt = gt_for(vecs, attrs, qv, ranges, k, device)
        (ids, _, _), qps = timed_search(ix, qv, ranges, k, max(64, 2 * k),
                                        use_kernel=False)
        rows.append(dict(k=k, recall=round(recall_at_k(ids, gt), 4),
                         qps=round(qps, 1)))
    emit("vary_k", rows, quiet=True)
    return rows


def bench_scalability(d, nq, quick, device):
    """Paper Fig. 12: build time / size / QPS-at-recall vs dataset size."""
    rows = []
    sizes = (2048, 4096, 8192) if quick else (4096, 8192, 16384, 32768)
    for n in sizes:
        vecs, attrs = dataset(n, d)
        ix = RNSGIndex.build(vecs, attrs, m=16, ef_spatial=16,
                             ef_attribute=24, device=device)
        qv = dataset(nq, d, seed=91)[0]
        ranges, _ = mixed_workload(attrs, nq, seed=1)
        gt = gt_for(vecs, attrs, qv, ranges, 10, device)
        (ids, _, st), qps = timed_search(ix, qv, ranges, 10, 64,
                                         use_kernel=False)
        rows.append(dict(n=n, build_seconds=round(ix.g.build_seconds, 2),
                         index_mb=round(ix.index_bytes / 2**20, 3),
                         recall=round(recall_at_k(ids, gt), 4),
                         qps=round(qps, 1),
                         mean_hops=round(float(st["hops"].mean()), 1)))
    emit("scalability", rows, quiet=True)
    return rows


def bench_planner(n, d, nq, quick, device):
    """Adaptive planner vs pure-graph vs brute across selectivity regimes.
    Narrow workloads must route to the fused range_scan (exact, faster);
    wide workloads must stay on beam search."""
    from repro_torch.index.baselines import BruteForceIndex
    vecs, attrs = dataset(n, d)
    m = 24 if quick else 48
    ix = RNSGIndex.build(vecs, attrs, m=m, ef_spatial=m, ef_attribute=2 * m,
                         device=device)
    brute = BruteForceIndex(vecs, attrs, device=device)
    wls = {
        "narrow_0.4pct": 0.004,
        "narrow_1pct": 0.01,
        "medium_10pct": 0.10,
        "wide_50pct": 0.50,
    }
    k, ef = 10, 64
    rows = []
    for wname, frac in wls.items():
        ranges = selectivity_ranges(attrs, nq, frac, seed=17)
        qv = dataset(nq, d, seed=91)[0]
        gt = gt_for(vecs, attrs, qv, ranges, k, device)
        # planner warms twice: the second warm runs with a calibrated cost
        # model, so the timed repeats see the steady-state routing
        (pids, _, pst), pqps = timed_search(ix, qv, ranges, k, ef,
                                            warmups=2, plan="auto",
                                            use_kernel=False)
        (gids, _, _), gqps = timed_search(ix, qv, ranges, k, ef, plan="graph",
                                          use_kernel=False)
        (bids, _, _), bqps = timed_search(brute, qv, ranges, k, ef)
        for mname, ids, qps, sf in (
                ("planner", pids, pqps, round(float(pst["scan_frac"]), 3)),
                ("graph", gids, gqps, ""),
                ("brute", bids, bqps, "")):
            rows.append(dict(method=mname, workload=wname, ef=ef,
                             recall=round(recall_at_k(ids, gt), 4),
                             qps=round(qps, 1), scan_frac=sf))
    emit("planner", rows, quiet=True)
    return rows


def _beam_args(ix, ranges, qv):
    """(vecs, nbrs, queries, lo, hi, entry) of a direct beam dispatch on
    the index's substrate."""
    from repro_torch.search import select_entry
    sub = ix.substrate
    dev = sub._vecs.device
    lo, hi = ix.rank_range(ranges)
    lo_t = torch.as_tensor(lo, device=dev).long()
    hi_t = torch.as_tensor(hi, device=dev).long()
    entry = select_entry(sub._rmq, sub._dist_c, lo_t, hi_t, ix.g.n)
    return (sub._vecs, sub._nbrs, torch.as_tensor(qv, device=dev), lo_t,
            hi_t, entry)


def bench_search_substrate(n, d, nq, quick, device):
    """Pre/post early-out comparison on the search substrate at
    narrow/medium/wide selectivities: the beam early-out (pre = legacy
    condition that burns steps_cap on under-filled pools) must cut
    narrow-range beam latency with identical results, and the routed
    substrate paths ride on top."""
    from repro_torch.core.beam import beam_search_batch
    from repro_torch.search import remap_ids

    vecs, attrs = dataset(n, d)
    m = 24 if quick else 48
    ix = RNSGIndex.build(vecs, attrs, m=m, ef_spatial=m, ef_attribute=2 * m,
                         device=device)
    k, ef = 10, 64
    wls = {"narrow_1pct": 0.01, "medium_10pct": 0.10, "wide_50pct": 0.50}
    rows = []
    for wname, frac in wls.items():
        ranges = selectivity_ranges(attrs, nq, frac, seed=23)
        qv = dataset(nq, d, seed=91)[0]
        gt = gt_for(vecs, attrs, qv, ranges, k, device)
        args = _beam_args(ix, ranges, qv)
        for tag, es in (("beam_pre_early_out", False),
                        ("beam_post_early_out", True)):
            beam_search_batch(*args, k=k, ef=ef, early_stop=es)[0].cpu()
            t0 = time.perf_counter()
            ids, _, _ = beam_search_batch(*args, k=k, ef=ef, early_stop=es)
            ids = ids.cpu().numpy()
            dt = time.perf_counter() - t0
            rec = recall_at_k(remap_ids(ix.g.order.cpu().numpy(), ids), gt)
            rows.append(dict(method=tag, workload=wname, ef=ef,
                             recall=round(rec, 4), qps=round(nq / dt, 1)))
        for plan in ("graph", "auto"):
            (ids, _, st), qps = timed_search(ix, qv, ranges, k, ef,
                                             warmups=2, plan=plan,
                                             use_kernel=False)
            rows.append(dict(method=f"substrate_{plan}", workload=wname,
                             ef=ef, recall=round(recall_at_k(ids, gt), 4),
                             qps=round(qps, 1)))
    emit("search_substrate", rows, quiet=True)
    pre = next(r for r in rows if r["method"] == "beam_pre_early_out"
               and r["workload"] == "narrow_1pct")
    post = next(r for r in rows if r["method"] == "beam_post_early_out"
                and r["workload"] == "narrow_1pct")
    emit_bench_json("substrate", {
        "n": n, "d": d, "nq": nq, "k": k, "ef": ef,
        "device": _device_name(device),
        "rows": rows,
        "narrow_early_out_speedup": round(
            post["qps"] / max(pre["qps"], 1e-9), 3),
    })
    return rows


def bench_beam_width(n, d, nq, quick, device):
    """Batched beam expansion: ``beam_width ∈ {1, 2, 4, 8}`` × narrow (1%) /
    wide (50%) selectivities, direct ``beam_search_batch`` dispatches (no
    planner).  ``beam_width=1`` is the single-expansion path every other
    row is compared against.  The kernel path (``use_kernel``, bw 4) must
    return the plain path's ids.

    Emits results/bench_torch/beam_width.csv and BENCH_pt_beam.json (QPS /
    recall / ndist / hops per point, baseline QPS, and the best
    narrow-range speedup at equal recall)."""
    from repro_torch.core.beam import beam_search_batch
    from repro_torch.search import remap_ids

    vecs, attrs = dataset(n, d)
    m = 24 if quick else 48
    ix = RNSGIndex.build(vecs, attrs, m=m, ef_spatial=m, ef_attribute=2 * m,
                         device=device)
    order = ix.g.order.cpu().numpy()
    k, ef = 10, 64
    wls = {"narrow_1pct": 0.01, "wide_50pct": 0.50}
    widths = (1, 2, 4, 8)
    rows = []
    for wname, frac in wls.items():
        ranges = selectivity_ranges(attrs, nq, frac, seed=17)
        qv = dataset(nq, d, seed=91)[0]
        gt = gt_for(vecs, attrs, qv, ranges, k, device)
        args = _beam_args(ix, ranges, qv)
        ids_bw4 = None
        for bw in widths:
            beam_search_batch(*args, k=k, ef=ef, beam_width=bw)[0].cpu()
            best = np.inf
            for _ in range(3 if quick else 5):
                t0 = time.perf_counter()
                ids, _, st = beam_search_batch(*args, k=k, ef=ef,
                                               beam_width=bw)
                ids = ids.cpu().numpy()
                best = min(best, time.perf_counter() - t0)
            if bw == 4:
                ids_bw4 = ids
            rec = recall_at_k(remap_ids(order, ids), gt)
            rows.append(dict(workload=wname, beam_width=bw, ef=ef,
                             qps=round(nq / best, 1),
                             recall=round(rec, 4),
                             ndist=round(float(st["ndist"].float().mean()), 1),
                             hops=round(float(st["hops"].float().mean()), 1)))
        # kernel smoke: the gather/top-k kernel path (the plain versions on
        # the CPU) must reproduce the plain path exactly
        nk = min(nq, 50)
        ids_k = beam_search_batch(
            *args[:2], *(a[:nk] for a in args[2:]), k=k, ef=ef,
            beam_width=4, use_kernel=True)[0].cpu().numpy()
        if not np.array_equal(ids_k, ids_bw4[:nk]):
            raise AssertionError(
                f"{wname}: kernel-path beam (beam_width=4) diverged from "
                f"the plain path")
    emit("beam_width", rows, quiet=True)
    nb, best_narrow = _beam_width_best(rows)
    summary = {
        "n": n, "d": d, "nq": nq, "k": k, "ef": ef,
        "device": _device_name(device),
        "widths": list(widths),
        "baseline": {w: next(r for r in rows if r["workload"] == w
                             and r["beam_width"] == 1) for w in wls},
        "rows": rows,
        "narrow_speedup_at_equal_recall": round(
            best_narrow["qps"] / max(nb["qps"], 1e-9), 3) if best_narrow
        else None,
        "narrow_best_beam_width": best_narrow["beam_width"] if best_narrow
        else None,
    }
    emit_bench_json("beam", summary)
    return rows


def _beam_width_best(rows, tol: float = 0.001):
    """(baseline bw=1 narrow row, best narrow row at >=baseline-tol recall
    or None) — the single eligibility rule behind both BENCH_pt_beam.json
    and the console summary line."""
    nb = next(r for r in rows if r["workload"] == "narrow_1pct"
              and r["beam_width"] == 1)
    eligible = [r for r in rows if r["workload"] == "narrow_1pct"
                and r["beam_width"] > 1 and r["recall"] >= nb["recall"] - tol]
    return nb, max(eligible, key=lambda r: r["qps"], default=None)


def bench_quantized(n, d, nq, quick, device):
    """Quantized distance scoring (int8/bf16 corpus + exact f32 rerank) vs
    the f32 baseline: recall@k and QPS per precision × narrow (1%) / wide
    (50%) selectivity × forced scan / beam strategy, plus scored
    bytes-per-vector.  Every quantized scan row is asserted to return the
    exact f32 top-k id set (the rerank contract).

    Emits results/bench_torch/quantized.csv and BENCH_pt_quant.json."""
    from repro_torch.kernels.quantize import quantize_corpus

    vecs, attrs = dataset(n, d)
    m = 24 if quick else 48
    ix = RNSGIndex.build(vecs, attrs, m=m, ef_spatial=m, ef_attribute=2 * m,
                         device=device)
    precisions = ("f32", "bf16", "int8")
    for prec in precisions[1:]:
        ix.install_quantized(prec)
    bpv = {"f32": float(4 * d)}
    for prec in precisions[1:]:
        bpv[prec] = quantize_corpus(ix.substrate._vecs, prec).bytes_per_vector
    k, ef = 10, 64
    wls = {"narrow_1pct": 0.01, "wide_50pct": 0.50}
    rows = []
    for wname, frac in wls.items():
        ranges = selectivity_ranges(attrs, nq, frac, seed=17)
        qv = dataset(nq, d, seed=91)[0]
        gt = gt_for(vecs, attrs, qv, ranges, k, device)
        for strategy in ("scan", "beam"):
            base_ids, base_rec = None, None
            for prec in precisions:
                (ids, dd, _), qps = timed_search(
                    ix, qv, ranges, k, ef, plan=strategy, precision=prec,
                    use_kernel=False)
                ids = np.asarray(ids)
                rec = recall_at_k(ids, gt)
                if prec == "f32":
                    base_ids, base_rec = np.sort(ids, 1), rec
                elif strategy == "scan":
                    # scan is exact at any ef: the rerank contract makes the
                    # quantized id set equal to the f32 one
                    if not np.array_equal(np.sort(ids, 1), base_ids):
                        raise AssertionError(
                            f"{wname}/scan/{prec}: quantized ids diverged "
                            f"from the f32 oracle (rerank contract broken)")
                elif rec < base_rec - 0.05:
                    # a quantized beam may visit another frontier at
                    # sub-covering ef; the recall envelope must hold
                    raise AssertionError(
                        f"{wname}/beam/{prec}: recall {rec:.4f} fell below "
                        f"the f32 envelope {base_rec:.4f} - 0.05")
                rows.append(dict(
                    workload=wname, strategy=strategy, precision=prec,
                    ef=ef, recall=round(rec, 4),
                    qps=round(qps, 1), bytes_per_vector=round(bpv[prec], 2)))
    emit("quantized", rows, quiet=True)

    def row(w, s, p):
        return next(r for r in rows if r["workload"] == w
                    and r["strategy"] == s and r["precision"] == p)

    ns_f32 = row("narrow_1pct", "scan", "f32")
    ns_int8 = row("narrow_1pct", "scan", "int8")
    speedup = round(ns_int8["qps"] / max(ns_f32["qps"], 1e-9), 3)
    dev = resolve_device(device)
    summary = {
        "n": n, "d": d, "nq": nq, "k": k, "ef": ef,
        "device": _device_name(device),
        "precisions": list(precisions),
        "bytes_per_vector": {p: round(v, 2) for p, v in bpv.items()},
        "scored_bytes_ratio_f32_over_int8": round(
            bpv["f32"] / bpv["int8"], 2),
        "rows": rows,
        "exact_scan_id_parity_vs_f32": True,  # asserted per scan row above
        "narrow_scan_int8_speedup_vs_f32": speedup,
        "narrow_scan_int8_recall": ns_int8["recall"],
        "speedup_note": (
            "CPU host: the kernels' plain PyTorch versions ran; QPS ratios "
            "are CPU numbers, not device numbers" if dev.type == "cpu" else
            "measured on the card; the lockstep beam's host loop, not the "
            "scored bytes, sets most of the search time"),
    }
    emit_bench_json("quant", summary)
    return rows


def _device_name(device) -> str:
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _time_us(fn, dev, reps: int = 20) -> float:
    """Median microseconds per call after two warm-up calls: CUDA events
    on the card, the host clock on the CPU."""
    for _ in range(2):
        fn()
    if dev.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        return float(np.median(times))
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) * 1e3)
    return float(np.median(times))


def _bound_us(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e6


def bench_kernels(quick, device):
    """Kernel microbench: ``l2dist`` and ``gather_dist`` through their
    wrappers (the kernel on the card, the plain version on the CPU) beside
    their plain versions, with the card's bound (bytes over 3.35 TB/s or
    flops over 67 TFLOP/s f32, whichever is larger) and, for ``l2dist``,
    ``torch.cdist`` (its matmul path, TF32 off) as the library yardstick."""
    from repro_torch.kernels import ops, ref
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False     # IEEE f32 yardstick
    rng = np.random.default_rng(0)
    name = _device_name(device)
    rows = []
    for (q, nn, dd) in ((128, 1024, 128), (256, 4096, 128)):
        a = torch.as_tensor(rng.standard_normal((q, dd)), dtype=torch.float32,
                            device=dev)
        b = torch.as_tensor(rng.standard_normal((nn, dd)),
                            dtype=torch.float32, device=dev)
        flops = 2 * q * nn * dd
        bound = _bound_us((q * dd + nn * dd + q * nn) * 4, flops)
        lib = _time_us(lambda: torch.cdist(
            a, b, compute_mode="use_mm_for_euclid_dist"), dev)
        for kname, fn in (("l2dist", ops.l2dist), ("l2dist_ref",
                                                   ref.l2dist_ref)):
            us = _time_us(lambda: fn(a, b), dev)
            rows.append(dict(kernel=kname, shape=f"{q}x{nn}x{dd}",
                             us_per_call=round(us, 2),
                             gflops_at_wall=round(flops / us / 1e3, 2),
                             bound_us=round(bound, 3),
                             library_us=round(lib, 2), device=name))
    x = torch.as_tensor(rng.standard_normal((4096, 128)), dtype=torch.float32,
                        device=dev)
    ids = torch.as_tensor(rng.integers(0, 4096, (1, 64)), dtype=torch.int32,
                          device=dev)
    qv = torch.as_tensor(rng.standard_normal((1, 128)), dtype=torch.float32,
                         device=dev)
    bound = _bound_us(64 * 128 * 4 + 64 * 4 + 128 * 4 + 64 * 4,
                      64 * 3 * 128)
    for kname, fn in (("gather_dist", ops.gather_dist),
                      ("gather_dist_ref", ref.gather_dist_ref)):
        us = _time_us(lambda: fn(x, ids, qv), dev)
        rows.append(dict(kernel=kname, shape="64of4096x128",
                         us_per_call=round(us, 2),
                         gflops_at_wall=round(64 * 3 * 128 / us / 1e3, 3),
                         bound_us=round(bound, 4), library_us="",
                         device=name))
    emit("kernels", rows, quiet=True)
    return rows


def bench_async_cache(n, d, nq, quick, device):
    """Async + cached search substrate:

    * cache rows — repeat-query QPS with the ``SearchCache`` installed
      (second pass: every row a hit, zero device work) vs the uncached
      substrate, per plan, flagging whether the hits are bit-identical to
      the dispatch that populated them;
    * async rows — the 8-shard ``DistributedRFANN`` local path with async
      per-shard dispatch (enqueue every shard, copy back at the merge) vs
      the sequential dispatch+block loop, flagging identical merged top-k.
    """
    from repro_torch.search import SearchCache
    from repro_torch.serving.distributed import DistributedRFANN

    vecs, attrs = dataset(n, d)
    m = 24 if quick else 48
    ix = RNSGIndex.build(vecs, attrs, m=m, ef_spatial=m, ef_attribute=2 * m,
                         device=device)
    qv = dataset(nq, d, seed=91)[0]
    ranges, _ = mixed_workload(attrs, nq, seed=1)
    k, ef = 10, 64
    rows = []
    for plan in ("graph", "auto"):
        ix.install_cache(None)
        (u_ids, u_d, _), u_qps = timed_search(ix, qv, ranges, k, ef,
                                              warmups=2, plan=plan)
        cache = SearchCache(max_bytes=64 << 20)
        ix.install_cache(cache)
        fill = ix.search(qv, ranges, k=k, ef=ef, plan=plan)   # populate
        # timed repeats are all-hit passes (timed_search warms once first)
        (c_ids, c_d, c_st), c_qps = timed_search(ix, qv, ranges, k, ef,
                                                 plan=plan)
        ix.install_cache(None)
        # the cache contract: hits are bit-identical to the dispatch that
        # populated them (fill vs cached); under plan="auto" recalibration
        # between the uncached and fill passes may reroute a boundary query
        identical = bool(np.array_equal(fill.ids, c_ids)
                         and np.array_equal(fill.dists, c_d))
        rows.append(dict(method="cache_repeat", plan=plan,
                         qps_base=round(u_qps, 1), qps_new=round(c_qps, 1),
                         speedup=round(c_qps / max(u_qps, 1e-9), 2),
                         identical=identical,
                         detail=f"hits={c_st['cache_hits']}"))
    n8 = n - n % 8
    dist = DistributedRFANN(vecs[:n8], attrs[:n8], n_shards=8, m=m,
                            ef_spatial=m, ef_attribute=2 * m, device=device)
    # paired best-of-8: each repeat times both modes back to back, so the
    # bests come from the same windows of host load
    for plan in ("graph", "auto"):
        results, best = {}, {False: np.inf, True: np.inf}
        for mode in (False, True):              # build the kernels first
            dist.async_dispatch = mode
            dist.search(qv, ranges, k=k, ef=ef, plan=plan)
        for _ in range(8):
            for mode in (False, True):
                dist.async_dispatch = mode
                t0 = time.perf_counter()
                results[mode] = dist.search(qv, ranges, k=k, ef=ef, plan=plan)
                best[mode] = min(best[mode], time.perf_counter() - t0)
        (s_ids, s_d), (a_ids, a_d) = results[False], results[True]
        s_qps, a_qps = nq / best[False], nq / best[True]
        identical = bool(np.array_equal(s_ids, a_ids)
                         and np.array_equal(s_d, a_d))
        rows.append(dict(method="async_local_8shard", plan=plan,
                         qps_base=round(s_qps, 1), qps_new=round(a_qps, 1),
                         speedup=round(a_qps / max(s_qps, 1e-9), 2),
                         identical=identical, detail="seq->async"))
    emit("async_cache", rows, quiet=True)
    return rows


def bench_mesh_auto(n, d, nq, quick, device):
    """Mesh-path strategy routing: ``DistributedRFANN(plan="auto")`` vs the
    graph-only mesh path on an 8-shard mesh over ``device`` (one card holds
    every shard) across selectivity regimes."""
    from repro_torch.search import rank_interval
    from repro_torch.serving.distributed import DistributedRFANN
    shards = 8
    n -= n % shards                       # corpus must be a shard multiple
    vecs, attrs = dataset(n, d)
    m = 16 if quick else 32
    mesh = make_mesh(shards, [device])
    dist = DistributedRFANN(vecs, attrs, n_shards=shards, mesh=mesh,
                            m=m, ef_spatial=m, ef_attribute=2 * m)
    k, ef = 10, 64
    wls = {"narrow_1pct": 0.01, "medium_10pct": 0.10, "wide_50pct": 0.50}
    rows = []
    for wname, frac in wls.items():
        ranges = selectivity_ranges(attrs, nq, frac, seed=29)
        qv = dataset(nq, d, seed=91)[0]
        gt = gt_for(vecs, attrs, qv, ranges, k, device)
        lo, hi = rank_interval(dist.attrs_sorted, ranges)
        strat, _ = dist.mesh_substrate.plan_strategies(lo, hi, k=k, ef=ef,
                                                       mode="auto")
        scan_frac = round(float((strat == 0).mean()), 3)
        for plan in ("graph", "auto"):
            (ids, _), qps = timed_search(dist, qv, ranges, k, ef, plan=plan)
            rows.append(dict(method=f"mesh_{plan}", workload=wname, ef=ef,
                             recall=round(recall_at_k(np.asarray(ids), gt), 4),
                             qps=round(qps, 1),
                             scan_frac=scan_frac if plan == "auto" else "",
                             devices=len(mesh.distinct), shards=shards))
    emit("mesh_auto", rows, quiet=True)
    return rows


def bench_build(n, d, quick, device):
    """Sharded construction + persistence: build wall vs shard count (with
    bit-identity to the single-device build flagged per point), and the
    directory-format save/restore wall vs a rebuild.  Every slab runs on
    ``device``, so the walls do not drop with S here."""
    from repro_torch.core.build_sharded import build_rnsg_sharded
    from repro_torch.core.construction import build_rnsg
    from repro_torch.index import io as index_io

    vecs, attrs = dataset(n, d)
    m = 16 if quick else 32
    t0 = time.perf_counter()
    ref = build_rnsg(vecs, attrs, m=m, ef_spatial=m, ef_attribute=2 * m,
                     device=device)
    t_single = time.perf_counter() - t0
    want = ref.arrays()
    rows = [dict(method="build_single", shards=1,
                 seconds=round(t_single, 3), restore_seconds="",
                 identical=1)]
    build_curve = {}
    identical_all = True
    for shards in (1, 2, 4, 8):
        t0 = time.perf_counter()
        g = build_rnsg_sharded(vecs, attrs, mesh=make_mesh(shards, [device]),
                               m=m, ef_spatial=m, ef_attribute=2 * m)
        dt = time.perf_counter() - t0
        got = g.arrays()
        same = all(np.array_equal(got[f], want[f]) for f in want)
        identical_all &= same
        build_curve[str(shards)] = round(dt, 3)
        rows.append(dict(method="build_sharded", shards=shards,
                         seconds=round(dt, 3), restore_seconds="",
                         identical=int(same)))

    idx = RNSGIndex(ref)
    idx.install_quantized("int8")
    persist = {}
    with tempfile.TemporaryDirectory() as td:
        for shards in (1, 8):
            p = str(Path(td) / f"idx{shards}")
            t0 = time.perf_counter()
            index_io.save_index(idx, p, shards=shards)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = index_io.load_index(p, device=device)
            t_restore = time.perf_counter() - t0
            assert torch.equal(got.g.nbrs.cpu(), ref.nbrs.cpu())
            persist[str(shards)] = dict(save_seconds=round(t_save, 3),
                                        restore_seconds=round(t_restore, 3))
            rows.append(dict(method="persist", shards=shards,
                             seconds=round(t_save, 3),
                             restore_seconds=round(t_restore, 3),
                             identical=1))
    emit("build", rows, quiet=True)
    t_restore_best = min(p["restore_seconds"] for p in persist.values())
    emit_bench_json("build", dict(
        n=n, d=d, m=m, devices=1, device=str(device),
        single_host_build_seconds=round(t_single, 3),
        sharded_build_seconds=build_curve,
        bit_identical_all_shard_counts=bool(identical_all),
        persist=persist,
        restore_speedup_vs_rebuild=round(
            t_single / max(t_restore_best, 1e-9), 1),
        speedup_note="every slab runs on the one device, so the sharded "
                     "walls do not drop with S; across cards the KNN "
                     "products and the prune split by slab"))
    return rows


def bench_streaming(n, d, nq, quick, device):
    """Streaming ingest trajectory: QPS + recall as the mutable delta
    segment grows to {0, 1%, 5%, 20%} of the live corpus, with a
    compaction (and its pause-time histogram sample) folding the delta
    into the base between fraction points.  Writes streaming.csv and
    BENCH_pt_stream.json (per-fraction rows, compaction pause and build
    p50/p99 from the obs histograms)."""
    from repro_torch.obs import MetricsRegistry
    from repro_torch.streaming import StreamingRFANN

    vecs, attrs = dataset(n, d)
    m = 16 if quick else 32
    s = StreamingRFANN(vecs, attrs, m=m, ef_spatial=m, ef_attribute=2 * m,
                       max_delta=10**9, device=device)
    reg = MetricsRegistry()
    s.install_metrics(reg)
    rng = np.random.default_rng(41)
    k, ef = 10, 64
    fractions = (0.0, 0.01, 0.05, 0.20)
    rows = []
    for frac in fractions:
        live_now = s.stats()["n_live"]
        target = int(round(frac * live_now / max(1.0 - frac, 1e-9)))
        for _ in range(target - s.stats()["n_delta"]):
            s.insert(rng.standard_normal(d).astype(np.float32),
                     float(rng.random()))
        lv, la, li = s.live_items()
        ranges = selectivity_ranges(la, nq, 0.10, seed=23)
        qv = dataset(nq, d, seed=91)[0]
        gt_rows = gt_for(lv, la, qv, ranges, k, device)
        gt = np.where(gt_rows >= 0, li[np.maximum(gt_rows, 0)], -1)
        res, qps = timed_search(s, qv, ranges, k, ef, plan="auto")
        rec = recall_at_k(np.asarray(res.ids), gt)
        st = s.stats()
        rows.append(dict(delta_frac_target=frac,
                         delta_frac=round(st["delta_frac"], 4),
                         n_live=st["n_live"], n_delta=st["n_delta"],
                         recall=round(rec, 4), qps=round(qps, 1)))
        if st["n_delta"]:       # fold in before the next fraction point
            s.compact(wait=True)
    assert s.stats()["n_delta"] == 0 and s.stats()["tombstones"] == 0
    emit("streaming", rows, quiet=True)
    snap = reg.snapshot()
    pause = snap["histograms"].get("stream_compaction_pause_ms", {})
    build = snap["histograms"].get("stream_compaction_build_ms", {})
    emit_bench_json("stream", {
        "n": n, "d": d, "nq": nq, "k": k, "ef": ef,
        "fractions": list(fractions), "rows": rows,
        "compactions": s.compactions,
        "compaction_pause_ms": {"p50": round(pause.get("p50", 0.0), 3),
                                "p99": round(pause.get("p99", 0.0), 3)},
        "compaction_build_ms": {"p50": round(build.get("p50", 0.0), 3),
                                "p99": round(build.get("p99", 0.0), 3)},
        "recall_floor": min(r["recall"] for r in rows),
        "device": str(device),
        "note": ("pause = locked swap only; the rebuild runs off-lock on "
                 "the worker thread (build histogram)")})
    s.close()
    return rows


def bench_wal(n, d, quick, device):
    """Durability cost curve: insert throughput under each WAL sync policy
    (none attached, sync=none, group-commit batch, fsync-always) plus the
    recovery path (checkpoint restore + tail replay) wall.  Writes wal.csv
    and BENCH_pt_wal.json with the overhead ratios against the no-WAL
    baseline and replayed records per second."""
    from repro_torch.index import io as iio
    from repro_torch.streaming import StreamingRFANN
    from repro_torch.streaming import wal as walmod

    n0 = min(n, 2048)
    vecs, attrs = dataset(n0, d)
    m = 8 if quick else 16
    n_ops = 400 if quick else 4000
    build = dict(m=m, ef_spatial=m, ef_attribute=2 * m, max_delta=10**9,
                 device=device)
    tmp = Path(tempfile.mkdtemp(prefix="bench_wal_"))
    rows = []
    replay_row = {}
    try:
        for sync in ("nowal", "none", "batch", "always"):
            s = StreamingRFANN(vecs, attrs, **build)
            wd = tmp / f"wal_{sync}"
            if sync != "nowal":
                s.attach_wal(wd, sync=sync)
            rng = np.random.default_rng(17)
            t0 = time.perf_counter()
            for _ in range(n_ops):
                s.insert(rng.standard_normal(d).astype(np.float32),
                         float(rng.random()))
            dt = time.perf_counter() - t0
            st = s._wal.stats() if sync != "nowal" else {}
            rows.append(dict(sync=sync, ops=n_ops,
                             ops_per_s=round(n_ops / dt, 1),
                             us_per_op=round(dt / n_ops * 1e6, 1),
                             fsyncs=st.get("fsyncs", 0),
                             wal_bytes=st.get("bytes_written", 0)))
            if sync == "batch":     # recovery wall off the batch log
                ck = tmp / "ckpt"
                iio.save_index(StreamingRFANN(vecs, attrs, **build), ck)
                s._wal.flush()
                t0 = time.perf_counter()
                rec = StreamingRFANN.recover(ck, wd, attach=False,
                                             device=device)
                t_rec = time.perf_counter() - t0
                assert rec.stats()["n_live"] == s.stats()["n_live"]
                replay_row = dict(
                    recovery_seconds=round(t_rec, 3),
                    replayed_records=n_ops,
                    replay_records_per_s=round(n_ops / max(t_rec, 1e-9), 1),
                    segments=walmod.describe(wd)["segments"])
                rec.close()
            s.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("wal", rows, quiet=True)
    base = next(r for r in rows if r["sync"] == "nowal")["us_per_op"]
    emit_bench_json("wal", {
        "n0": n0, "d": d, "n_ops": n_ops, "rows": rows,
        "overhead_vs_nowal": {
            r["sync"]: round(r["us_per_op"] / max(base, 1e-9), 2)
            for r in rows if r["sync"] != "nowal"},
        "recovery": replay_row, "device": str(device),
        "note": ("inserts pay an O(delta) host re-sort that grows over the "
                 "run; it is identical across sync policies, so the ratios "
                 "isolate the WAL cost")})
    return rows


ALL = ["qps_recall", "construction_time", "index_size", "param_sensitivity",
       "vary_k", "scalability", "planner", "search_substrate", "mesh_auto",
       "async_cache", "beam_width", "quantized", "streaming", "kernels",
       "build", "wal"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    quick = not args.full
    n = args.n or (4096 if quick else 16384)
    d = 32 if quick else 64
    nq = 200 if quick else 1000
    only = set(args.only.split(",")) if args.only else set(ALL)
    unknown = sorted(only - set(ALL))
    if unknown:
        for b in unknown:
            print(f"run_torch: unknown bench {b!r}; choose from "
                  f"{','.join(ALL)}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    print("name,us_per_call,derived")
    t_all = time.perf_counter()
    methods = None
    if only & {"qps_recall", "construction_time", "index_size"}:
        vecs, attrs = dataset(n, d)     # one build of each method serves all
        methods = build_methods(vecs, attrs, quick, device)
    if "qps_recall" in only:
        rows = bench_qps_recall(n, d, nq, quick, device, methods)
        best = max((r for r in rows if r["method"] == "rnsg"
                    and r["workload"] == "mixed"), key=lambda r: r["recall"])
        print(f"qps_recall,{1e6/best['qps']:.1f},"
              f"rnsg_mixed_recall={best['recall']}@qps={best['qps']}")
    if "construction_time" in only:
        rows = bench_construction_time(n, d, quick, device, methods)
        rn = next(r for r in rows if r["method"] == "rnsg")
        sg = next(r for r in rows if r["method"] == "segtree")
        print(f"construction_time,{rn['build_seconds']*1e6:.0f},"
              f"rnsg={rn['build_seconds']}s_segtree={sg['build_seconds']}s")
    if "index_size" in only:
        rows = bench_index_size(n, d, quick, device, methods)
        rn = next(r for r in rows if r["method"] == "rnsg")
        sg = next(r for r in rows if r["method"] == "segtree")
        print(f"index_size,0,rnsg={rn['index_mb']}MB_segtree={sg['index_mb']}MB"
              f"_ratio={sg['index_mb']/max(rn['index_mb'],1e-9):.1f}x")
    if "param_sensitivity" in only:
        rows = bench_param_sensitivity(n, d, nq, quick, device)
        print(f"param_sensitivity,0,points={len(rows)}")
    if "vary_k" in only:
        rows = bench_vary_k(n, d, nq, quick, device)
        print(f"vary_k,0,recall@50={rows[-1]['recall']}")
    if "scalability" in only:
        rows = bench_scalability(d, nq, quick, device)
        print(f"scalability,0,qps_{rows[0]['n']}={rows[0]['qps']}"
              f"_qps_{rows[-1]['n']}={rows[-1]['qps']}")
    if "planner" in only:
        rows = bench_planner(n, d, nq, quick, device)
        print("method,workload,ef,recall,qps,scan_frac")
        for r in rows:
            print(f"{r['method']},{r['workload']},{r['ef']},{r['recall']},"
                  f"{r['qps']},{r['scan_frac']}")
        np_ = next(r for r in rows if r["method"] == "planner"
                   and r["workload"] == "narrow_1pct")
        ng = next(r for r in rows if r["method"] == "graph"
                  and r["workload"] == "narrow_1pct")
        wp = next(r for r in rows if r["method"] == "planner"
                  and r["workload"] == "wide_50pct")
        print(f"planner,{1e6/np_['qps']:.1f},"
              f"narrow_speedup_vs_graph={np_['qps']/max(ng['qps'],1e-9):.2f}x"
              f"_narrow_recall={np_['recall']}vs{ng['recall']}"
              f"_narrow_scan_frac={np_['scan_frac']}"
              f"_wide_scan_frac={wp['scan_frac']}")
    if "search_substrate" in only:
        rows = bench_search_substrate(n, d, nq, quick, device)
        pre = next(r for r in rows if r["method"] == "beam_pre_early_out"
                   and r["workload"] == "narrow_1pct")
        post = next(r for r in rows if r["method"] == "beam_post_early_out"
                    and r["workload"] == "narrow_1pct")
        print(f"search_substrate,{1e6/post['qps']:.1f},"
              f"narrow_early_out_speedup="
              f"{post['qps']/max(pre['qps'],1e-9):.2f}x")
    if "mesh_auto" in only:
        rows = bench_mesh_auto(n, d, nq, quick, device)
        print("method,workload,ef,recall,qps,scan_frac,devices,shards")
        for r in rows:
            print(f"{r['method']},{r['workload']},{r['ef']},{r['recall']},"
                  f"{r['qps']},{r['scan_frac']},{r['devices']},{r['shards']}")
        na = next(r for r in rows if r["method"] == "mesh_auto"
                  and r["workload"] == "narrow_1pct")
        ng = next(r for r in rows if r["method"] == "mesh_graph"
                  and r["workload"] == "narrow_1pct")
        print(f"mesh_auto,{1e6/float(na['qps']):.1f},"
              f"narrow_speedup_vs_mesh_graph="
              f"{float(na['qps'])/max(float(ng['qps']),1e-9):.2f}x"
              f"_narrow_recall={na['recall']}vs{ng['recall']}"
              f"_narrow_scan_frac={na['scan_frac']}")
    if "async_cache" in only:
        rows = bench_async_cache(n, d, nq, quick, device)
        print("method,plan,qps_base,qps_new,speedup,identical,detail")
        for r in rows:
            print(f"{r['method']},{r['plan']},{r['qps_base']},{r['qps_new']},"
                  f"{r['speedup']},{r['identical']},{r['detail']}")
        cg = next(r for r in rows if r["method"] == "cache_repeat"
                  and r["plan"] == "graph")
        ag = next(r for r in rows if r["method"] == "async_local_8shard"
                  and r["plan"] == "auto")
        print(f"async_cache,{1e6/float(cg['qps_new']):.1f},"
              f"cache_repeat_speedup={cg['speedup']}x"
              f"_identical={cg['identical']}"
              f"_async_vs_seq={ag['speedup']}x")
    if "beam_width" in only:
        rows = bench_beam_width(n, d, nq, quick, device)
        print("workload,beam_width,ef,qps,recall,ndist,hops")
        for r in rows:
            print(f"{r['workload']},{r['beam_width']},{r['ef']},{r['qps']},"
                  f"{r['recall']},{r['ndist']},{r['hops']}")
        nb, bb = _beam_width_best(rows)
        if bb is None:
            print(f"beam_width,{1e6/nb['qps']:.1f},"
                  f"no_width_matches_baseline_recall={nb['recall']}")
        else:
            print(f"beam_width,{1e6/bb['qps']:.1f},"
                  f"narrow_speedup_bw{bb['beam_width']}="
                  f"{bb['qps']/max(nb['qps'],1e-9):.2f}x"
                  f"_recall={bb['recall']}vs{nb['recall']}"
                  f"_hops={bb['hops']}vs{nb['hops']}")
    if "quantized" in only:
        rows = bench_quantized(n, d, nq, quick, device)
        print("workload,strategy,precision,ef,recall,qps,bytes_per_vector")
        for r in rows:
            print(f"{r['workload']},{r['strategy']},{r['precision']},"
                  f"{r['ef']},{r['recall']},{r['qps']},"
                  f"{r['bytes_per_vector']}")
        f32 = next(r for r in rows if r["workload"] == "narrow_1pct"
                   and r["strategy"] == "scan" and r["precision"] == "f32")
        i8 = next(r for r in rows if r["workload"] == "narrow_1pct"
                  and r["strategy"] == "scan" and r["precision"] == "int8")
        print(f"quantized,{1e6/i8['qps']:.1f},"
              f"narrow_scan_int8_speedup={i8['qps']/max(f32['qps'],1e-9):.2f}x"
              f"_recall={i8['recall']}vs{f32['recall']}"
              f"_bytes={i8['bytes_per_vector']}vs{f32['bytes_per_vector']}")
    if "streaming" in only:
        rows = bench_streaming(n, d, nq, quick, device)
        print("delta_frac_target,delta_frac,n_live,n_delta,recall,qps")
        for r in rows:
            print(f"{r['delta_frac_target']},{r['delta_frac']},{r['n_live']},"
                  f"{r['n_delta']},{r['recall']},{r['qps']}")
        r0, r20 = rows[0], rows[-1]
        print(f"streaming,{1e6/r20['qps']:.1f},"
              f"recall_delta0={r0['recall']}_delta20pct={r20['recall']}"
              f"_qps_ratio={r20['qps']/max(r0['qps'],1e-9):.2f}x")
    if "kernels" in only:
        rows = bench_kernels(quick, device)
        for r in rows:
            print(f"kernel_{r['kernel']},{r['us_per_call']},"
                  f"shape={r['shape']}_bound_us={r['bound_us']}"
                  f"_library_us={r['library_us']}_device={r['device']}")
    if "build" in only:
        rows = bench_build(n, d, quick, device)
        print("method,shards,seconds,restore_seconds,identical")
        for r in rows:
            print(f"{r['method']},{r['shards']},{r['seconds']},"
                  f"{r['restore_seconds']},{r['identical']}")
        single = next(r for r in rows if r["method"] == "build_single")
        best = min(float(r["restore_seconds"]) for r in rows
                   if r["method"] == "persist")
        ident = all(int(r["identical"]) for r in rows)
        print(f"build,{float(single['seconds'])*1e6:.0f},"
              f"restore_speedup_vs_rebuild="
              f"{float(single['seconds'])/max(best,1e-9):.1f}x"
              f"_bit_identical={ident}")
    if "wal" in only:
        rows = bench_wal(n, d, quick, device)
        print("sync,ops,ops_per_s,us_per_op,fsyncs,wal_bytes")
        for r in rows:
            print(f"{r['sync']},{r['ops']},{r['ops_per_s']},"
                  f"{r['us_per_op']},{r['fsyncs']},{r['wal_bytes']}")
        nw = next(r for r in rows if r["sync"] == "nowal")
        bt = next(r for r in rows if r["sync"] == "batch")
        aw = next(r for r in rows if r["sync"] == "always")
        print(f"wal,{aw['us_per_op']},"
              f"batch_overhead={bt['us_per_op']/max(nw['us_per_op'],1e-9):.2f}x"
              f"_always_overhead="
              f"{aw['us_per_op']/max(nw['us_per_op'],1e-9):.2f}x"
              f"_always_fsyncs={aw['fsyncs']}")
    print(f"# total benchmark wall: {time.perf_counter()-t_all:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

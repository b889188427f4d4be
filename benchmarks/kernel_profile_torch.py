#!/usr/bin/env python3
"""Per-call time of the scan, rerank and distance kernels on the card, split
three ways.

    python3 benchmarks/kernel_profile_torch.py [--src DIR] [--tag NAME]
        [--only range_scan,l2dist,gather_rerank] [--segtree N]

Imports ``repro_torch`` from ``--src`` (default: this tree's ``src``), so
the same script reads a parent tree unpacked beside this one.  Shapes:

* ``ops.range_scan`` on ``chip_smoke.py``'s parity data (a 1,000,000 ×
  128 corpus from ``make_vectors(N, 128, SEED + 2)``, 64 queries, windows of
  ``bucket/2 .. bucket`` rows with one empty, one one-row tail and one
  unaligned start; int32 starts and lengths, as the search path passes
  them): f32 at k=10 over buckets 64 .. 131072, and the int8
  (with its scale) and bf16 copies at k=10 and k=128 over buckets 512,
  8192 and 65536;
* ``ops.gather_rerank`` and the whole ``core.beam.rerank_pool`` (the
  quantized paths' rerank stage, with ``use_kernel``) on the same
  corpus, unpadded, with 64 queries at d = 128: M in {64, 128, 512, 4096,
  30000} survivor ids per query (10 % masked, one all-masked row, int32
  as the search path passes them) and k in {10, 128, 200, 3000}, each with
  the ids sorted ascending (``sort_candidates``) and unsorted;
* ``ops.l2dist`` in f32 at the segment-tree build's top tile (4096 ×
  100,000 × 128), at 1024 × 262,144 × 128 and at the microbench shapes
  128 × 1024 and 256 × 4096 (d = 128), with ``torch.cdist`` (matmul path,
  TF32 off) beside it;
* with ``--segtree N``, the bench phase's segment tree built at N rows
  (twice, after one untimed build): its build seconds and the summed
  CUDA-event time of its ``l2dist`` calls.

First it prints ``ptxas``'s registers, shared memory and spills of each
kernel it builds (the tree's libraries are built anew).  For each shape
it prints the median CUDA-event time per call over REPS calls, the
wrapper's host time per call (the host clock from the call to its return,
the device idle before it), and, from ``torch.profiler`` over PROF_CALLS
calls, the device launches per call and each kernel's own device time per
call (read again, up to three times, where a session dropped every event);
beside them the bound (the larger of bytes over 3.35 TB/s and flops over
67 TFLOP/s).  The profiler readings come last, after every timing and the
segment tree's builds, and the lines print then.  Timing, profiling and
bounds are ``chip_smoke.py``'s own helpers.  The last line is one JSON
object, also written to ``chiprun_out/kernel_profile[-TAG].json``.  Needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import _bound, _covered, _device_ms, _time_ms  # noqa: E402

N, SEED = 1_000_000, 0      # chip_smoke.py's full-phase corpus
REPS, PROF_CALLS = 40, 10
SCAN_F32_BUCKETS = [1 << i for i in range(6, 18)]          # 64 .. 131072
SCAN_QUANT_BUCKETS = (512, 8192, 65536)
L2_SHAPES = [(4096, 100_000, 128), (1024, 262_144, 128), (128, 1024, 128),
             (256, 4096, 128)]
RERANK_M = (64, 128, 512, 4096, 30000)
RERANK_K = (10, 128, 200, 3000)
#: the kernel library each --only name rebuilds
LIBRARY = {"range_scan": "range_scan", "l2dist": "l2dist",
           "gather_rerank": "gather_dist"}


def measure(fn, reps: int = REPS):
    """(event ms, host ms) of one call: chip_smoke's CUDA-event median and
    the median host time from the call to its return with the device idle
    before it."""
    import torch
    ms = _time_ms(fn, reps)
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return ms, float(np.median(host))


def read_device(recs, calls) -> None:
    """chip_smoke's profiler reading of each record's call (device
    launches per call, {kernel: device ms per call}), taken after every
    timing of the run: a profiler session slows every later host-side
    torch op of the process (``chip_smoke._DEVICE_PROBES``)."""
    for rec, fn in zip(recs, calls):
        for _ in range(3):      # a session may drop all of its events
            _, rec["launches_per_call"], rec["device_ms"] = _device_ms(
                fn, PROF_CALLS)
            if rec["launches_per_call"]:
                break
        rec["device_total_ms"] = sum(rec["device_ms"].values())
        _line(rec["kernel"], rec)


def _line(tag, rec):
    kern = "; ".join(f"{k[:60]} {v:.4f}" for k, v in
                     sorted(rec["device_ms"].items(), key=lambda kv: -kv[1]))
    print(f"[{tag}] {rec['shape']}: event {rec['ms']:.4f} ms, host "
          f"{rec['host_ms']:.4f} ms, device {rec['device_total_ms']:.4f} ms "
          f"in {rec['launches_per_call']:g} launches ({kern}), bound "
          f"{rec['bound_ms']:.4f} ({rec['bound_by']})"
          + (f", library {rec['library_ms']:.4f}"
             if rec.get("library_ms") is not None else ""), flush=True)


def profile_scan(ops, quantize_corpus):
    import torch
    from repro_torch.data.ann import make_vectors
    dev = torch.device("cuda")
    n = N
    vecs = torch.as_tensor(make_vectors(n, 128, seed=SEED + 2), device=dev)
    n_pad = -(-n // 128) * 128
    x_pad = torch.nn.functional.pad(vecs, (0, 0, 0, n_pad - n))
    d_pad = 128
    nq = 64
    rng = np.random.default_rng(SEED + 101)
    qv = torch.as_tensor(rng.standard_normal((nq, d_pad)).astype(np.float32)
                         * 4.0, device=dev)
    corpora = {"f32": (x_pad, None)}
    for p in ("int8", "bf16"):
        qc = quantize_corpus(vecs, p)
        corpora[p] = (torch.nn.functional.pad(
            qc.data, (0, 0, 0, n_pad - n)), qc.scale)
    del vecs
    cases = [("f32", b, 10) for b in SCAN_F32_BUCKETS]
    cases += [(p, b, k) for p in ("int8", "bf16")
              for b in SCAN_QUANT_BUCKETS for k in (10, 128)]
    recs, calls = [], []
    for prec, b, k in cases:
        data, scale = corpora[prec]
        starts = rng.integers(0, max(n - b // 2, 1), nq)
        lens = rng.integers(b // 2, b + 1, nq)
        lens[0] = 0
        starts[1], lens[1] = n - 1, 1
        starts[2] = 128 * 7 + 37
        # int32, as the search path passes them (no conversion launch)
        st = torch.as_tensor(starts.astype(np.int32), device=dev)
        ln = torch.as_tensor(lens.astype(np.int32), device=dev)
        fn = functools.partial(ops.range_scan, data, st, ln, qv, bucket=b,
                               k=k, n_valid=n, scale=scale)
        ms, host = measure(fn)
        rows = int(_covered(starts, lens, n).sum())
        scored = np.clip(np.minimum(starts + lens, n) - starts, 0, None)
        item = data.element_size()
        bound, by = _bound(
            rows * d_pad * item + (0 if scale is None else d_pad * 4)
            + qv.numel() * 4 + nq * 8 + nq * k * 8,
            float(scored.sum()) * (4 + (scale is not None)) * d_pad)
        rec = dict(kernel="range_scan", dtype=prec, bucket=b, k=k, q=nq,
                   shape=f"range_scan {prec} q={nq} bucket={b} k={k}",
                   ms=ms, host_ms=host, bound_ms=bound, bound_by=by,
                   rows=rows)
        recs.append(rec)
        calls.append(fn)
    return recs, calls


def profile_rerank(ops, rerank_pool, sort_candidates):
    import torch
    from repro_torch.data.ann import make_vectors
    dev = torch.device("cuda")
    vecs = torch.as_tensor(make_vectors(N, 128, seed=SEED + 2), device=dev)
    nq, d = 64, vecs.shape[1]
    rng = np.random.default_rng(SEED + 202)
    q = torch.as_tensor(rng.standard_normal((nq, d)).astype(np.float32)
                        * 4.0, device=dev)
    recs, calls = [], []
    for m in RERANK_M:
        raw = rng.integers(0, N, (nq, m))
        raw[rng.random((nq, m)) < 0.1] = -1
        raw[0] = -1                                     # all-masked row
        valid = raw[raw >= 0]
        rows = len(np.unique(valid))
        unsorted = torch.as_tensor(raw.astype(np.int32), device=dev)
        orders = {"unsorted": unsorted, "sorted": sort_candidates(unsorted)}
        for k in RERANK_K:
            bound, by = _bound(rows * d * 4 + nq * m * 4 + q.numel() * 4
                               + nq * k * 8, float(valid.size) * d * 3)
            for order, ids in orders.items():
                for what, fn in (
                        ("gather_rerank", functools.partial(
                            ops.gather_rerank, vecs, ids, q, k=k)),
                        ("rerank_pool", functools.partial(
                            rerank_pool, vecs, ids, q, k, True))):
                    ms, host = measure(fn, REPS // 4 if m * k > 1 << 24
                                       else REPS)
                    recs.append(dict(
                        kernel=what, dtype="f32", m=m, k=k, q=nq,
                        order=order, shape=f"{what} q={nq} m={m} k={k} "
                        f"d={d} {order}", ms=ms, host_ms=host,
                        bound_ms=bound, bound_by=by, rows=rows))
                    calls.append(fn)
    return recs, calls


def profile_l2(ops):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 303)
    recs, calls = [], []
    for q, n, d in L2_SHAPES:
        a = torch.as_tensor(rng.standard_normal((q, d)).astype(np.float32),
                            device="cuda")
        b = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                            device="cuda")
        r = REPS // 4 if q * n > 1 << 24 else REPS
        fn = functools.partial(ops.l2dist, a, b)
        ms, host = measure(fn, r)
        lib = _time_ms(lambda: torch.cdist(
            a, b, compute_mode="use_mm_for_euclid_dist"), r)
        bound, by = _bound((q * d + n * d) * 4 + q * n * 4, 2.0 * q * n * d)
        rec = dict(kernel="l2dist", dtype="f32", shape=f"l2dist f32 "
                   f"{q}x{n}x{d}", q=q, n=n, d=d, ms=ms, host_ms=host,
                   bound_ms=bound, bound_by=by, library_ms=lib)
        recs.append(rec)
        calls.append(fn)
        torch.cuda.empty_cache()
    return recs, calls


def profile_segtree(ops, n: int):
    """The bench phase's segment tree (m=48, ef_spatial=96, as
    ``build_methods(quick=False)`` makes it, on ``dataset(n, 128)``) built
    once untimed and twice timed, with ``ops.l2dist`` wrapped in CUDA
    events: build seconds and the summed event time of its l2dist calls."""
    import torch
    from benchmarks.common_torch import dataset
    from repro_torch.index.baselines import SegmentTreeIndex
    vecs, attrs = dataset(n, 128, seed=SEED)
    inner = ops.l2dist
    events = []

    def timed(q, x):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = inner(q, x)
        e.record()
        events.append((s, e))
        return out

    ops.l2dist = timed
    try:
        runs = []
        for rep in range(3):
            events.clear()
            torch.cuda.synchronize()
            ix = SegmentTreeIndex(vecs, attrs, m=48, ef_spatial=96,
                                  device="cuda")
            torch.cuda.synchronize()
            l2 = sum(s.elapsed_time(e) for s, e in events)
            if rep:
                runs.append(dict(build_seconds=ix.build_seconds,
                                 l2dist_calls=len(events), l2dist_ms=l2))
    finally:
        ops.l2dist = inner
    for r in runs:
        print(f"[segtree] n={n}: build {r['build_seconds']:.3f} s, "
              f"{r['l2dist_calls']} l2dist calls, {r['l2dist_ms']:.2f} ms "
              f"of their event time", flush=True)
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", default="range_scan,l2dist",
                    help="kernels to profile, of range_scan, l2dist and "
                         "gather_rerank (empty: none)")
    ap.add_argument("--segtree", type=int, default=0,
                    help="also build the benchmark's segment tree at this "
                         "many rows and time its l2dist calls")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_profile: no CUDA device is present", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core.beam import rerank_pool
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.quantize import quantize_corpus, sort_candidates
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    print(f"[profile] package {Path(ops.__file__).parents[1]} torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    only = set(filter(None, args.only.split(",")))
    if only - set(LIBRARY):
        ap.error(f"--only: unknown kernels {sorted(only - set(LIBRARY))}")
    names = [LIBRARY[k] for k in LIBRARY if k in only]
    if args.segtree and "l2dist" not in names:
        names.append("l2dist")
    for name in names:
        _build.target(name).unlink(missing_ok=True)
    ptxas = {}
    for name, log in _build.build_all(names, verbose=True).items():
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if any(w in ln for w in ("entry function",
                                                "registers", "spill"))]
        for ln in ptxas[name]:
            print(f"[ptxas {name}] {ln}")
    result = dict(card=card, src=args.src, n=N, seed=SEED, ptxas=ptxas,
                  records=[])
    calls = []
    for kernel, run in (("range_scan", lambda: profile_scan(
            ops, quantize_corpus)), ("l2dist", lambda: profile_l2(ops)),
            ("gather_rerank", lambda: profile_rerank(
                ops, rerank_pool, sort_candidates))):
        if kernel in only:
            recs, fns = run()
            result["records"] += recs
            calls += fns
    if args.segtree:
        result["segtree"] = profile_segtree(ops, args.segtree)
    read_device(result["records"], calls)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = f"kernel_profile{'-' + args.tag if args.tag else ''}.json"
    (out / name).write_text(json.dumps(result, indent=1))
    print(json.dumps(dict(card=card, src=args.src, records=[
        {k: r[k] for k in ("shape", "ms", "host_ms", "device_total_ms",
                           "launches_per_call", "bound_ms")}
        for r in result["records"]])))
    return 0


if __name__ == "__main__":
    sys.exit(main())

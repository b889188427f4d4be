#!/usr/bin/env python3
"""Where one search batch's wall time goes on the card, hop by hop.

    python3 benchmarks/hop_profile_torch.py [--src DIR] [--n 1000000]

Imports ``repro_torch`` from ``--src`` (default: this tree's ``src``), so
the same script reads a parent tree unpacked beside this one.  Builds
``chip_smoke.py``'s full-phase index (n × 128 from ``--seed``, the
``build_rnsg`` defaults, 1,000 queries of the mixed workload), then for the
f32 paths (bw 1, kernels) and (bw 4, kernels) at ``plan="auto"``, k=10,
ef=64, batches of 64:

* every batch once untimed, then every batch again with a ``QueryTrace``:
  resolve / plan / dispatch / stitch wall per batch, and inside dispatch
  the wall of each ``beam_search_batch`` call (host clock, synchronised);
* batch ``--batch-index`` (all graph-routed at the default) three more
  times: its beam wall, lockstep hops (the gather launches of that call, or
  the longest lane's hops where the loop is one kernel) and per-hop wall;
* the same batch once under ``torch.profiler`` (CPU + CUDA activities):
  device time per kernel name, the gather kernels' device time, the host
  time of the ``.any()`` syncs (``aten::_local_scalar_dense``, which waits
  for the queued device work) and of every other op;
* the host cost of one ``torch.profiler.record_function`` span with no
  profiler session (the substrate opens one per dispatched partition),
  before any profiler session of the process.

Prints one line per measurement and, last, one JSON object (also written
to ``chiprun_out/hop_profile.json``).  Needs one CUDA card.

``--stream`` profiles the streaming index's search instead
(``StreamingRFANN``, this tree only): a base of n - 4,096 rows, then 4,096
inserts of the held-out rows (the delta of the stream phase of
``chip_smoke.py`` before it compacts) and 1,024 deletes of base rows
(tombstones), then the same batches at ``plan="auto"``, k=10,
ef=64, bw 1, each batch once with the delta view it found (its padded
copy already on the card) and once right after one more insert (a new
view, so the delta's padded copy is uploaded again, as in serving with
churn): per batch the search wall, the delta segment's upload, its scan
(``DeltaView.search``, host set-up and copies included), the base
segment's dispatch and result, and the merge (host clock, synchronised);
JSON to ``chiprun_out/hop_profile_stream.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PATHS = [("bw1_kernel", 1), ("bw4_kernel", 4)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-index", type=int, default=0)
    ap.add_argument("--stream", action="store_true",
                    help="profile StreamingRFANN.search (this tree only)")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("hop_profile: no CUDA device is present", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.search.substrate as sub
    from repro_torch.core.rfann import RNSGIndex
    from repro_torch.data.ann import make_attrs, make_vectors, mixed_workload
    from repro_torch.kernels import ops
    from repro_torch.obs import QueryTrace
    from repro_torch.planner import SCAN
    sync = torch.cuda.synchronize
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    allv = make_vectors(args.n + args.nq, 128, seed=args.seed)
    base, qv = allv[:args.n], allv[args.n:]
    attrs = make_attrs(args.n, seed=args.seed)
    ranges, _ = mixed_workload(attrs, args.nq, seed=args.seed)
    if args.stream:
        return stream_profile(args, card, base, attrs, qv, ranges)
    t0 = time.perf_counter()
    idx = RNSGIndex.build(base, attrs, m=32, ef_spatial=32, ef_attribute=48,
                          device="cuda")
    print(f"[hop] package {Path(sub.__file__).parents[1]} n={args.n} built "
          f"in {time.perf_counter() - t0:.1f} s")
    built = json.dumps(idx.planner.cost.state_dict())

    beam_walls = []
    inner = sub.beam_search_batch

    def timed_beam(*a, **kw):
        sync()
        t1 = time.perf_counter()
        out = inner(*a, **kw)
        sync()
        beam_walls.append(time.perf_counter() - t1)
        return out

    sub.beam_search_batch = timed_beam
    reps = 20000
    t1 = time.perf_counter()
    for _ in range(reps):
        with torch.profiler.record_function("rnsg.scan_dispatch"):
            pass
    span_us = (time.perf_counter() - t1) / reps * 1e6
    print(f"[hop] record_function span, no session: {span_us:.3f} us")
    batches = [(lo, qv[lo:lo + 64], ranges[lo:lo + 64])
               for lo in range(0, args.nq, 64)]
    bi = args.batch_index
    result = dict(card=card, n=args.n, nq=args.nq, src=args.src,
                  batch_index=bi, record_function_us=span_us, paths={})
    for name, bw in PATHS:
        kw = dict(k=10, ef=64, plan="auto", beam_width=bw, use_kernel=True)
        idx.planner.cost.load_state_dict(json.loads(built))
        for _, q_b, r_b in batches:                       # warm, untimed
            idx.search(q_b, r_b, **kw)
        per_batch = []
        for lo, q_b, r_b in batches:
            tr = QueryTrace()
            beam_walls.clear()
            sync()
            t1 = time.perf_counter()
            res = idx.search(q_b, r_b, trace=tr, **kw)
            wall = time.perf_counter() - t1
            per_batch.append(dict(
                lo=lo, wall_ms=wall * 1e3,
                **{f"{s}_ms": tr.wall_ms(s) for s in
                   ("resolve", "plan", "dispatch", "stitch")},
                beam_ms=sum(beam_walls) * 1e3, beam_calls=len(beam_walls),
                graph_routed=int((res.stats["strategy"] != SCAN).sum())))
        agg = {key: float(np.mean([b[key] for b in per_batch]))
               for key in per_batch[0] if key.endswith("_ms")}
        print(f"[hop] {name}: mean per batch over {len(per_batch)} batches "
              + " ".join(f"{k}={v:.3f}" for k, v in agg.items()))
        _, q_b, r_b = batches[bi]
        reps = []
        for _ in range(3):
            beam_walls.clear()
            ops.reset_launches()
            res = idx.search(q_b, r_b, **kw)
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            lock = sum(v for k, v in launches.items()
                       if k.startswith(("gather_dist", "gather_topk")))
            hops = lock or int(np.max(res.stats["hops"]))
            reps.append(dict(beam_ms=sum(beam_walls) * 1e3, hops=hops,
                             launches=launches,
                             max_lane_hops=int(np.max(res.stats["hops"]))))
        beam_ms = float(np.median([r["beam_ms"] for r in reps]))
        hops = reps[0]["hops"]
        print(f"[hop] {name} batch {bi}: beam wall {beam_ms:.3f} ms over "
              f"{hops} hops ({beam_ms / max(hops, 1):.4f} ms per hop); "
              f"launches {reps[0]['launches']}")
        beam_walls.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            idx.search(q_b, r_b, **kw)
        prof_wall = sum(beam_walls) * 1e3
        rows = p.key_averages()
        # the substrate's spans (rnsg.*) come back as device-side user
        # annotations that cover the kernels they enclose: not kernels
        kern = {e.key: dict(count=e.count,
                            device_ms=e.self_device_time_total / 1e3)
                for e in rows if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0
                and not e.key.startswith("rnsg.")}
        cpu = sorted(((e.key, e.count, e.cpu_time_total / 1e3,
                       e.self_cpu_time_total / 1e3) for e in rows),
                     key=lambda r: -r[3])
        device_ms = sum(v["device_ms"] for v in kern.values())
        gather_ms = sum(v["device_ms"] for k, v in kern.items()
                        if "gather_dist_kernel" in k
                        or "topk_block_kernel" in k
                        or "beam_" in k)
        sync_ms = sum(r[2] for r in cpu
                      if r[0] == "aten::_local_scalar_dense")
        prof = dict(beam_wall_ms=prof_wall, device_ms=device_ms,
                    gather_device_ms=gather_ms, sync_ms=sync_ms,
                    other_host_ms=prof_wall - sync_ms,
                    kernels=kern,
                    top_cpu=[dict(op=r[0], count=r[1], total_ms=r[2],
                                  self_ms=r[3]) for r in cpu[:30]])
        print(f"[hop] {name} batch {bi} profiled: beam wall "
              f"{prof_wall:.3f} ms, device busy {device_ms:.3f} ms "
              f"(idle share {1 - device_ms / max(prof_wall, 1e-9):.3f}), "
              f"gather kernels {gather_ms:.3f} ms, .any() syncs "
              f"{sync_ms:.3f} ms, other host {prof_wall - sync_ms:.3f} "
              f"ms; per hop: gather {gather_ms / max(hops, 1):.4f}, sync "
              f"{sync_ms / max(hops, 1):.4f}, other "
              f"{(prof_wall - sync_ms) / max(hops, 1):.4f} ms")
        for k, v in sorted(kern.items(),
                           key=lambda kv: -kv[1]["device_ms"])[:12]:
            print(f"[hop]   device {v['device_ms']:.4f} ms x{v['count']} "
                  f"{k[:90]}")
        for r in prof["top_cpu"][:12]:
            print(f"[hop]   host self {r['self_ms']:.3f} ms "
                  f"(total {r['total_ms']:.3f}) x{r['count']} {r['op']}")
        result["paths"][name] = dict(per_batch=per_batch, mean=agg,
                                     batch=reps, beam_ms=beam_ms, hops=hops,
                                     profile=prof)
    sub.beam_search_batch = inner
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "hop_profile.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "paths"}
                     | {"paths": {p: dict(beam_ms=v["beam_ms"],
                                          hops=v["hops"], mean=v["mean"])
                                  for p, v in result["paths"].items()}}))
    return 0


def stream_profile(args, card, base, attrs, qv, ranges) -> int:
    """The streaming index's per-batch costs (see the module's doc)."""
    import torch
    import repro_torch.streaming.streaming as st
    from repro_torch.streaming import DeltaView, StreamingRFANN
    sync = torch.cuda.synchronize
    delta = 4096
    n0 = args.n - delta
    t0 = time.perf_counter()
    s = StreamingRFANN(base[:n0], attrs[:n0], m=32, ef_spatial=32,
                       ef_attribute=48, max_delta=10**9, device="cuda")
    print(f"[stream] base n0={n0} built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for j in range(n0, args.n):
        s.insert(base[j], float(attrs[j]), ext_id=j)
    ins_s = time.perf_counter() - t0
    for e in rng.choice(n0, delta // 4, replace=False):
        s.delete(int(e))
    print(f"[stream] {delta} inserts in {ins_s:.2f} s "
          f"({ins_s / delta * 1e3:.3f} ms each), {delta // 4} deletes; "
          f"{s.stats()}")
    spans = {}

    def timed(name, fn):
        def run(*a, **kw):
            sync()
            t1 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t1
            return out
        return run

    inner = (DeltaView._device, DeltaView.search, st.merge_topk)
    DeltaView._device = timed("delta_upload", inner[0])
    DeltaView.search = timed("delta_search", inner[1])
    st.merge_topk = timed("merge", inner[2])
    kw = dict(k=10, ef=64, plan="auto")
    batches = [(qv[lo:lo + 64], ranges[lo:lo + 64])
               for lo in range(0, args.nq, 64)]
    for q_b, r_b in batches:                              # warm, untimed
        s.search(q_b, r_b, **kw)
    rows = {}
    extra = iter(range(10**9, 10**9 + len(batches)))
    try:
        for case in ("same_view", "after_insert"):
            per = []
            for q_b, r_b in batches:
                if case == "after_insert":
                    s.insert(q_b[0], float(r_b[0, 0]), ext_id=next(extra))
                spans.clear()
                sync()
                t1 = time.perf_counter()
                s.search(q_b, r_b, **kw)
                wall = (time.perf_counter() - t1) * 1e3
                rec = {f"{k}_ms": v * 1e3 for k, v in spans.items()}
                rec.setdefault("delta_upload_ms", 0.0)
                rec["wall_ms"] = wall
                rec["base_ms"] = (wall - rec["delta_search_ms"]
                                  - rec.get("merge_ms", 0.0))
                per.append(rec)
            mean = {k: float(np.mean([r[k] for r in per])) for k in per[0]}
            rows[case] = dict(per_batch=per, mean=mean)
            print(f"[stream] {case}: mean per batch over {len(per)} "
                  f"batches " + " ".join(f"{k}={v:.3f}"
                                         for k, v in mean.items()))
    finally:
        DeltaView._device, DeltaView.search, st.merge_topk = inner
    result = dict(card=card, n=args.n, n0=n0, delta=delta,
                  nq=args.nq, insert_ms=ins_s / delta * 1e3,
                  stats=s.stats(), cases=rows)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "hop_profile_stream.json").write_text(json.dumps(result,
                                                            indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "cases"}
                     | {"cases": {c: r["mean"] for c, r in rows.items()}}))
    s.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where one search batch's wall time goes on the card, hop by hop.

    python3 benchmarks/hop_profile_torch.py [--src DIR] [--n 1000000]
        [--plan auto|graph] [--ef 64] [--batch 64]

Imports ``repro_torch`` from ``--src`` (default: this tree's ``src``), so
the same script reads a parent tree unpacked beside this one.  Builds
``chip_smoke.py``'s full-phase index (n × 128 from ``--seed``, the
``build_rnsg`` defaults, 1,000 queries of the mixed workload), then for the
f32 paths (bw 1, kernels) and (bw 4, kernels) at ``--plan`` (``auto``),
k=10, ``--ef`` (64), batches of ``--batch`` (64):

* every batch once untimed, then every batch again with a ``QueryTrace``:
  resolve / plan / dispatch / stitch wall per batch, and inside dispatch
  the wall of each ``beam_search_batch`` call (host clock, synchronised);
* batch ``--batch-index`` (all graph-routed at the default) three more
  times, traced: its beam wall and, from the fused beam's launch records
  on the ``dispatch`` span (the kernel's traced instantiation), its hops,
  one hop's time inside its block (Σ block time over Σ hops) and the hop
  loop's cycles by phase; a tree without the records prints none;
* the same batch once under ``torch.profiler`` (CPU + CUDA activities),
  traced: device time per kernel name, the beam kernels' device time
  beside the launches' span by the blocks' own stamps (max exit − min
  entry, ``%globaltimer``), the host time of the ``.any()`` syncs
  (``aten::_local_scalar_dense``, which waits for the queued device work)
  and of every other op;
* the host cost of one ``obs.annotate`` span with no profiler session
  (the substrate opens one per dispatched partition, and ``QueryTrace``
  one per span), before any profiler session of the process.

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
sys.path.insert(0, str(ROOT))
from rfann_bench import beamrec  # noqa: E402

PATHS = [("bw1_kernel", 1), ("bw4_kernel", 4)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-index", type=int, default=0)
    ap.add_argument("--plan", default="auto", choices=("auto", "graph"))
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
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
    from repro_torch.obs import QueryTrace, annotate
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
        with annotate("rnsg.scan_dispatch"):
            pass
    span_us = (time.perf_counter() - t1) / reps * 1e6
    print(f"[hop] annotate span, no session: {span_us:.3f} us")
    b = args.batch
    batches = [(lo, qv[lo:lo + b], ranges[lo:lo + b])
               for lo in range(0, args.nq, b)]
    bi = args.batch_index
    result = dict(card=card, n=args.n, nq=args.nq, src=args.src,
                  batch_index=bi, plan=args.plan, ef=args.ef, batch=b,
                  annotate_us=span_us, paths={})
    for name, bw in PATHS:
        kw = dict(k=10, ef=args.ef, plan=args.plan, beam_width=bw,
                  use_kernel=True)
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
            tr = QueryTrace()
            idx.search(q_b, r_b, trace=tr, **kw)
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            reps.append(dict(beam_ms=sum(beam_walls) * 1e3,
                             launches=launches, record=beam_records(tr)))
        beam_ms = float(np.median([r["beam_ms"] for r in reps]))
        rec = reps[0]["record"]
        print(f"[hop] {name} batch {bi}: beam wall {beam_ms:.3f} ms; "
              f"launches {reps[0]['launches']}")
        for i, r in enumerate(x["record"] for x in reps):
            print(f"[hop] {name} batch {bi} run {i}: "
                  + ("no beam record (a tree without the traced beam)"
                     if r is None else
                     f"{r['hops'] / max(r['queries'], 1):.1f} hops per "
                     f"query, {r['hop_us']:.4f} us per hop inside its block; "
                     "cycles " + " ".join(f"{p} {v:.4f}" for p, v
                                          in r["shares"].items())))
        beam_walls.clear()
        tr = QueryTrace()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            idx.search(q_b, r_b, trace=tr, **kw)
        prof_wall = sum(beam_walls) * 1e3
        prof_rec = beam_records(tr)
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
        beam_dev_ms = sum(v["device_ms"] for k, v in kern.items()
                          if "beam_kernel" in k)
        sync_ms = sum(r[2] for r in cpu
                      if r[0] == "aten::_local_scalar_dense")
        stamps_ms = None if prof_rec is None else prof_rec["span_ms"]
        prof = dict(beam_wall_ms=prof_wall, device_ms=device_ms,
                    beam_device_ms=beam_dev_ms, stamps_span_ms=stamps_ms,
                    sync_ms=sync_ms, other_host_ms=prof_wall - sync_ms,
                    kernels=kern,
                    top_cpu=[dict(op=r[0], count=r[1], total_ms=r[2],
                                  self_ms=r[3]) for r in cpu[:30]])
        print(f"[hop] {name} batch {bi} profiled: beam wall "
              f"{prof_wall:.3f} ms, device busy {device_ms:.3f} ms "
              f"(idle share {1 - device_ms / max(prof_wall, 1e-9):.3f}), "
              f"beam kernels {beam_dev_ms:.4f} ms of device time against "
              + ("no block stamps" if stamps_ms is None else
                 f"{stamps_ms:.4f} ms from the blocks' stamps (ratio "
                 f"{stamps_ms / max(beam_dev_ms, 1e-9):.4f})")
              + f", .any() syncs {sync_ms:.3f} ms, other host "
              f"{prof_wall - sync_ms:.3f} ms")
        for k, v in sorted(kern.items(),
                           key=lambda kv: -kv[1]["device_ms"])[:12]:
            print(f"[hop]   device {v['device_ms']:.4f} ms x{v['count']} "
                  f"{k[:90]}")
        for r in prof["top_cpu"][:12]:
            print(f"[hop]   host self {r['self_ms']:.3f} ms "
                  f"(total {r['total_ms']:.3f}) x{r['count']} {r['op']}")
        result["paths"][name] = dict(per_batch=per_batch, mean=agg,
                                     batch=reps, beam_ms=beam_ms,
                                     record=rec, profile=prof)
    sub.beam_search_batch = inner
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "hop_profile.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "paths"}
                     | {"paths": {p: dict(beam_ms=v["beam_ms"],
                                          record=v["record"], mean=v["mean"])
                                  for p, v in result["paths"].items()}}))
    return 0


def beam_records(tr):
    """The fused beam's launch records of one traced search, summed: the
    launches, queries and hops, one hop's µs inside its block and the hop
    loop's cycles by phase as shares of the loop's (``rfann_bench.beamrec``,
    as the benchmark's readers compute them), and the launches' span by the
    blocks' own stamps (Σ over launches of max exit − min entry, ms); None
    where no record carries stamps (the plain path, or a tree without the
    traced beam)."""
    recs = beamrec.records([tr], "t0_ns")
    if not recs:
        return None
    return dict(launches=len(recs),
                queries=sum(len(r["hops"]) for r in recs),
                hops=sum(int(np.sum(r["hops"])) for r in recs),
                hop_us=beamrec.hop_us([tr]),
                span_ms=sum(int(r["t1_ns"].max() - r["t0_ns"].min())
                            for r in recs) / 1e6,
                shares={p: beamrec.phase_share([tr], p)
                        for p in ("select", "expand", "score", "fold")})


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

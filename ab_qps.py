#!/usr/bin/env python3
"""Paired QPS of two source trees of the PyTorch/CUDA port on one card.

    python3 ab_qps.py --a OLD/src --b src            # 1M x 128, 5 rounds
    python3 ab_qps.py --a OLD/src --precision int8   # the int8 paths

Each tree gets a worker process that imports ``repro_torch`` from its
``src`` directory, builds the same index as ``chip_smoke.py``'s full phase
(n x 128 from ``--seed``, the ``build_rnsg`` defaults) and keeps it.  Then
the workers take turns, one at a time, in the order A B B A repeated
``--rounds`` times after one untimed warm-up pass each.  A pass is the
f32 part of ``chip_smoke.py``'s full phase: ``--nq`` queries in batches of
64 through ``RNSGIndex.search(plan="auto", k=10, ef=64)`` at (bw 1,
plain), (bw 1, kernels), (bw 4, plain), (bw 4, kernels), every path of a
batch planned from the same calibration state, the planner reset to its
post-build state at the start of each pass.  ``--precision int8|bf16``
installs that quantized copy after the build (untimed) and searches with
``precision=`` (the quantized scan or beam, then the f32 rerank); the
default, f32, is the f32 part of the full phase.

Prints each pass's QPS per path, then per path the median QPS of each tree
with its quartiles, the ratio B/A of the medians, the median and quartiles
of the per-pair ratios (pass i of A against pass i of B, which run side by
side), whether the two trees returned the same ids, and the scan
share; the last line is one JSON object with all of it (also written to
``chiprun_out/ab_qps.json``, or ``ab_qps-<precision>.json`` for a quantized
precision, with ``-<tag>`` before ``.json`` when ``--tag`` is given).  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PATHS = [("bw1_plain", 1, False), ("bw1_kernel", 1, True),
         ("bw4_plain", 4, False), ("bw4_kernel", 4, True)]
TAG = "@@ "                     # protocol lines on a worker's stdout


def _send(obj) -> None:
    print(TAG + json.dumps(obj), flush=True)


def worker(src: str, n: int, nq: int, seed: int, batch: int,
           device: str, precision: str) -> int:
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.core.rfann import RNSGIndex
    from repro_torch.data.ann import (ground_truth, make_attrs, make_vectors,
                                      mixed_workload, recall_at_k)
    from repro_torch.kernels import ops
    from repro_torch.planner import SCAN
    import repro_torch
    allv = make_vectors(n + nq, 128, seed=seed)
    base, qv = allv[:n], allv[n:]
    attrs = make_attrs(n, seed=seed)
    ranges, _ = mixed_workload(attrs, nq, seed=seed)
    idx = RNSGIndex.build(base, attrs, m=32, ef_spatial=32, ef_attribute=48,
                          device=device)
    gt, _ = ground_truth(base, attrs, qv, ranges, 10, device=device)
    if precision != "f32":
        idx.install_quantized(precision)
    planner = idx.planner
    built = json.dumps(planner.cost.state_dict())
    _send(dict(ready=True, package=str(Path(repro_torch.__file__).parent),
               build_seconds=idx.stats()["build_seconds"]))
    for line in sys.stdin:
        if line.strip() != "run":
            break
        planner.cost.load_state_dict(json.loads(built))
        secs = dict.fromkeys((p[0] for p in PATHS), 0.0)
        ids = {p[0]: [] for p in PATHS}
        scan = {p[0]: [] for p in PATHS}
        launches = {p[0]: {} for p in PATHS}
        for lo in range(0, nq, batch):
            q_b, r_b = qv[lo:lo + batch], ranges[lo:lo + batch]
            start = json.dumps(planner.cost.state_dict())
            follow = None
            for name, bw, uk in PATHS:
                planner.cost.load_state_dict(json.loads(start))
                ops.reset_launches()
                t1 = time.perf_counter()
                res = idx.search(q_b, r_b, k=10, ef=64, plan="auto",
                                 beam_width=bw, use_kernel=uk,
                                 precision=precision)
                secs[name] += time.perf_counter() - t1
                for kern, c in ops.LAUNCHES.items():
                    kern = kern.split(".")[0]     # summed over the dtypes
                    launches[name][kern] = launches[name].get(kern, 0) + c
                ids[name].append(res.ids)
                scan[name].append(res.stats["strategy"] == SCAN)
                if follow is None:
                    follow = json.dumps(planner.cost.state_dict())
            planner.cost.load_state_dict(json.loads(follow))
        out = {}
        for name, _, _ in PATHS:
            got = np.concatenate(ids[name])
            out[name] = dict(qps=nq / secs[name], seconds=secs[name],
                             recall=recall_at_k(got, gt),
                             scan_share=float(np.concatenate(scan[name])
                                              .mean()),
                             launches=launches[name],
                             ids=got.tolist())
        _send(out)
    return 0


class Worker:
    def __init__(self, label, src, args):
        self.label = label
        self.proc = subprocess.Popen(
            [sys.executable, __file__, "--worker", src, "--n", str(args.n),
             "--nq", str(args.nq), "--seed", str(args.seed),
             "--device", args.device, "--precision", args.precision],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def read(self):
        for line in self.proc.stdout:
            if line.startswith(TAG):
                return json.loads(line[len(TAG):])
            print(f"[{self.label}] {line.rstrip()}")
        raise RuntimeError(f"worker {self.label} exited with "
                           f"{self.proc.wait()}")

    def run(self):
        self.proc.stdin.write("run\n")
        self.proc.stdin.flush()
        return self.read()

    def close(self):
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="src directory of tree A (e.g. the parent)")
    ap.add_argument("--b", default=str(ROOT / "src"),
                    help="src directory of tree B (default: this tree)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="'cpu' rehearses the protocol at a small --n")
    ap.add_argument("--precision", default="f32",
                    choices=("f32", "int8", "bf16"),
                    help="the scoring precision of every path")
    ap.add_argument("--tag", default="",
                    help="suffix of the JSON file's name (several runs in "
                         "one command)")
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.n, args.nq, args.seed, 64,
                      args.device, args.precision)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ab_qps: no CUDA device is present", file=sys.stderr)
        return 1
    if not args.a:
        ap.error("--a is required")
    card = args.device if args.device != "cuda" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    workers = {"A": Worker("A", args.a, args),
               "B": Worker("B", args.b, args)}
    try:
        for w in workers.values():
            info = w.read()
            print(f"[{w.label}] ready: {info}")
        for w in workers.values():
            w.run()                                   # warm-up, not counted
        passes = {"A": [], "B": []}
        order = "ABBA" * args.rounds
        for i, lab in enumerate(order):
            res = workers[lab].run()
            passes[lab].append(res)
            print(f"[pass {i} {lab}] " + " ".join(
                f"{p}={res[p]['qps']:.1f}" for p, _, _ in PATHS))
    finally:
        for w in workers.values():
            w.close()
    summary = {}
    for p, _, _ in PATHS:
        qa = [r[p]["qps"] for r in passes["A"]]
        qb = [r[p]["qps"] for r in passes["B"]]
        same = float(np.mean([np.array_equal(np.asarray(ra[p]["ids"]),
                                             np.asarray(rb[p]["ids"]))
                              for ra, rb in zip(passes["A"], passes["B"])]))
        # pass i of A and pass i of B run next to each other (A B | B A)
        pair = np.asarray(qb) / np.asarray(qa)
        summary[p] = dict(
            qps_a=qa, qps_b=qb, median_a=float(np.median(qa)),
            median_b=float(np.median(qb)),
            quartiles_a=np.percentile(qa, [25, 75]).tolist(),
            quartiles_b=np.percentile(qb, [25, 75]).tolist(),
            ratio_b_over_a=float(np.median(qb) / np.median(qa)),
            pair_ratios=pair.tolist(),
            pair_ratio_quartiles=np.percentile(pair, [25, 50, 75]).tolist(),
            passes_with_equal_ids=same,
            recall_a=passes["A"][0][p]["recall"],
            recall_b=passes["B"][0][p]["recall"],
            scan_share_a=passes["A"][0][p]["scan_share"],
            scan_share_b=passes["B"][0][p]["scan_share"],
            launches_a=passes["A"][0][p]["launches"],
            launches_b=passes["B"][0][p]["launches"])
        s = summary[p]
        qa1, qa3 = s["quartiles_a"]
        qb1, qb3 = s["quartiles_b"]
        r1, r2, r3 = s["pair_ratio_quartiles"]
        print(f"[ab] {p}: A median {s['median_a']:.1f} "
              f"[{min(qa):.1f}, {max(qa):.1f}] (quartiles {qa1:.1f}, "
              f"{qa3:.1f})  B median {s['median_b']:.1f} "
              f"[{min(qb):.1f}, {max(qb):.1f}] (quartiles {qb1:.1f}, "
              f"{qb3:.1f})  B/A {s['ratio_b_over_a']:.3f}  paired B/A "
              f"median {r2:.3f} (quartiles {r1:.3f}, {r3:.3f}, "
              f"{int((pair > 1).sum())}/{len(pair)} pairs above 1)"
              f"  equal ids in {same * 100:.0f}% of paired passes  recall "
              f"{s['recall_a']:.4f}/{s['recall_b']:.4f}  scan share "
              f"{s['scan_share_a']:.3f}/{s['scan_share_b']:.3f}")
    result = dict(card=card, a=args.a, b=args.b, n=args.n, nq=args.nq,
                  precision=args.precision, order=order,
                  seconds=time.perf_counter() - t0, paths=summary)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = "-".join(["ab_qps"] + [x for x in (
        "" if args.precision == "f32" else args.precision, args.tag)
        if x]) + ".json"
    (out / name).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

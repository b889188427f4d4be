#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py            # the full run: n = 1,000,000, d = 128

Phases, each printing its lines:

1. device  — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build   — nvcc builds of every kernel source (``-Xptxas -v`` summary);
3. parity  — each hand-written kernel against its plain PyTorch version on
             the card, at the main path's shapes and at edge cases, with
             CUDA-event times, the byte/flop bound and the plain time: the
             f32 kernels, then the int8/bf16 corpora (quantized on the card
             and bit-equal to the CPU's quantization) through range_scan,
             gather_dist and gather_topk, and the f32 rerank gather_rerank
             (fed unsorted ids, duplicates included, k 1 .. 3000);
   then l2dist against its plain version at the reference test's shapes,
   the benchmark's and (1024, 262144, 128), in f32 and bf16, and at every
   shape the bench phase's segment-tree build gives it (f32; timed at its
   top-level tile, (4096, 100000, 128)), with its bound and
   ``torch.cdist`` (TF32 off) as the library yardstick;
4. exact   — n = 4096, d = 128: every strategy × beam width {1, 4} ×
             use_kernel × precision {f32, int8, bf16} returns the
             brute-force ids at ef >= n;
5. full    — a SIFT1M-shaped corpus (1M × 128, numpy from ``--seed``) built
             with the ``build_rnsg`` defaults, then ``install_quantized`` for
             int8 and bf16 (timed), then 1,000 queries of the paper's
             2^0..2^-9 selectivity mix in batches of 64 through
             ``RNSGIndex.search(plan="auto", k=10, ef=64)`` at (bw 1, plain),
             (bw 1, kernels), (bw 4, plain), (bw 4, kernels), for each
             precision; recall@10 per level, QPS, scan share; scan-routed
             queries must be exact (all of them at f32, >= 99% quantized)
             and each kernel path must equal its plain path on >= 99% of
             queries, and each f32 kernel path must equal its plain path's
             hops and ndist on >= 99% of graph-routed queries (each
             difference printed with its top-10 distances).  Launches are
             counted per path: zeroed just before each ``search`` call and
             read just after it; each kernel path must run its hop loop in
             its precision's fused beam (``beam_single`` at bw 1,
             ``beam_batched`` at bw 4), one launch per graph-routed
             partition, no path may launch a per-hop ``gather_dist`` or
             ``gather_topk``, and each quantized path must launch
             ``gather_rerank``.  Then the fused beams on the card against
             the lockstep loop on the same batch (64 graph-routed queries,
             ef=64, every precision, bw 1 and 4), timed with CUDA events
             beside their byte bound; then ``plan="graph"`` recall@10 and
             QPS per level at ef 64/256/1024 (bw 4, kernels, f32) on the
             same index;
6. serve   — ``repro_torch.launch.serve.main`` (the rfann mode) in
             process at n × 128 with the serve defaults (k=10, ef=64,
             --max-batch 64, plan="auto"), 4,096 requests, a 64 MB cache,
             a 4-shard index directory, calibration and metrics files: run
             1 builds and persists, run 2 restores (no rebuild) and serves
             at half of run 1's QPS, run 3 restores at int8, bw 4 with the
             same calibration file, run 4 as run 3 with a calibration file
             of its own.  Each run must launch its fused beam
             (gather_rerank at int8) and never the lockstep loop, runs 1, 2
             and 4 range_scan too, and each comes within 0.01 of
             ``RNSGIndex.search``'s recall@10 on the same index under the
             served routing; every core metric family in the metrics file;
7. stream  — the launcher's streaming mode at n × 128 (8,192 requests,
             --max-delta 4000, a WAL and a checkpoint): about 4,096 inserts
             and 1,024 deletes, at least one compaction on the card; then a
             server in a child process restores the directories, churns
             with the WAL and is SIGKILLed mid-churn, and the launcher
             restarts on them: it must replay the WAL tail onto the
             checkpoint to the acknowledged live set; then the delta scan
             (range_scan at bucket = the delta's capacity) against its
             plain version at capacities 128 .. 8192;
8. mesh    — multi-device serving and the sharded build, 8 shards of the
             full phase's corpus, all on the first card:
             ``RNSGIndex.build_sharded(n_shards=8)`` at n × 128 must be
             bit-equal to the full phase's ``build_rnsg`` graph; two
             ``DistributedRFANN(n_shards=8)`` (local, and on an 8-shard
             mesh) answer the full phase's 1,000 queries in batches of 64.
             First the local async and sequential paths as deployed (each
             shard's own int8 scale, each planner its own calibration):
             QPS, scan share and launches, each launching its fused beam
             (gather_rerank at int8) and never a gather kernel or the
             lockstep loop.  Then, with the local shards on the mesh's
             joint int8 copy and every planner on one calibration state,
             the local async, local sequential and mesh paths at
             plan auto / graph, bw 1 / 4, f32 / int8, plus a plain pass
             (f32, bw 1, auto, use_kernel off): async must equal
             sequential, mesh equal local (under auto on the queries both
             route alike on every shard they touch), the kernel path equal
             the plain pass, each on >= 99 % of queries up to near-ties;
             scan-routed queries exact; launches per path (each kernel path
             its fused beam, range_scan under auto, gather_rerank at int8,
             never a gather kernel or the lockstep loop); then the launcher
             with --build-shards 8 at 100,000 × 128, 1,024 requests: its
             graph equal to ``build_rnsg``'s, its recall within 0.01 of
             ``RNSGIndex.search`` under the served routing; and the mesh
             index's ``lower_for_dryrun`` (f32, int8): the per-shard graph
             body on fakes derived from the index's rows per shard,
             dimension, degree and precision, whose shapes and dtypes
             must be the index's shard-0 tensors';
9. witness — an n = 100,000 build and graph search on the card, written to
             ``chiprun_out/witness_n100000.npz``, and the bench's segment
             tree built and searched at n = 8,192 (its upper levels through
             segment_knn's sliced branch), written to
             ``chiprun_out/witness_segtree_n8192.npz``, for
             ``scale_witness.py``, which holds each against the JAX
             reference on the CPU;
10. bench  — the paper's benchmark path through ``benchmarks.run_torch``
             at n = 100,000 × d = 128 (cut from 1M; ``--bench-n``,
             ``--bench-nq``) with ``build_methods(quick=False)``: RNSG,
             MRNG in-filter and post-filter, segment tree and brute force
             built one by one (launches counted around each build: the
             segment tree's must launch l2dist, and its block KNN on the
             card must equal a plain computation at block sizes 2^12, 2^16
             and 2^17), then ``qps_recall`` (1,000
             queries, all four workloads, k=10, ef 16/32/64/128),
             ``construction_time``, ``index_size`` and the ``kernels``
             microbench; the ground truth must equal a float64
             difference-form top-k up to near-ties, brute force must return
             the ground truth on every query, and no baseline search may
             launch a gather kernel.
             Also prints NNDescent's recall against the exact KNN graph;
11. train  — the LM scaffold's training half (no hand kernel: plain torch
             ops under autograd, cuBLAS products): qwen1.5-4b at full
             width and depth (40 layers, bf16, f32 moments, remat full in
             super-groups of 2; seq 4096, batch 2: the global batch of
             train_4k cut from 256, for time) and mamba2-780m at full size
             (seq 4096, 4 micro-batches of 2), 3 steps each of
             ``build_train_step`` on the launcher's token stream and
             schedule: parameters and state bytes, init, each step's ms
             (CUDA events and the host clock), tok/s, peak memory and the
             step's bound, loss and gradient norm finite and > 0;
             mamba2-780m's state through an async ``CheckpointManager``
             save and a restore that must be bit-equal; qwen1.5-4b's f32
             copy cut to 2 layers at full width (numpy parameters from the
             seed): a central-difference gradient check along a seeded
             direction and the witness
             ``chiprun_out/witness_train_qwen1.5-4b.npz`` for
             ``lm_witness.py``; every arch's smoke config in f32, loss,
             gradients and one train step on the card against the CPU; the
             launcher's own cases (``launch.train.main``: the loss falls
             over 30 steps; a resume through a checkpoint replays the
             losses);
12. shard  — qwen1.5-4b's ZeRO-3 (FSDP-strategy) train step
             (``parallel.fsdp``) at full width and depth on a global batch
             of 8 × 1024 tokens from the launcher's token stream (the loss
             in slices of 256 positions), at S = 2 (data 2) and S = 8
             (data 4 × model 2) shards, all on the first card, each on a
             state drawn again, one warm-up step and one timed: step ms,
             peak memory and the counted per-device all-gather and
             reduce-scatter bytes beside their bounds; loss, gradient norm
             and post-step parameter slices within twice the unsharded
             step's own distance to its ``micro_batches=S`` step (a rate of
             1e-4); qwen1.5-4b's f32 copy cut to 2 layers, the S = 8 step
             against the unsharded step (loss 1e-5, gradients 1e-4 of
             max(1, |g|)); the dry-run's share of the S = 8 step on fakes
             (``launch.dryrun --mesh``, run on the host meanwhile), whose
             collective bytes and parameter bytes must equal the card's;
13. lm     — the LM scaffold's serving path (no hand kernel: plain torch
             ops and cuBLAS products): llama3-8b at full width and depth
             (bf16, parameters drawn on the card from ``--seed``) and
             mamba2-780m at full size, each a prefill of 64 x 32 tokens and
             16 greedy decode steps, with the parameter count and bytes,
             init, prefill and per-step decode times, tok/s and peak memory
             beside their bounds, and the first step's logits against the
             last position of a prefill of 33 tokens (relative L2 <= 0.1 in
             bf16); llama3-8b's f32 copy cut to 2 layers, the same check
             within 1e-3; the witness (llama3-8b cut to 2 layers at full
             width, numpy parameters from the seed) written to
             ``chiprun_out/witness_lm_llama3-8b.npz`` for ``lm_witness.py``;
             each of the ten archs' smoke configs on the card against the
             same port code on the CPU (f32 and bf16, prefill and 4 decode
             steps, logits and caches); the launcher's ``--mode lm`` in
             process;
14. device times — range_scan's, gather_rerank's and l2dist's timed parity
             shapes again, one batch of the mesh phase's mesh and
             local async paths, one decode step of the lm phase's
             llama3-8b and mamba2-780m, then (their models freed) one
             qwen1.5-4b and one mamba2-780m train step, each on a state
             drawn again (their idle shares; a train step's from its own
             wall), under torch.profiler: device time and device
             launches per call (last, because a profiler session slows the
             host-side torch ops of every later phase);
15. the ``{"kernels": [...]}`` line (each kernel's launches per mesh
    path under ``mesh_launches``);
16. the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no ``ok``
line.  Details (all buckets, per-level recall) go to
``chiprun_out/chip_smoke.json``.  Needs one CUDA card; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the H100 SXM's rates (HBM3 bytes/s, f32 outside and bf16 dense on the
# tensor cores, FLOP/s), kept once in the port
from repro_torch.launch.hlo_analysis import (BF16_FLOPS, F32_FLOPS,  # noqa: E402
                                             HBM_BYTES_PER_S)


def _bound(nbytes: float, flops: float, peak_flops: float = F32_FLOPS):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def _time_ms(fn, reps: int) -> float:
    """Median of per-call CUDA-event times after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


#: (record, call, calls, label) whose device time is read under
#: torch.profiler after every timed phase: a profiler session leaves CUPTI
#: hooks behind that slow every later host-side torch op of the process,
#: so readings taken between phases would slow the timings that follow
_DEVICE_PROBES: list = []


def _device_probe(rec: dict, fn, label: str, calls: int = 10) -> None:
    """Queue a device-time reading of fn into rec (``device_ms``,
    ``launches_per_call``); fn must bind its operands now (no late-bound
    loop variables)."""
    _DEVICE_PROBES.append((rec, fn, calls, label))


def phase_device_times():
    """The queued device-time readings, after every timed phase; each
    probe's call (and what it holds on the card) is dropped once read."""
    import torch
    while _DEVICE_PROBES:
        rec, fn, calls, label = _DEVICE_PROBES.pop(0)
        rec["device_ms"], rec["launches_per_call"], _ = _device_ms(fn, calls)
        print(f"[device] {label}: device_ms={rec['device_ms']:.4f} "
              f"({rec['launches_per_call']:g} launches per call)")
        del fn
    torch.cuda.empty_cache()


def _device_ms(fn, calls: int = 10):
    """(device ms per call, device launches per call, {kernel: device ms
    per call}) of fn under torch.profiler: each kernel's mean time per
    launch, times its launches per call (at least one; the profiler may
    drop events, never add them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        # launches right after the session starts may all go unrecorded
        time.sleep(0.02)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels, launches = {}, 0
    for e in p.key_averages():
        # the substrates' rnsg.* spans come back as device-side annotations
        # covering the kernels they enclose: not kernels
        if (e.device_type == DeviceType.CUDA and e.count
                and not e.key.startswith("rnsg.")):
            per_call = max(1, round(e.count / calls))
            kernels[e.key] = (e.self_device_time_total / 1e3 / e.count
                              * per_call)
            launches += per_call
    return sum(kernels.values()), launches, kernels


def _compare(name, got, want, atol):
    """Kernel output against the plain version's: dists allclose position
    by position (rtol 1e-4, atol = 1e-4·max(1, max‖x‖²)), and ids equal
    except at near-ties — a position whose two distances agree within that
    tolerance may hold either of two near-equal neighbours, because the
    kernel sums in another order than torch.  Returns the max abs dist
    error; prints the near-tie positions."""
    gi, gd = (t.cpu().numpy() for t in got)
    wi, wd = (t.cpu().numpy() for t in want)
    fin = np.isfinite(wd)
    if not np.array_equal(np.isfinite(gd), fin):
        raise AssertionError(f"{name}: +inf pads differ")
    err = float(np.max(np.abs(gd[fin] - wd[fin]))) if fin.any() else 0.0
    if not np.allclose(gd[fin], wd[fin], rtol=1e-4, atol=atol):
        raise AssertionError(f"{name}: dists differ, max abs err {err}")
    diff = gi != wi
    tie = np.isclose(gd, wd, rtol=1e-4, atol=atol) & fin
    if (diff & ~tie).any():
        rows = np.flatnonzero((diff & ~tie).any(1))
        raise AssertionError(f"{name}: ids differ on rows {rows[:10].tolist()}")
    if diff.any():
        print(f"[parity] {name}: {int(diff.sum())} near-tie positions on rows "
              f"{np.flatnonzero(diff.any(1))[:10].tolist()}")
    return err


def _covered(starts, lens, n_valid) -> np.ndarray:
    """Rows some query's window needs (the union, each read once)."""
    cov = np.zeros(n_valid + 1, np.int64)
    for s, ln in zip(starts, lens):
        e = min(s + ln, n_valid)
        if e > s:
            cov[s] += 1
            cov[e] -= 1
    return np.cumsum(cov[:-1]) > 0


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"name {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    dt = time.perf_counter() - t0
    print(f"[build] {len(logs)} libraries in {dt:.2f} s "
          f"({' '.join(_build.NVCC_FLAGS)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                print(f"[ptxas {name}] {line.strip()}")
    return dt


def phase_parity(x_pad, vecs, n, seed):
    """Each kernel against its plain version; returns per-kernel records."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = x_pad.device
    rng = np.random.default_rng(seed + 101)
    d_pad = x_pad.shape[1]
    xn2 = float((x_pad * x_pad).sum(1).max())
    atol = 1e-4 * max(1.0, xn2)
    nq = 64
    qv = torch.as_tensor(rng.standard_normal((nq, d_pad)).astype(np.float32)
                         * 4.0, device=dev)
    qv[:, vecs.shape[1]:] = 0
    rs = []
    for b in [1 << i for i in range(6, 18)]:                 # 64 .. 131072
        starts = rng.integers(0, max(n - b // 2, 1), nq)
        lens = rng.integers(b // 2, b + 1, nq)
        lens[0] = 0                                           # empty window
        starts[1], lens[1] = n - 1, 1                         # tail row
        starts[2] = 128 * 7 + 37                              # unaligned
        # int32, as the search path passes them (no conversion launch)
        st = torch.as_tensor(starts.astype(np.int32), device=dev)
        ln = torch.as_tensor(lens.astype(np.int32), device=dev)
        run_k = functools.partial(ops.range_scan, x_pad, st, ln, qv,
                                  bucket=b, k=10, n_valid=n)
        run_p = functools.partial(ref.range_scan_ref, x_pad, st, ln, qv,
                                  bucket=b, k=10, n_valid=n)
        err = _compare(f"range_scan b={b}", run_k(), run_p(), atol)
        rows = int(_covered(starts, lens, n).sum())
        nbytes = rows * d_pad * 4 + qv.numel() * 4 + nq * 8 + nq * 10 * 8
        scored = np.clip(np.minimum(starts + lens, n) - starts, 0, None)
        flops = float(scored.sum()) * 4 * d_pad
        bound, by = _bound(nbytes, flops)
        ms = _time_ms(run_k, 20)
        pms = _time_ms(run_p, 3 if b >= 16384 else 10)
        rs.append(dict(bucket=b, q=nq, k=10, ms=ms, plain_ms=pms,
                       bound_ms=bound, bound_by=by, max_abs_err=err,
                       rows=rows))
        _device_probe(rs[-1], run_k, f"range_scan f32 bucket={b} k=10")
        print(f"[parity] range_scan q={nq} d_pad={d_pad} bucket={b} k=10 "
              f"ok err={err:.3g} ms={ms:.4f} plain_ms={pms:.4f} "
              f"bound_ms={bound:.4f} ({by})")
    # edge cases: n_valid tail, live mask, k = 128, k > 128
    starts = rng.integers(0, n, nq)
    starts[:8] = n - rng.integers(1, 4000, 8)
    st = torch.as_tensor(starts, device=dev)
    ln = torch.as_tensor(rng.integers(0, 4097, nq), device=dev)
    live = torch.as_tensor(rng.random((1, x_pad.shape[0])) < 0.7,
                           device=dev).int()
    for kw in (dict(k=10, n_valid=n - 2000), dict(k=10, live=live),
               dict(k=1), dict(k=128), dict(k=256, live=live),
               dict(k=257), dict(k=300, live=live), dict(k=4096),
               dict(k=5000, live=live)):
        _compare(f"range_scan edge {kw.get('k')} {sorted(kw)}",
                 ops.range_scan(x_pad, st, ln, qv, bucket=4096, **kw),
                 ref.range_scan_ref(x_pad, st, ln, qv, bucket=4096, **kw),
                 atol)
    # k past the shared-memory merge over a window of many chunks
    ln = torch.as_tensor(rng.integers(0, 65537, nq), device=dev)
    _compare("range_scan edge k=4096 bucket=65536",
             ops.range_scan(x_pad, st, ln, qv, bucket=65536, k=4096),
             ref.range_scan_ref(x_pad, st, ln, qv, bucket=65536, k=4096),
             atol)
    # the select path's largest k over a window of many chunks
    _compare("range_scan edge k=256 bucket=65536",
             ops.range_scan(x_pad, st, ln, qv, bucket=65536, k=256,
                            live=live),
             ref.range_scan_ref(x_pad, st, ln, qv, bucket=65536, k=256,
                                live=live),
             atol)
    print("[parity] range_scan edges ok (n_valid tail, live, k=1, k=128, "
          "k=256, k=257, k=300, k=4096, k=5000 > window, k=4096 and k=256 "
          "at bucket 65536)")

    q = qv[:, :vecs.shape[1]].contiguous()
    d = vecs.shape[1]
    # int32 ids, as the beam passes them
    ids = torch.as_tensor(rng.integers(0, n, (nq, 32)), device=dev).int()
    run_k = lambda: ops.gather_dist(vecs, ids, q)
    run_p = lambda: ref.gather_dist_ref(vecs, ids, q)
    gd_err = float((run_k() - run_p()).abs().max())
    if not torch.allclose(run_k(), run_p(), rtol=1e-4, atol=atol):
        raise AssertionError(f"gather_dist: max abs err {gd_err}")
    rows = len(np.unique(ids.cpu().numpy()))
    gd = dict(q=nq, m=32, ms=_time_ms(run_k, 50), plain_ms=_time_ms(run_p, 20),
              max_abs_err=gd_err)
    gd["bound_ms"], gd["bound_by"] = _bound(
        rows * d * 4 + nq * 32 * 4 + q.numel() * 4, nq * 32 * d * 3)
    print(f"[parity] gather_dist q={nq} m=32 d={d} ok err={gd_err:.3g} "
          f"ms={gd['ms']:.4f} plain_ms={gd['plain_ms']:.4f} "
          f"bound_ms={gd['bound_ms']:.5f} ({gd['bound_by']})")
    oob = torch.as_tensor(rng.integers(-5, n + 5, (nq, 32)), device=dev)
    if not torch.allclose(ops.gather_dist(vecs, oob, q),
                          ref.gather_dist_ref(vecs, oob, q),
                          rtol=1e-4, atol=atol):
        raise AssertionError("gather_dist: out-of-range ids differ")

    ids = torch.as_tensor(rng.integers(0, n, (nq, 128)), device=dev).int()
    ids = torch.where(torch.as_tensor(rng.random((nq, 128)) < 0.3,
                                      device=dev), -1, ids)
    ids[0] = -1                                         # all-masked row
    run_k = lambda: ops.gather_topk(vecs, ids, q, k=64)
    run_p = lambda: ref.gather_topk_ref(vecs, ids, q, k=64)
    gt_err = _compare("gather_topk", run_k(), run_p(), atol)
    valid = ids.cpu().numpy()
    rows = len(np.unique(valid[valid >= 0]))
    gk = dict(q=nq, m=128, k=64, ms=_time_ms(run_k, 50),
              plain_ms=_time_ms(run_p, 20), max_abs_err=gt_err)
    gk["bound_ms"], gk["bound_by"] = _bound(
        rows * d * 4 + nq * 128 * 4 + q.numel() * 4 + nq * 64 * 8,
        int((valid >= 0).sum()) * d * 3)
    print(f"[parity] gather_topk q={nq} m=128 k=64 d={d} ok "
          f"err={gt_err:.3g} ms={gk['ms']:.4f} "
          f"plain_ms={gk['plain_ms']:.4f} bound_ms={gk['bound_ms']:.5f} "
          f"({gk['bound_by']})")
    for m, k in ((5, 8), (200, 128), (32, 1)):
        e = torch.as_tensor(rng.integers(-2, n, (nq, m)), device=dev)
        _compare(f"gather_topk m={m} k={k}", ops.gather_topk(vecs, e, q, k=k),
                 ref.gather_topk_ref(vecs, e, q, k=k), atol)
    try:
        ops.gather_topk(vecs, ids, q, k=200)
        raise AssertionError("gather_topk: k=200 was accepted")
    except ValueError:
        pass
    print("[parity] gather edges ok (out-of-range ids, all-masked row, "
          "M<k, k=128, k=1, oversized k raises)")
    return rs, gd, gk


def _quantized_slots(vecs, x_pad):
    """The int8 and bf16 copies of the corpus, quantized on the card and
    held bit for bit against the CPU's quantization of the same array:
    {precision: (data (n,d), data_pad (n_pad,d_pad), scale_pad or None)}."""
    import torch
    from repro_torch.kernels.quantize import quantize_corpus
    cpu = vecs.cpu()
    out = {}
    for p in ("int8", "bf16"):
        qc = quantize_corpus(vecs, p)
        ref = quantize_corpus(cpu, p)
        raw = torch.uint8 if p == "int8" else torch.int16
        if not torch.equal(qc.data.cpu().view(raw), ref.data.view(raw)):
            raise AssertionError(f"quantize_corpus {p}: card data differs "
                                 f"from the CPU's")
        if p == "int8" and not torch.equal(qc.scale.cpu().view(torch.int32),
                                           ref.scale.view(torch.int32)):
            raise AssertionError("quantize_corpus int8: card scale differs "
                                 "from the CPU's")
        data_pad = torch.nn.functional.pad(
            qc.data, (0, 0, 0, x_pad.shape[0] - qc.data.shape[0]))
        out[p] = (qc.data, data_pad, qc.scale)
    print(f"[parity] quantize_corpus on the card equals the CPU bit for bit "
          f"(int8 data and scale, bf16 bits; n={vecs.shape[0]})")
    return out


def phase_parity_quant(x_pad, vecs, n, seed):
    """The int8/bf16 corpora through range_scan, gather_dist and gather_topk,
    and the f32 rerank gather_rerank, each against its plain version;
    returns {kernel: {dtype: record}} and the rerank records."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = x_pad.device
    rng = np.random.default_rng(seed + 202)
    d_pad, d = x_pad.shape[1], vecs.shape[1]
    xn2 = float((x_pad * x_pad).sum(1).max())
    atol = 1e-4 * max(1.0, xn2)
    nq = 64
    qv = torch.as_tensor(rng.standard_normal((nq, d_pad)).astype(np.float32)
                         * 4.0, device=dev)
    qv[:, d:] = 0
    q = qv[:, :d].contiguous()
    slots = _quantized_slots(vecs, x_pad)
    recs = {"range_scan": {}, "gather_dist": {}, "gather_topk": {}}
    for p, (data, data_pad, scale) in slots.items():
        item = data.element_size()
        sbytes = 0 if scale is None else d_pad * 4
        sflop = 0 if scale is None else 1          # the dequant multiply
        rs = []
        for b in (512, 8192, 65536):
            starts = rng.integers(0, max(n - b // 2, 1), nq)
            lens = rng.integers(b // 2, b + 1, nq)
            lens[0] = 0
            starts[1], lens[1] = n - 1, 1
            starts[2] = 128 * 7 + 37
            st = torch.as_tensor(starts.astype(np.int32), device=dev)
            ln = torch.as_tensor(lens.astype(np.int32), device=dev)
            rows = int(_covered(starts, lens, n).sum())
            scored = np.clip(np.minimum(starts + lens, n) - starts, 0, None)
            for k in (10, 128):
                kw = dict(bucket=b, k=k, n_valid=n, scale=scale)
                run_k = functools.partial(ops.range_scan, data_pad, st, ln,
                                          qv, **kw)
                run_p = functools.partial(ref.range_scan_ref, data_pad, st,
                                          ln, qv, **kw)
                err = _compare(f"range_scan {p} b={b} k={k}", run_k(),
                               run_p(), atol)
                bound, by = _bound(
                    rows * d_pad * item + sbytes + qv.numel() * 4 + nq * 8
                    + nq * k * 8,
                    float(scored.sum()) * (4 + sflop) * d_pad)
                ms = _time_ms(run_k, 20)
                pms = _time_ms(run_p, 3 if b >= 16384 else 10)
                rs.append(dict(bucket=b, q=nq, k=k, ms=ms, plain_ms=pms,
                               bound_ms=bound, bound_by=by, max_abs_err=err,
                               rows=rows))
                _device_probe(rs[-1], run_k,
                              f"range_scan {p} bucket={b} k={k}")
                print(f"[parity] range_scan {p} q={nq} d_pad={d_pad} "
                      f"bucket={b} k={k} ok err={err:.3g} ms={ms:.4f} "
                      f"plain_ms={pms:.4f} bound_ms={bound:.4f} ({by})")
        live = torch.as_tensor(rng.random((1, x_pad.shape[0])) < 0.7,
                               device=dev).int()
        starts = rng.integers(0, n, nq)
        starts[:8] = n - rng.integers(1, 4000, 8)
        st = torch.as_tensor(starts, device=dev)
        ln = torch.as_tensor(rng.integers(0, 4097, nq), device=dev)
        for kw in (dict(k=128, live=live), dict(k=10, n_valid=n - 2000),
                   dict(k=256, live=live), dict(k=300, live=live)):
            _compare(f"range_scan {p} edge {sorted(kw)} k={kw['k']}",
                     ops.range_scan(data_pad, st, ln, qv, bucket=4096,
                                    scale=scale, **kw),
                     ref.range_scan_ref(data_pad, st, ln, qv, bucket=4096,
                                        scale=scale, **kw), atol)
        recs["range_scan"][p] = rs

        ids = torch.as_tensor(rng.integers(0, n, (nq, 32)), device=dev).int()
        run_k = lambda: ops.gather_dist(data, ids, q, scale)
        run_p = lambda: ref.gather_dist_ref(data, ids, q, scale)
        err = float((run_k() - run_p()).abs().max())
        if not torch.allclose(run_k(), run_p(), rtol=1e-4, atol=atol):
            raise AssertionError(f"gather_dist {p}: max abs err {err}")
        oob = torch.as_tensor(rng.integers(-5, n + 5, (nq, 32)), device=dev)
        if not torch.allclose(ops.gather_dist(data, oob, q, scale),
                              ref.gather_dist_ref(data, oob, q, scale),
                              rtol=1e-4, atol=atol):
            raise AssertionError(f"gather_dist {p}: out-of-range ids differ")
        rows = len(np.unique(ids.cpu().numpy()))
        gd = dict(q=nq, m=32, ms=_time_ms(run_k, 50),
                  plain_ms=_time_ms(run_p, 20), max_abs_err=err)
        gd["bound_ms"], gd["bound_by"] = _bound(
            rows * d * item + sbytes + nq * 32 * 4 + q.numel() * 4
            + nq * 32 * 4, nq * 32 * d * (3 + sflop))
        recs["gather_dist"][p] = gd
        print(f"[parity] gather_dist {p} q={nq} m=32 d={d} ok err={err:.3g} "
              f"ms={gd['ms']:.4f} plain_ms={gd['plain_ms']:.4f} "
              f"bound_ms={gd['bound_ms']:.5f} ({gd['bound_by']})")

        ids = torch.as_tensor(rng.integers(0, n, (nq, 128)), device=dev).int()
        ids = torch.where(torch.as_tensor(rng.random((nq, 128)) < 0.3,
                                          device=dev), -1, ids)
        ids[0] = -1
        run_k = lambda: ops.gather_topk(data, ids, q, k=64, scale=scale)
        run_p = lambda: ref.gather_topk_ref(data, ids, q, k=64, scale=scale)
        err = _compare(f"gather_topk {p}", run_k(), run_p(), atol)
        valid = ids.cpu().numpy()
        rows = len(np.unique(valid[valid >= 0]))
        gk = dict(q=nq, m=128, k=64, ms=_time_ms(run_k, 50),
                  plain_ms=_time_ms(run_p, 20), max_abs_err=err)
        gk["bound_ms"], gk["bound_by"] = _bound(
            rows * d * item + sbytes + nq * 128 * 4 + q.numel() * 4
            + nq * 64 * 8, int((valid >= 0).sum()) * d * (3 + sflop))
        recs["gather_topk"][p] = gk
        for m, k in ((5, 8), (200, 128), (32, 1)):
            e = torch.as_tensor(rng.integers(-2, n, (nq, m)), device=dev)
            _compare(f"gather_topk {p} m={m} k={k}",
                     ops.gather_topk(data, e, q, k=k, scale=scale),
                     ref.gather_topk_ref(data, e, q, k=k, scale=scale), atol)
        print(f"[parity] gather_topk {p} q={nq} m=128 k=64 d={d} ok "
              f"err={err:.3g} ms={gk['ms']:.4f} "
              f"plain_ms={gk['plain_ms']:.4f} "
              f"bound_ms={gk['bound_ms']:.5f} ({gk['bound_by']}); edges ok "
              f"(out-of-range ids, all-masked row, M<k, k=128, k=1)")
    del slots

    rr = []
    for m, k, timed in ((128, 10, True), (64, 10, True), (4096, 10, True),
                        (4096, 200, True), (5, 8, False), (1, 1, False),
                        (128, 1, False), (512, 256, False),
                        (300, 257, False), (30000, 10, False),
                        (30000, 128, False), (9000, 3000, False)):
        # unsorted, as the search path hands them over, with duplicates
        # and one id >= n (scored as row n - 1, keeping its own id)
        ids = rng.integers(0, n, (nq, m))
        ids[rng.random((nq, m)) < 0.1] = -1
        ids[0] = -1                                     # all-masked row
        ids[1, : m // 2] = ids[1, m // 2: 2 * (m // 2)]  # duplicate ids
        ids[2, 0] = n + 3
        ids = torch.as_tensor(ids.astype(np.int32), device=dev)
        run_k = functools.partial(ops.gather_rerank, vecs, ids, q, k=k)
        run_p = functools.partial(ref.gather_rerank_ref, vecs, ids, q, k=k)
        err = _compare(f"gather_rerank m={m} k={k}", run_k(), run_p(), atol)
        if not timed:
            continue
        valid = ids.cpu().numpy()
        rows = len(np.unique(np.minimum(valid[valid >= 0], n - 1)))
        rec = dict(q=nq, m=m, k=k, ms=_time_ms(run_k, 50),
                   plain_ms=_time_ms(run_p, 20), max_abs_err=err)
        rec["bound_ms"], rec["bound_by"] = _bound(
            rows * d * 4 + nq * m * 4 + q.numel() * 4 + nq * k * 8,
            int((valid >= 0).sum()) * d * 3)
        rr.append(rec)
        _device_probe(rec, run_k, f"gather_rerank q={nq} m={m} k={k}")
        print(f"[parity] gather_rerank q={nq} m={m} k={k} d={d} ok "
              f"err={err:.3g} ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']})")
    print("[parity] gather_rerank edges ok (unsorted ids with duplicates and "
          "an id >= n, all-masked row, M<k, k=1/256/257, M=30000 over many "
          "blocks, k=3000 merged in global memory)")
    return recs, rr


#: l2dist parity shapes (Q, N, d): the reference test's, one query row at
#: d = 515 (past one 512-wide chunk of the TPU kernel), the benchmark's,
#: and a 1024-row tile against a 262,144-row block; each in f32 and bf16
L2_SHAPES = [(1, 1, 1), (4, 7, 3), (128, 128, 128), (128, 256, 64),
             (100, 300, 130), (257, 129, 515), (33, 1000, 96), (1, 1, 515),
             (128, 1024, 128), (256, 4096, 128), (1024, 262144, 128)]
L2_TIMED = {(128, 1024, 128), (256, 4096, 128), (1024, 262144, 128)}


def segtree_l2_shapes(n: int, d: int = 128):
    """Every (Q, N, d) that the segment tree's block KNN
    (``index.baselines.segment_knn``) hands ``l2dist`` at n rows, in f32:
    up to KNN_TILE-row blocks one tile against itself, larger blocks each
    tile of rows against its whole block.  The first is the top level's
    full tile, the shape that takes the longest."""
    from repro_torch.index.baselines import KNN_TILE
    shapes = set()
    for s in range(1, max(1, int(np.ceil(np.log2(max(n, 2))))) + 1):
        size = 1 << s
        if size <= KNN_TILE:
            shapes.update((min(KNN_TILE, n - lo),) * 2
                          for lo in range(0, n, KNN_TILE))
            continue
        for start in range(0, n, size):
            end = min(start + size, n)
            shapes.update((min(KNN_TILE, end - lo), end - start)
                          for lo in range(start, end, KNN_TILE)
                          if end - start > 1)
    top = (min(KNN_TILE, n), n)
    return [(*top, d)] + sorted((q, m, d) for q, m in shapes - {top})


def phase_l2dist(seed, bench_n):
    """l2dist against its plain version at the reference test's tolerance
    (max abs error below 1e-3·max(1, d/64) in f32, 0.15·max(1, d/64) in
    bf16; every value >= 0): L2_SHAPES in f32 and bf16, and every shape
    the bench phase's segment-tree build gives it (``bench_n`` rows, f32).
    Timed at the build's top-level tile, the benchmark's shapes and the
    1024 × 262,144 tile beside its bound, the plain version and, in f32,
    ``torch.cdist``'s matmul path with TF32 off."""
    import torch
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 303)
    build = segtree_l2_shapes(bench_n)
    cases = [(s, dt) for s in L2_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(s, torch.float32) for s in build]
    timed = L2_TIMED | {build[0]}
    recs = []
    for (q, n, d), dt in cases:
        a = torch.as_tensor(rng.standard_normal((q, d)),
                            device="cuda").to(dt)
        b = torch.as_tensor(rng.standard_normal((n, d)),
                            device="cuda").to(dt)
        got = ops.l2dist(a, b)
        err = float((got - ref.l2dist_ref(a, b)).abs().max())
        tol = (1e-3 if dt == torch.float32 else 0.15) * max(1.0, d / 64)
        if not err < tol or not bool((got >= 0).all()):
            raise AssertionError(f"l2dist {q}x{n}x{d} {dt}: max abs err "
                                 f"{err} (tol {tol}) or a negative value")
        del got
        rec = dict(shape=f"{q}x{n}x{d}", dtype=ops.DTYPE_NAMES[dt],
                   max_abs_err=err, tol=tol,
                   segtree_build=(q, n, d) in build)
        if (q, n, d) in timed:
            reps = 10 if q * n > 1 << 24 else 50
            rec["ms"] = _time_ms(lambda: ops.l2dist(a, b), reps)
            _device_probe(rec, functools.partial(ops.l2dist, a, b),
                          f"l2dist {q}x{n}x{d} {rec['dtype']}", 5)
            rec["plain_ms"] = _time_ms(lambda: ref.l2dist_ref(a, b), reps)
            rec["library_ms"] = (_time_ms(lambda: torch.cdist(
                a, b, compute_mode="use_mm_for_euclid_dist"), reps)
                if dt == torch.float32 else None)
            rec["bound_ms"], rec["bound_by"] = _bound(
                (q * d + n * d) * a.element_size() + q * n * 4,
                2.0 * q * n * d)
            torch.cuda.empty_cache()
        recs.append(rec)
        print(f"[l2dist] {rec['shape']} {rec['dtype']} ok err={err:.3g} "
              f"(tol {tol:.3g})" + (
                  f" ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                  f"library_ms={rec['library_ms']} bound_ms="
                  f"{rec['bound_ms']:.4f} ({rec['bound_by']})"
                  if "ms" in rec else ""))
    return recs


def _same_sets(ids, gt, d_gt, d_got):
    """Rows whose id sets differ from the ground truth other than by a
    near-tie at the k-th distance (rel 1e-5)."""
    bad = []
    for r in range(len(gt)):
        a = set(gt[r][gt[r] >= 0].tolist())
        b = set(ids[r][ids[r] >= 0].tolist())
        if a == b:
            continue
        fin = d_gt[r][np.isfinite(d_gt[r])]
        kth = float(fin.max()) if len(fin) else 0.0
        extra = [d_got[r][j] for j, i in enumerate(ids[r]) if i not in a]
        if len(a) != len(b) or any(x > kth * (1 + 1e-5) for x in extra):
            bad.append(r)
    return bad


def phase_exact(seed):
    import torch
    from repro_torch.core.rfann import RNSGIndex
    from repro_torch.data.ann import (ground_truth, make_attrs, make_vectors,
                                      mixed_workload)
    n, d, nq = 4096, 128, 32
    t0 = time.perf_counter()
    v = make_vectors(n + nq, d, seed=seed + 1)
    base, qv = v[:n], v[n:]
    a = make_attrs(n, seed=seed + 1)
    rg, _ = mixed_workload(a, nq - 3, seed=seed + 1)
    s = np.sort(a)
    rg = np.concatenate([rg, np.asarray([[s[5] + 1e-7, s[5] + 2e-7],
                                         [s[17], s[17]], [s[0], s[-1]]],
                                        np.float32)])
    idx = RNSGIndex.build(base, a)
    gt, gd = ground_truth(base, a, qv, rg, 10)
    for prec in ("int8", "bf16"):
        idx.install_quantized(prec)
    for prec in ("f32", "int8", "bf16"):
        t1 = time.perf_counter()
        runs = 0
        for plan in ("graph", "auto", "scan", "beam"):
            for bw in (1, 4):
                for uk in (False, True):
                    res = idx.search(qv, rg, k=10, ef=n, plan=plan,
                                     beam_width=bw, use_kernel=uk,
                                     precision=prec)
                    bad = _same_sets(res.ids, gt, gd, res.dists)
                    if bad:
                        raise AssertionError(
                            f"exact regime {prec} {plan} bw={bw} "
                            f"use_kernel={uk}: rows {bad}")
                    runs += 1
        torch.cuda.synchronize()
        print(f"[exact] {prec} n={n} d={d} q={nq} ef={n}: {runs} runs "
              f"(graph/auto/scan/beam x bw 1,4 x use_kernel) equal brute "
              f"force ({time.perf_counter() - t1:.1f} s)")
    print(f"[exact] done in {time.perf_counter() - t0:.1f} s")


PATHS = [("bw1_plain", 1, False), ("bw1_kernel", 1, True),
         ("bw4_plain", 4, False), ("bw4_kernel", 4, True)]
PRECISIONS = ("f32", "int8", "bf16")


def _path_name(prec, path):
    """f32 paths keep their plain names; quantized ones are prefixed."""
    return path if prec == "f32" else f"{prec}_{path}"


def _check_launches(launches, dispatches):
    """Per-path launch counts: every path's scan partitions go through its
    precision's range_scan variant; each kernel path runs the hop loop of
    each graph-routed partition in one launch of its precision's fused beam
    (beam_single at bw 1, beam_batched at bw 4), each plain path in none;
    no path launches a per-hop gather kernel; every quantized path launches
    gather_rerank, no f32 path does."""
    beams = ("beam_single", "beam_batched")
    gathers = ("gather_dist", "gather_topk")
    for prec in PRECISIONS:
        for path, bw, uk in PATHS:
            name = _path_name(prec, path)
            got = launches[name]
            beam = f"{beams[bw > 1]}.{prec}"
            need = [f"range_scan.{prec}"] + ([beam] if uk else [])
            if prec != "f32":
                need.append("gather_rerank")
            zero = [f"{g}.{p}" for g in gathers + beams + ("range_scan",)
                    for p in PRECISIONS if f"{g}.{p}" not in need] + \
                (["gather_rerank"] if prec == "f32" else [])
            if not all(got[k] > 0 for k in need) or any(got[k] for k in zero):
                raise AssertionError(f"{name}: launches {got} need {need} "
                                     f"and none of {zero}")
            if uk and got[beam] != dispatches[name]:
                raise AssertionError(
                    f"{name}: {got[beam]} {beam} launches for "
                    f"{dispatches[name]} graph-routed partitions")


def phase_full(n, nq, batch, seed, ops):
    import torch
    from repro_torch.core.rfann import RNSGIndex
    from repro_torch.data.ann import (ground_truth, make_attrs, make_vectors,
                                      mixed_workload, recall_at_k)
    from repro_torch.planner import SCAN
    import repro_torch.search.substrate as sub
    d = 128
    t0 = time.perf_counter()
    allv = make_vectors(n + nq, d, seed=seed)
    base, qv = allv[:n], allv[n:]
    attrs = make_attrs(n, seed=seed)
    ranges, level = mixed_workload(attrs, nq, seed=seed)
    print(f"[full] data n={n} d={d} nq={nq} made in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # earlier phases' device probes
    ops.reset_launches()
    idx = RNSGIndex.build(base, attrs, m=32, ef_spatial=32, ef_attribute=48)
    st = idx.stats()
    print(f"[full] build {st['build_seconds']:.2f} s edges={st['edges']} "
          f"mean_degree={st['mean_degree']:.3f} max_degree={st['max_degree']} "
          f"index_mb={st['index_mb']:.1f} peak_gb="
          f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} "
          f"launches={dict(ops.LAUNCHES)}")
    install = {}
    for prec in PRECISIONS[1:]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        idx.install_quantized(prec)
        torch.cuda.synchronize()
        install[prec] = time.perf_counter() - t1
        slot = idx.substrate._quant[prec]
        print(f"[full] install_quantized({prec!r}) {install[prec]:.3f} s "
              f"(data {tuple(slot['data'].shape)} {slot['data'].dtype}, "
              f"{slot['bytes_per_vector']} B per vector) peak_gb="
              f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f}")
    t0 = time.perf_counter()
    gt, gd = ground_truth(base, attrs, qv, ranges, 10)
    print(f"[full] ground truth on the card in {time.perf_counter() - t0:.2f} s")

    configs = [(_path_name(p, path), p, bw, uk)
               for p in PRECISIONS for path, bw, uk in PATHS]
    out = {c[0]: [] for c in configs}
    strat = {c[0]: [] for c in configs}
    secs = {c[0]: 0.0 for c in configs}
    launches = {c[0]: dict.fromkeys(ops.LAUNCHES, 0) for c in configs}
    dispatches = dict.fromkeys(out, 0)       # graph-routed partitions
    beam_calls = []
    inner = sub.beam_search_batch

    def counted(*a, **kw):
        beam_calls.append(1)
        return inner(*a, **kw)

    sub.beam_search_batch = counted
    planner = idx.planner
    for lo in range(0, nq, batch):
        q_b, r_b = qv[lo:lo + batch], ranges[lo:lo + batch]
        start = json.dumps(planner.cost.state_dict())
        follow = None
        for name, prec, bw, uk in configs:
            # every path plans this batch from the same calibration state,
            # so a kernel path and its plain path route alike
            planner.cost.load_state_dict(json.loads(start))
            beam_calls.clear()
            ops.reset_launches()          # this path's run, and only it
            t1 = time.perf_counter()
            res = idx.search(q_b, r_b, k=10, ef=64, plan="auto",
                             beam_width=bw, use_kernel=uk, precision=prec)
            secs[name] += time.perf_counter() - t1
            for kern, c in ops.LAUNCHES.items():
                launches[name][kern] += c
            dispatches[name] += len(beam_calls)
            out[name].append(res)
            strat[name].append(res.stats["strategy"])
            if follow is None:
                follow = json.dumps(planner.cost.state_dict())
        planner.cost.load_state_dict(json.loads(follow))
    sub.beam_search_batch = inner
    nonzero = {c: {k: v for k, v in cnt.items() if v}
               for c, cnt in launches.items()}
    print(f"[full] launches per path over {nq} queries: "
          f"{json.dumps(nonzero)}; graph-routed partitions per path: "
          f"{json.dumps(dispatches)}")
    _check_launches(launches, dispatches)

    summary = {}
    ids = {c: np.concatenate([r.ids for r in out[c]]) for c in out}
    dists = {c: np.concatenate([r.dists for r in out[c]]) for c in out}
    stats = {c: {s: np.concatenate([r.stats[s] for r in out[c]])
                 for s in ("hops", "ndist")} for c in out}
    for name, prec, _, _ in configs:
        s = np.concatenate(strat[name])
        scan = s == SCAN
        bad = _same_sets(ids[name][scan], gt[scan], gd[scan],
                         dists[name][scan])
        exact = 1.0 - len(bad) / max(int(scan.sum()), 1)
        if (prec == "f32" and bad) or exact < 0.99:
            raise AssertionError(f"{name}: scan-routed queries not exact: "
                                 f"{np.flatnonzero(scan)[bad][:10].tolist()}")
        rec = {int(lv): recall_at_k(ids[name][level == lv], gt[level == lv])
               for lv in np.unique(level)}
        summary[name] = dict(qps=nq / secs[name], seconds=secs[name],
                             recall=recall_at_k(ids[name], gt),
                             recall_by_level=rec,
                             scan_share=float(scan.mean()),
                             scan_exact=int(scan.sum()) - len(bad),
                             scan_routed=int(scan.sum()),
                             launches=launches[name])
        print(f"[full] {name}: qps={nq / secs[name]:.1f} "
              f"recall@10={summary[name]['recall']:.4f} "
              f"scan_share={scan.mean():.3f} scan_exact="
              f"{int(scan.sum()) - len(bad)}/{int(scan.sum())} "
              f"recall_by_level=" +
              ",".join(f"2^-{lv}:{r:.3f}" for lv, r in rec.items()))
    for prec in PRECISIONS:
        for kern, plain in (("bw1_kernel", "bw1_plain"),
                            ("bw4_kernel", "bw4_plain")):
            kern, plain = _path_name(prec, kern), _path_name(prec, plain)
            same = (ids[kern] == ids[plain]).all(1)
            diff = np.flatnonzero(~same)
            print(f"[full] {kern} vs {plain}: {same.mean() * 100:.2f}% of "
                  f"queries equal; differing rows {diff[:20].tolist()}")
            if same.mean() < 0.99:
                raise AssertionError(f"{kern} differs from {plain} on "
                                     f"{len(diff)} queries")
            summary[kern]["equal_to_plain"] = float(same.mean())
    for kern, plain in (("bw1_kernel", "bw1_plain"),
                        ("bw4_kernel", "bw4_plain")):
        graph = np.concatenate(strat[kern]) != SCAN
        if not np.array_equal(graph, np.concatenate(strat[plain]) != SCAN):
            raise AssertionError(f"{kern} and {plain} routed apart")
        eq = ((stats[kern]["hops"] == stats[plain]["hops"])
              & (stats[kern]["ndist"] == stats[plain]["ndist"]))[graph]
        rows = np.flatnonzero(graph)[~eq]
        print(f"[full] {kern} vs {plain}: hops and ndist equal on "
              f"{eq.mean() * 100:.2f}% of {int(graph.sum())} graph-routed "
              f"queries")
        for r in rows[:20]:
            gap = np.abs(dists[kern][r] - dists[plain][r])
            fin = np.isfinite(gap)
            print(f"[full]   query {r}: hops {stats[kern]['hops'][r]} / "
                  f"{stats[plain]['hops'][r]}, ndist "
                  f"{stats[kern]['ndist'][r]} / {stats[plain]['ndist'][r]}, "
                  f"top-10 ids equal {bool((ids[kern][r] == ids[plain][r]).all())}, "
                  f"max top-10 distance gap "
                  f"{float(gap[fin].max()) if fin.any() else 0.0:.3g}")
        if eq.mean() < 0.99:
            raise AssertionError(f"{kern}: hops/ndist differ from {plain} on "
                                 f"{len(rows)} graph-routed queries")
        summary[kern]["hops_ndist_equal_to_plain"] = float(eq.mean())
    beam = phase_beam(idx, qv[:batch], ranges[:batch])
    for prec in PRECISIONS[1:]:
        for path, _, _ in PATHS:
            name = _path_name(prec, path)
            same = (ids[name] == ids[path]).all(1)
            summary[name]["equal_to_f32"] = float(same.mean())
            print(f"[full] {name} vs {path}: {same.mean() * 100:.2f}% of "
                  f"queries equal")

    # the graph alone (no scan routing) as ef grows: recall that climbs
    # toward 1 says the low recall at ef=64 is the beam's reach, not a
    # graph that cannot lead to the answers
    sweep = {}
    for ef in (64, 256, 1024):
        t1 = time.perf_counter()
        got = np.concatenate([
            idx.search(qv[lo:lo + batch], ranges[lo:lo + batch], k=10, ef=ef,
                       plan="graph", beam_width=4, use_kernel=True).ids
            for lo in range(0, nq, batch)])
        dt = time.perf_counter() - t1
        rec = {int(lv): recall_at_k(got[level == lv], gt[level == lv])
               for lv in np.unique(level)}
        sweep[ef] = dict(qps=nq / dt, recall=recall_at_k(got, gt),
                         recall_by_level=rec)
        print(f"[full] graph bw4_kernel ef={ef}: qps={nq / dt:.1f} "
              f"recall@10={sweep[ef]['recall']:.4f} recall_by_level=" +
              ",".join(f"2^-{lv}:{r:.3f}" for lv, r in rec.items()))
    held = dict(graph=idx.g.arrays(), base=base, attrs=attrs, qv=qv,
                ranges=ranges, level=level, gt=gt, gd=gd)
    return dict(build=st, install_quantized_s=install, configs=summary,
                launches=launches, dispatches=dispatches,
                graph_ef_sweep=sweep, beam=beam, batch=batch, nq=nq,
                n=n), held


def phase_beam(idx, qv, ranges):
    """The fused beams (``ops.beam_single`` at bw 1, ``ops.beam_batched`` at
    bw 4) on one batch of the full phase as the substrate dispatches it
    (ef=64, its entries and rank bounds), at every precision, against the
    lockstep loop on the same card tensors: hops and ndist equal on >= 99%
    of lanes and the top-10 of those lanes equal up to near-ties.  Times
    both with CUDA events (the wrapper's host set-up included) beside the
    byte bound of the work this batch needs: each scored row read once
    (sum of ndist rows of d elements), each expanded node's neighbour-id
    row once (sum of hops x B x m x 4 bytes), the queries once; its
    operations (3 d flops per scored row) are far below.  Returns
    {kernel: {precision: record}}."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.search import resolve
    sub = idx.substrate
    lo, hi = idx.rank_range(ranges)
    dev = sub._vecs.device
    lo_t = torch.as_tensor(lo, device=dev).long()
    hi_t = torch.as_tensor(hi, device=dev).long()
    entry = resolve.select_entry(
        sub._rmq, sub._dist_c, lo_t.clamp(0, sub.n - 1),
        hi_t.clamp(0, sub.n - 1), sub.n)
    q = torch.as_tensor(qv, device=dev)
    ef = 64
    kw = dict(ef=ef, steps_cap=8 * ef + 64, early_stop=True)
    n, m = sub._nbrs.shape
    atol = 1e-4 * max(1.0, float((sub._vecs * sub._vecs).sum(1).max()))
    recs = {"beam_single": {}, "beam_batched": {}}
    for prec in PRECISIONS:
        quant = sub._quant_ops(prec)
        x, scale = (sub._vecs, None) if quant is None else quant
        args = (x, scale, sub._nbrs, q, lo_t, hi_t, entry)
        for name, bw in (("beam_single", 1), ("beam_batched", 4)):
            extra = {"beam_width": bw} if bw > 1 else {}
            run_k = lambda: getattr(ops, name)(*args, **kw, **extra)
            plain = getattr(ref, f"{name}_ref")
            run_p = lambda: plain(*args, **kw, **extra)
            got, want = run_k(), run_p()
            same = ((got[2] == want[2]) & (got[3] == want[3])).cpu().numpy()
            if same.mean() < 0.99:
                raise AssertionError(f"{name} {prec}: hops/ndist differ from "
                                     f"the lockstep loop on lanes "
                                     f"{np.flatnonzero(~same)[:10].tolist()}")
            rows = torch.as_tensor(np.flatnonzero(same), device=dev)
            top = lambda t: (torch.where(torch.isfinite(t[0][rows][:, :10]),
                                         t[1][rows][:, :10], -1),
                             t[0][rows][:, :10])
            err = _compare(f"{name} {prec}", top(got), top(want), atol)
            hops = got[2].cpu().numpy()
            ndist = got[3].cpu().numpy()
            B = bw
            nbytes = (int(ndist.sum()) * x.shape[1] * x.element_size()
                      + int(hops.sum()) * B * m * 4 + q.numel() * 4
                      + (0 if scale is None else scale.numel() * 4))
            bound, by = _bound(nbytes, float(ndist.sum()) * 3 * x.shape[1])
            ms = _time_ms(run_k, 20)
            pms = _time_ms(run_p, 3)
            recs[name][prec] = dict(
                q=len(qv), ef=ef, bw=bw, ms=ms, plain_ms=pms, bound_ms=bound,
                bound_by=by, max_abs_err=err, max_lane_hops=int(hops.max()),
                per_hop_ms=ms / max(int(hops.max()), 1),
                hops_sum=int(hops.sum()), ndist_sum=int(ndist.sum()),
                lanes_equal=float(same.mean()),
                shape=f"q={len(qv)} ef={ef} bw={bw} n={n} d={x.shape[1]} "
                      f"m={m} {prec}")
            print(f"[beam] {name} {prec} q={len(qv)} ef={ef} bw={bw}: equal "
                  f"to the lockstep loop on {same.mean() * 100:.1f}% of lanes"
                  f" err={err:.3g} ms={ms:.4f} plain_ms={pms:.4f} "
                  f"bound_ms={bound:.5f} ({by}) longest lane "
                  f"{int(hops.max())} hops, {ms / max(int(hops.max()), 1):.5f}"
                  f" ms per hop")
    return recs


def phase_witness(seed, out: Path, n=100_000, nq=200):
    """The port's card build and graph search at n = 100,000, written for
    ``scale_witness.py`` (the JAX reference on the CPU): the card's exact
    KNN ids, the graph built from them, and the ``plan="graph"`` ids, hops
    and ndist at ef=64, bw 1 and 4, with the kernels.  The vectors, ranges
    and queries are made again from the seed on the other side."""
    import torch
    from repro_torch.core.rfann import RNSGIndex
    from repro_torch.data.ann import make_attrs, make_vectors, mixed_workload
    from repro_torch.index.knn import exact_knn
    t0 = time.perf_counter()
    allv = make_vectors(n + nq, 128, seed=seed)
    base, qv = allv[:n], allv[n:]
    attrs = make_attrs(n, seed=seed)
    ranges, _ = mixed_workload(attrs, nq, seed=seed)
    vs = torch.as_tensor(base[np.argsort(attrs, kind="stable")],
                         device="cuda")
    knn = exact_knn(vs, 32)[1].cpu().numpy().astype(np.int32)
    del vs
    m, ef_attribute = 32, 48                  # the build_rnsg defaults
    idx = RNSGIndex.build(base, attrs, m=m, ef_attribute=ef_attribute,
                          knn_ids=knn)
    arrays = {k: v for k, v in idx.g.arrays().items()
              if k not in ("vecs", "attrs")}
    res = {}
    for bw in (1, 4):
        r = idx.search(qv, ranges, k=10, ef=64, plan="graph", beam_width=bw,
                       use_kernel=True)
        res.update({f"ids_bw{bw}": r.ids, f"hops_bw{bw}": r.stats["hops"],
                    f"ndist_bw{bw}": r.stats["ndist"]})
    out.mkdir(exist_ok=True)
    path = out / f"witness_n{n}.npz"
    np.savez_compressed(path, seed=seed, n=n, nq=nq, m=m,
                        ef_attribute=ef_attribute, knn_ids=knn,
                        **arrays, **res)
    st = idx.stats()
    print(f"[witness] n={n} built on the card (edges={st['edges']} "
          f"mean_degree={st['mean_degree']:.3f}) and searched; wrote {path} "
          f"({path.stat().st_size / 2**20:.1f} MB) in "
          f"{time.perf_counter() - t0:.1f} s")


def phase_witness_segtree(out: Path, n=8192, nq=200):
    """The bench's segment tree (m = 48, ef_spatial = 96) built on the card
    at n × 128, past one KNN_TILE so its upper levels take segment_knn's
    sliced branch, and searched (the mixed workload, k = 10, ef = 64);
    written to ``out/witness_segtree_n<n>.npz`` with its corpus, queries
    and ranges for ``scale_witness.py``, which builds and searches the JAX
    reference's segment tree on the same data."""
    import benchmarks.common_torch as ct
    from repro_torch.index.baselines import SegmentTreeIndex
    t0 = time.perf_counter()
    vecs, attrs = ct.dataset(n, 128)
    qv = ct.dataset(nq, 128, seed=91)[0]
    ranges = ct.workloads(attrs, nq)["mixed"]
    idx = SegmentTreeIndex(vecs, attrs, m=48, ef_spatial=96, device="cuda")
    ids, dists, st = idx.search(qv, ranges, k=10, ef=64)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"witness_segtree_n{n}.npz"
    np.savez_compressed(path, kind="segtree", m=48, ef_spatial=96, k=10,
                        ef=64, vecs=vecs, attrs=attrs, queries=qv,
                        ranges=ranges, nbrs=idx.nbrs, order=idx.order,
                        centroid=idx.centroid, dist_c=idx.dist_c,
                        rmq=idx.rmq, ids=ids, dists=dists,
                        hops=st["hops"], ndist=st["ndist"])
    print(f"[witness] segment tree n={n} ({idx.levels} levels) built on the "
          f"card and searched; wrote {path} "
          f"({path.stat().st_size / 2**20:.1f} MB) in "
          f"{time.perf_counter() - t0:.1f} s")


def _check_segment_knn(vs, k):
    """``segment_knn`` on the card (through the l2dist kernel) against a
    plain computation of the same matrices: each KNN_TILE-row tile against
    its whole block with ``ref.l2dist_ref`` on the card, self excluded,
    ``torch.topk``.  At every block size the build's top level and the
    sizes where segment_knn switches branch (KNN_TILE, 2^16) reach; ids
    must be equal up to near-ties (``_compare``).  Returns per-size
    records."""
    import torch
    from repro_torch.index.baselines import KNN_TILE, segment_knn
    from repro_torch.kernels import ref
    n = vs.shape[0]
    v = torch.as_tensor(vs, device="cuda")
    atol = 1e-4 * max(1.0, float((v * v).sum(1).max()))
    top = 1 << max(1, int(np.ceil(np.log2(max(n, 2)))))
    recs = []
    for size in sorted({KNN_TILE, 1 << 16, top}):
        if size > top:
            continue
        kk = min(k, size - 1)
        got = segment_knn(v, size, kk)
        gi, gd, wi, wd = [], [], [], []
        for lo in range(0, n, KNN_TILE):
            hi = min(lo + KNN_TILE, n)
            start = lo // size * size
            end = min(start + size, n)
            dm = ref.l2dist_ref(v[lo:hi], v[start:end])
            r = torch.arange(hi - lo, device="cuda")
            dm[r, r + (lo - start)] = float("inf")
            dk, ik = torch.topk(dm, min(kk, end - start - 1), dim=1,
                                largest=False)
            g = torch.as_tensor(got[lo:hi, :dk.shape[1]], device="cuda")
            gi.append(g.long() - start)
            gd.append(dm.gather(1, g.long() - start))
            wi.append(ik)
            wd.append(dk)
        err = _compare(f"segment_knn size={size} k={kk}",
                       (torch.cat(gi), torch.cat(gd)),
                       (torch.cat(wi), torch.cat(wd)), atol)
        recs.append(dict(size=size, k=kk, max_abs_err=err))
        print(f"[bench] segment_knn size={size} k={kk} on the card equals "
              f"the plain computation on all {n} rows up to near-ties "
              f"(largest distance gap at a swapped position {err:.3g})")
    return recs


def _check_ground_truth(vecs, attrs, qv, ranges, gt, name):
    """The bench's ground truth against a plain float64 one on the card:
    every point's distance by differences (``torch.cdist`` without the
    matmul), masked to the range, ``torch.topk``; ids equal up to
    near-ties (``_compare``, distances of both sides in float64)."""
    import torch
    x = torch.as_tensor(vecs, device="cuda", dtype=torch.float64)
    a = torch.as_tensor(attrs, device="cuda")
    atol = 1e-4 * max(1.0, float((x * x).sum(1).max()))
    gi, gd, wi, wd = [], [], [], []
    k = gt.shape[1]
    for i in range(0, len(qv), 250):
        q = torch.as_tensor(qv[i:i + 250], device="cuda", dtype=torch.float64)
        r = torch.as_tensor(np.asarray(ranges[i:i + 250], np.float32),
                            device="cuda")
        dm = torch.cdist(q, x, compute_mode="donot_use_mm_for_euclid_dist")
        dm = dm * dm
        ok = (a[None, :] >= r[:, :1]) & (a[None, :] <= r[:, 1:2])
        dm = torch.where(ok, dm, float("inf"))
        dk, ik = torch.topk(dm, k, dim=1, largest=False)
        wi.append(torch.where(torch.isfinite(dk), ik, -1))
        wd.append(dk)
        g = torch.as_tensor(gt[i:i + 250], device="cuda").long()
        gi.append(g)
        gd.append(torch.where(g >= 0, dm.gather(1, g.clamp_min(0)),
                              float("inf")))
    return _compare(f"ground truth {name}", (torch.cat(gi), torch.cat(gd)),
                    (torch.cat(wi), torch.cat(wd)), atol)


def phase_bench(n, nq, out: Path):
    """The benchmark path (``benchmarks.run_torch``) on the card at n × 128:
    per-method builds with their launch counts, the QPS/recall sweep, build
    time, index size and the kernel microbench; tables to
    ``out/bench_torch``.  Returns the records for the summary."""
    import torch
    import benchmarks.common_torch as ct
    import benchmarks.run_torch as rt
    from repro_torch.index.knn import exact_knn, knn_recall, nndescent
    from repro_torch.kernels import ops
    ct.RESULTS = out / "bench_torch"
    dev = torch.device("cuda")
    d = 128
    t0 = time.perf_counter()
    vecs, attrs = ct.dataset(n, d)
    methods, build_launches = {}, {}
    for name, make in ct.method_builders(quick=False, device=dev).items():
        torch.cuda.synchronize()
        ops.reset_launches()           # this build's launches, and only its
        methods[name] = make(vecs, attrs)
        torch.cuda.synchronize()
        build_launches[name] = {k: v for k, v in ops.LAUNCHES.items() if v}
        print(f"[bench] build {name}: {ct.build_seconds(methods[name]):.2f} s "
              f"index_mb={methods[name].index_bytes / 2**20:.3f} "
              f"launches={build_launches[name]}")
    if not build_launches["segtree"].get("l2dist.f32"):
        raise AssertionError(f"segtree build launched no l2dist: "
                             f"{build_launches['segtree']}")
    seg = _check_segment_knn(methods["segtree"].vecs, 96)
    ops.reset_launches()
    t1 = time.perf_counter()
    qps = rt.bench_qps_recall(n, d, nq, False, dev, methods)
    search_s = time.perf_counter() - t1
    search_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    if search_launches:
        raise AssertionError(f"the benchmark's searches (plan='graph', "
                             f"plain beams) launched {search_launches}")
    for r in qps:
        print(f"[bench] qps_recall {r['method']} {r['workload']} ef={r['ef']}"
              f" recall={r['recall']} qps={r['qps']}")
    builds = rt.bench_construction_time(n, d, False, dev, methods)
    sizes = rt.bench_index_size(n, d, False, dev, methods)
    qv = ct.dataset(nq, d, seed=91)[0]
    gt_err = {}
    for wname, ranges in ct.workloads(attrs, nq).items():
        gt = ct.gt_for(vecs, attrs, qv, ranges, 10, dev)
        gt_err[wname] = _check_ground_truth(vecs, attrs, qv, ranges, gt,
                                            wname)
        ids = methods["brute"].search(qv, ranges, k=10)[0]
        bad = np.flatnonzero((ids != gt).any(1))
        if len(bad):
            raise AssertionError(f"brute force {wname}: rows {bad[:10]} "
                                 f"differ from the ground truth")
    print(f"[bench] the ground truth equals a float64 difference-form "
          f"top-k up to near-ties, and brute force equals the ground truth, "
          f"on all {4 * nq} queries (max abs dist err {gt_err})")
    kern = rt.bench_kernels(False, dev)
    for r in kern:
        print(f"[bench] kernels {r}")
    del methods
    torch.cuda.empty_cache()
    v = torch.as_tensor(vecs, device=dev)
    t1 = time.perf_counter()
    approx = nndescent(v, 32)[1].cpu().numpy()
    nnd_s = time.perf_counter() - t1
    exact = exact_knn(v, 32)[1].cpu().numpy()
    rec = knn_recall(approx, exact)
    print(f"[bench] knn_recall(nndescent(vecs, 32), exact_knn(vecs, 32)) = "
          f"{rec:.4f} at n={n} (nndescent {nnd_s:.2f} s)")
    wall = time.perf_counter() - t0
    print(f"[bench] done n={n} d={d} nq={nq}: searches {search_s:.1f} s, "
          f"phase {wall:.1f} s")
    return dict(n=n, d=d, nq=nq, build_launches=build_launches,
                segment_knn=seg, ground_truth_err=gt_err,
                qps_recall=qps, construction_time=builds, index_size=sizes,
                kernels=kern, nndescent_recall=rec, nndescent_s=nnd_s,
                search_s=search_s, wall_s=wall)


def _serve(argv, ops, counters):
    """One in-process run of the launcher with the launch counts (and the
    given call counters) zeroed just before it and read just after it.
    Returns (its record, its launches)."""
    from repro_torch.launch import serve
    for c in counters:
        c.clear()
    ops.reset_launches()
    rec = serve.main(argv)
    return rec, {k: v for k, v in ops.LAUNCHES.items() if v}


def _lockstep_counter():
    """Wrap the fused beams' plain versions (the lockstep loops) to count
    their calls; returns (counter list, undo)."""
    from repro_torch.kernels import ref
    calls, saved = [], {}
    for name in ("beam_single_ref", "beam_batched_ref"):
        inner = saved[name] = getattr(ref, name)

        def counted(*a, _inner=inner, **kw):
            calls.append(1)
            return _inner(*a, **kw)
        setattr(ref, name, counted)

    def undo():
        for name, fn in saved.items():
            setattr(ref, name, fn)
    return calls, undo


def _need_launches(name, got, need, zero=()):
    if not all(got.get(k, 0) > 0 for k in need) or any(got.get(k, 0)
                                                        for k in zero):
        raise AssertionError(f"{name}: launches {got} need {need} and none "
                             f"of {list(zero)}")


def phase_serve(n, tmp: Path, ops, nreq=4096):
    """``python -m repro_torch.launch.serve --mode rfann`` in-process at
    n × 128 with the serve defaults (k=10, ef=64, --max-batch 64,
    plan="auto"), 4,096 requests of the mixed workload, a 64 MB result
    cache, a 4-shard index directory, calibration and metrics files: run 1
    builds and persists; run 2 restores (no rebuild) and serves the same
    stream at half of run 1's QPS; run 3 restores at int8, bw 4 with the
    same calibration file; run 4 repeats run 3 with a calibration file of
    its own.  Each run must restore (but run 1), launch its fused beam (and
    gather_rerank at int8, never at f32) and never the lockstep loop, and
    come within 0.01 of ``RNSGIndex.search``'s recall@10 on the same
    queries and index, each query searched with the strategy the served
    run's planner chose for it (the calibration drifts with the batch sizes
    a run sees, so a free ``plan="auto"`` pass would route differently).
    Runs 1, 2 and 4 must launch range_scan too; run 3's routing (a
    calibration learned at run 2's batches of about four) is reported, not
    required.  The metrics file must hold every core family."""
    import torch
    from repro_torch.core.rfann import RNSGIndex
    from repro_torch.data.ann import (ground_truth, make_attrs,
                                      make_vectors, mixed_workload,
                                      recall_at_k)
    from repro_torch.obs import CORE_FAMILIES, parse_prometheus
    from repro_torch.planner import BEAM, SCAN
    d = 128
    tmp.mkdir(parents=True, exist_ok=True)
    idx_dir, prom = tmp / "idx", tmp / "metrics.prom"
    base = ["--device", "cuda", "--n", str(n), "--dim", str(d),
            "--requests", str(nreq), "--cache-mb", "64",
            "--index-path", str(idx_dir), "--index-shards", "4",
            "--metrics-path", str(prom)]
    cal = ["--calibration", str(tmp / "calibration.json")]
    int8 = ["--precision", "int8", "--beam-width", "4"]
    plans = (("build", cal, True), ("restore", None, True),
             ("int8_bw4", cal + int8, False),
             ("int8_bw4_fresh", int8 + ["--calibration",
                                        str(tmp / "calibration-int8.json")],
              True))
    lockstep, undo = _lockstep_counter()
    runs, t0 = {}, time.perf_counter()
    try:
        for name, extra, need_scan in plans:
            if extra is None:
                extra = cal + ["--rate", f"{runs['build']['qps'] / 2:.1f}"]
            t1 = time.perf_counter()
            rec, launches = _serve(base + extra, ops, [lockstep])
            wall = time.perf_counter() - t1
            prec, bw = ("int8", 4) if "--precision" in extra else ("f32", 1)
            beam = f"{'beam_batched' if bw > 1 else 'beam_single'}.{prec}"
            need = [beam] + ([f"range_scan.{prec}"] if need_scan else []) + (
                ["gather_rerank"] if prec == "int8" else [])
            _need_launches(f"serve {name}", launches, need,
                           [] if prec == "int8" else ["gather_rerank"])
            if lockstep:
                raise AssertionError(f"serve {name}: the lockstep loop ran "
                                     f"{len(lockstep)} times")
            if (rec["restored"] is None) != (name == "build"):
                raise AssertionError(f"serve {name}: restored "
                                     f"{rec['restored']}")
            names = {m for m, _ in parse_prometheus(prom.read_text())}
            miss = [f for f in CORE_FAMILIES
                    if not any(m == f or m.startswith(f + "_")
                               for m in names)]
            if miss:
                raise AssertionError(f"serve {name}: metrics lack {miss}")
            summ = rec["summary"]
            calls = summ["batches"] + 1           # + the warm-up search
            cost = json.loads(Path(str(prom) + ".json").read_text()).get(
                "cost_model")
            runs[name] = dict(
                qps=rec["qps"], recall=rec["recall"], served=rec["served"],
                seconds=rec["seconds"], wall_s=wall, summary=summ,
                restore_s=(rec["restored"] or {}).get("seconds"),
                cache=rec.get("cache"), launches=launches, cost_model=cost,
                launches_per_batch={k: v / calls
                                    for k, v in launches.items()},
                args=" ".join(base[2:] + extra))
            print(f"[serve] {name}: qps={rec['qps']:.1f} "
                  f"recall@10={rec['recall']:.4f} p50_ms={summ['p50_ms']:.3f}"
                  f" p99_ms={summ['p99_ms']:.3f} batches={summ['batches']} "
                  f"mean_batch={summ['mean_batch']:.1f} "
                  f"scan_frac={summ['scan_frac']:.3f} launches={launches} "
                  f"per batch (of {calls}, the warm-up search included) "
                  f"{json.dumps({k: round(v, 3) for k, v in runs[name]['launches_per_batch'].items()})} "
                  f"restore_s={runs[name]['restore_s']} wall {wall:.1f} s")
            print(f"[serve] {name} EngineStats.summary() {json.dumps(summ)}")
            print(f"[serve] {name} cost model at shutdown {json.dumps(cost)}")
            # the library path on the same index and queries, each query
            # with the strategy the served run's planner chose for it
            if name == "build":
                vecs = make_vectors(n, d, seed=0)
                attrs = make_attrs(n, seed=0)
                qv = make_vectors(nreq, d, seed=7)
                ranges, _ = mixed_workload(attrs, nreq, seed=3)
                order = np.argsort(attrs, kind="stable")
                gt_r, _ = ground_truth(vecs[order], attrs[order], qv,
                                       ranges, 10)
                gt = np.where(gt_r >= 0, order[np.maximum(gt_r, 0)], -1)
                idx = RNSGIndex.load(str(idx_dir), device="cuda")
                auto = np.concatenate([
                    idx.search(qv[i:i + 64], ranges[i:i + 64], k=10, ef=64,
                               plan="auto").ids
                    for i in range(0, nreq, 64)])
                auto_rec = recall_at_k(auto, gt)
            if prec != "f32":
                idx.install_quantized(prec)
            lib = np.full_like(rec["ids"], -1)
            for plan, code in (("scan", SCAN), ("beam", BEAM)):
                sel = np.flatnonzero(rec["strategy"] == code)
                for i in range(0, len(sel), 64):
                    s = sel[i:i + 64]
                    lib[s] = idx.search(qv[s], ranges[s], k=10, ef=64,
                                        plan=plan, beam_width=bw,
                                        precision=prec).ids
            lib_rec = recall_at_k(lib, gt)
            same = float((lib == rec["ids"]).all(1).mean())
            runs[name].update(library_recall=lib_rec, equal_to_library=same)
            print(f"[serve] {name}: RNSGIndex.search on the persisted index "
                  f"with the served routing: recall@10={lib_rec:.4f}, ids "
                  f"equal on {same * 100:.2f}% of queries (plan='auto' at "
                  f"f32 from the prior calibration: recall@10="
                  f"{auto_rec:.4f})")
            if abs(rec["recall"] - lib_rec) > 0.01:
                raise AssertionError(f"serve {name}: recall "
                                     f"{rec['recall']:.4f} is more than 0.01 "
                                     f"from RNSGIndex.search's {lib_rec:.4f}")
        del idx
        torch.cuda.empty_cache()
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[serve] done in {time.perf_counter() - t0:.1f} s")
    return dict(n=n, d=d, requests=nreq, runs=runs,
                library_auto_recall=auto_rec)


def _crash_script(live_ids: np.ndarray, n: int, steps: int, seed=11):
    """The churn of the stream phase's crashed server, from the live set it
    restored: per step one insert of the highest corpus row not live, and
    one delete per four steps of a live id in a seeded order.  Returns
    [("I" | "D", id)]."""
    live = np.zeros(n, bool)
    live[live_ids] = True
    pending = np.flatnonzero(~live)[::-1]
    victims = np.random.default_rng(seed).permutation(live_ids)
    ops = []
    for i in range(steps):
        ops.append(("I", int(pending[i])))
        if i % 4 == 3:
            ops.append(("D", int(victims[i // 4])))
    return ops


def _live_after(live_ids: np.ndarray, ops) -> np.ndarray:
    """The ascending live ids after applying ``ops`` to ``live_ids``."""
    live = set(live_ids.tolist())
    for op, j in ops:
        (live.add if op == "I" else live.discard)(j)
    return np.array(sorted(live), np.int64)


def _stream_crash_child(ckpt: str, wal: str, ack: str, n: int,
                        steps: int) -> None:
    """The crashed server of the stream phase, run in a process of its own
    on the card: restore the checkpoint and replay the WAL as the launcher
    does, write ``READY <live digest>`` to ``ack``, then churn
    ``_crash_script`` through an ``RFANNEngine`` with the WAL attached (no
    compaction, so the tail stays in the log), appending the count of
    acknowledged mutations to ``ack`` after each one returns.  The parent
    SIGKILLs it mid-churn."""
    import os
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.ann import make_attrs, make_vectors
    from repro_torch.index import io
    from repro_torch.launch.serve import live_record
    from repro_torch.serving.engine import RFANNEngine
    idx = io.load_index(ckpt, device="cuda")
    idx.replay_wal(wal)
    start = live_record(idx)
    vecs = make_vectors(n, 128, seed=0)
    attrs = make_attrs(n, seed=0)
    script = _crash_script(start["live_ids"], n, steps)
    eng = RFANNEngine(idx, k=10, ef=64, max_delta=10**9, wal_dir=wal,
                      index_path=ckpt)
    fd = os.open(ack, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
    os.write(fd, f"READY {start['live_digest']}\n".encode())
    for i, (op, j) in enumerate(script):
        if op == "I":
            eng.insert(vecs[j], float(attrs[j]), ext_id=j)
        else:
            eng.delete(j)
        os.write(fd, f"{i + 1}\n".encode())
    os.write(fd, b"DONE\n")
    time.sleep(600)                 # the parent kills it before this ends


def _crash_mid_churn(ckpt, wal, n, steps, kill_at, timeout=300):
    """Run ``_stream_crash_child`` and SIGKILL it once ``kill_at``
    mutations are acknowledged.  Returns (the digest it restored, the count
    of acknowledged mutations)."""
    import signal
    ack = wal.parent / "acks"
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke._stream_crash_child("
            f"{str(ckpt)!r}, {str(wal)!r}, {str(ack)!r}, {n}, {steps})")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT)
    deadline, lines = time.time() + timeout, []
    try:
        while time.time() < deadline and proc.poll() is None:
            lines = ack.read_text().split("\n")[:-1] if ack.exists() else []
            if len(lines) > kill_at:
                break
            time.sleep(0.01)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    lines = ack.read_text().split("\n")[:-1] if ack.exists() else []
    if len(lines) <= kill_at or lines[-1] == "DONE":
        raise AssertionError(f"stream: the crashed server acknowledged "
                             f"{len(lines) - 1} mutations (exit "
                             f"{proc.returncode}), not {kill_at} of {steps} "
                             f"before the kill")
    return lines[0].split()[1], int(lines[-1])


def phase_stream(n, tmp: Path, ops, nreq=8192, max_delta=4000,
                 crash_steps=4096, kill_at=512):
    """The launcher's streaming mode in-process at n × 128: 8,192
    requests, ``--max-delta 4000``, a WAL and a checkpoint directory; the
    first half churns the held-out 20 % of the corpus in (one insert per
    request) and one delete per four, which fills the delta and compacts
    on the card (4,096 inserts less the deletes that land in the delta
    leave it just short of 4,096 rows, so the threshold sits below).  Then
    a server in a process of its own restores the directories (its live
    set must equal the first run's final one), churns on with the WAL and
    is SIGKILLed after ``kill_at`` acknowledged mutations, and the launcher
    restarts on the same directories: it must replay that WAL tail onto the
    checkpoint to the acknowledged live set (or that set and the one
    mutation in flight at the kill), vectors and attributes included.
    Prints the compaction's wall time and the delta scan's launches, and
    holds the delta scan (range_scan at bucket = the delta's capacity)
    against its plain version at each capacity 128 .. 8192."""
    import torch
    from repro_torch.data.ann import make_attrs, make_vectors
    from repro_torch.launch.serve import live_digest
    from repro_torch.streaming import DeltaView
    d = 128
    tmp.mkdir(parents=True, exist_ok=True)
    wal, ckpt, prom = tmp / "wal", tmp / "ckpt", tmp / "metrics.prom"
    base = ["--device", "cuda", "--n", str(n), "--dim", str(d),
            "--max-delta", str(max_delta), "--wal-dir", str(wal),
            "--index-path", str(ckpt), "--metrics-path", str(prom)]
    lockstep, undo = _lockstep_counter()
    t0 = time.perf_counter()
    try:
        rec, launches = _serve(base + ["--requests", str(nreq)], ops,
                               [lockstep])
        if lockstep:
            raise AssertionError("stream: the lockstep loop ran")
        _need_launches("stream", launches,
                       ["beam_single.f32", "range_scan.f32"])
        snap = json.loads(Path(str(prom) + ".json").read_text())
        comp = snap["counters"].get("stream_compactions_total", 0)
        if comp < 1:
            raise AssertionError("stream: no compaction ran")
        build_h = snap["histograms"]["stream_compaction_build_ms"]
        pause_h = snap["histograms"]["stream_compaction_pause_ms"]
        # the base's scans are the engine's scan dispatches (one launch
        # each; the warm-up's 2^0-level queries route to the graph), the
        # rest of range_scan's launches are the delta's
        base_scans = snap["histograms"].get("scan_dispatch_ms", {}).get(
            "count", 0)
        scans = launches["range_scan.f32"] - base_scans
        if scans < 1:
            raise AssertionError(f"stream: no delta scan ({launches}, "
                                 f"{base_scans} base scans)")
        first = dict(qps=rec["qps"], recall=rec["recall"],
                     served=rec["served"], seconds=rec["seconds"],
                     summary=rec["summary"], launches=launches,
                     compactions=comp,
                     compaction_build_ms=build_h, compaction_pause_ms=pause_h,
                     base_scan_launches=base_scans,
                     delta_scan_launches=scans, live=len(rec["live_ids"]),
                     streaming=snap.get("streaming"), wal=snap.get("wal"))
        print(f"[stream] qps={rec['qps']:.1f} recall@10 (second half, final "
              f"live set)={rec['recall']:.4f} compactions={comp} compaction "
              f"build wall {build_h['sum'] / max(build_h['count'], 1):.1f} ms"
              f" (pause {pause_h['max']:.3f} ms) delta scans: {scans} "
              f"range_scan launches ({launches['range_scan.f32']} less the "
              f"base's {base_scans}); launches {launches}; live "
              f"{len(rec['live_ids'])} ids")
        print(f"[stream] EngineStats.summary() {json.dumps(rec['summary'])}")
        # a server restores the directories, churns and is killed
        t1 = time.perf_counter()
        digest, acked = _crash_mid_churn(ckpt, wal, n, crash_steps, kill_at)
        crash_s = time.perf_counter() - t1
        if digest != rec["live_digest"]:
            raise AssertionError("stream: a restore of the first run's "
                                 "directories differs from its live set")
        script = _crash_script(rec["live_ids"], n, crash_steps)
        rec2, launches2 = _serve(base + ["--requests", str(nreq // 8)], ops,
                                 [lockstep])
        got = rec2["restored"]
        if got is None or got["replayed"] < max(acked, 1):
            raise AssertionError(f"stream restart: replayed "
                                 f"{got and got['replayed']} WAL records, "
                                 f"{acked} mutations were acknowledged")
        vecs = make_vectors(n, d, seed=0)
        attrs = make_attrs(n, seed=0)
        match = None
        for m in (acked, acked + 1):
            want = _live_after(rec["live_ids"], script[:m])
            if np.array_equal(got["live_ids"], want) and got[
                    "live_digest"] == live_digest(want, attrs[want],
                                                  vecs[want]):
                match = m
                break
        print(f"[stream] restart after a SIGKILL {acked} acknowledged "
              f"mutations into the churn ({crash_s:.1f} s with the child's "
              f"start): replayed {got['replayed']} WAL records onto the "
              f"checkpoint in {got['seconds']:.2f} s of restore; live set "
              f"{len(got['live_ids'])} ids, equal (ids, vectors, "
              f"attributes) to the first run's final set with the first "
              f"{match} of the {len(script)} mutations; then served "
              f"{rec2['served']} at qps={rec2['qps']:.1f} "
              f"recall@10={rec2['recall']:.4f}")
        if match is None:
            raise AssertionError("stream restart: the live set is not the "
                                 "acknowledged one")
        first["restart"] = dict(acked=acked, replayed=got["replayed"],
                                applied=match, live=len(got["live_ids"]),
                                restore_s=got["seconds"], qps=rec2["qps"],
                                recall=rec2["recall"], launches=launches2)
        del vecs, attrs
        # the delta scan on the card against its plain version
        rng = np.random.default_rng(5)
        parity = []
        for cap in (128, 256, 512, 1024, 2048, 4096, 8192):
            m = cap - cap // 3
            v = rng.standard_normal((m, d)).astype(np.float32)
            a = np.sort(rng.random(m).astype(np.float32))
            ids = np.arange(m, dtype=np.int32) + 7
            qv = rng.standard_normal((64, d)).astype(np.float32)
            lo = rng.random(64).astype(np.float32) * 0.8
            ar = np.stack([lo, lo + rng.random(64).astype(np.float32) * 0.3],
                          1)
            got_v = DeltaView(v, a, ids, "cuda")
            want_v = DeltaView(v, a, ids, "cpu")
            got_r = got_v.search(qv, ar, 10)
            want_r = want_v.search(qv, ar, 10)
            atol = 1e-4 * max(1.0, float((v * v).sum(1).max()))
            err = _compare(f"delta scan capacity {cap}",
                           tuple(torch.as_tensor(x) for x in got_r),
                           tuple(torch.as_tensor(x) for x in want_r), atol)
            capacity = got_v._dev[2]
            ms = _time_ms(lambda: got_v.search(qv, ar, 10), 20)
            parity.append(dict(capacity=int(capacity), rows=m, q=64, k=10,
                               max_abs_err=err, ms=ms))
            print(f"[stream] delta scan capacity {capacity} ({m} rows): "
                  f"equal to the plain version, err={err:.3g}, "
                  f"{ms:.4f} ms per search (host set-up and copies "
                  f"included)")
        first["delta_parity"] = parity
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
    first["wall_s"] = time.perf_counter() - t0
    print(f"[stream] done in {first['wall_s']:.1f} s")
    return first


#: the mesh phase: shards of the full corpus, all on the first card (the
#: reference's own shard count: benchmarks/run.py, tests/test_multidevice.py)
MESH_SHARDS = 8
MESH_PATHS = ("async", "seq", "mesh")


def _agree(ia, da, ib, db, atol) -> np.ndarray:
    """Per row: equal ids, or ids that differ only at near-ties (positions
    whose two distances agree within ``_compare``'s tolerance)."""
    diff = ia != ib
    tie = np.isclose(da, db, rtol=1e-4, atol=atol) & np.isfinite(da)
    return ~(diff & ~tie).any(1)


def _local_routing(dist, lo, hi, k, ef, bw, prec) -> np.ndarray:
    """(S, Q) strategy each local shard's planner gives each query from its
    current state (empty clips route to the scan, as ``plan_batch`` does)."""
    from repro_torch.search import clip_interval
    out = []
    for s, sub in enumerate(dist.substrates):
        slo, shi = clip_interval(lo, hi, s * dist.per, dist.per)
        lens = np.clip(shi.astype(np.int64) - slo + 1, 0, None)
        out.append(sub.planner.choose_strategy_batch(
            lens, k=k, ef=ef, beam_width=bw, precision=prec))
    return np.stack(out)


def _enqueue_without_sync(dist, qv, lo, hi, **kw):
    """The local async path's enqueue — every shard's
    ``dispatch(defer=True)`` — under ``torch.cuda.set_sync_debug_mode
    ("error")``: a host sync before the merge (``.cpu()``, ``.item()``,
    ``nonzero``, a pageable copy) raises.  Returns the shards' results."""
    import torch
    from repro_torch.search import SearchRequest, clip_interval
    pending = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for s, sub in enumerate(dist.substrates):
            slo, shi = clip_interval(lo, hi, s * dist.per, dist.per)
            pending.append(sub.dispatch(SearchRequest(
                queries=qv, lo=slo, hi=shi, use_kernel=True, **kw),
                defer=True))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [p.result() for p in pending]


def _mesh_name(path, prec, bw, plan):
    return f"{path}_{prec}_bw{bw}_{plan}"


def _mesh_local_own(local, qv, ranges, gt, ops, batch):
    """The local async and sequential paths of ``local`` as deployed (its
    shards' own int8 scales, its planners' own calibration), at plan auto /
    graph, bw 1 / 4, f32 / int8: every planner reset to its post-build
    state before each path, launches zeroed just before each call and read
    just after.  Each path must launch its fused beam (and gather_rerank
    at int8), never a gather kernel or the lockstep loop.  Returns
    {"summary": per path QPS, recall, scan share, launches per batch;
    "launches": per path totals}."""
    from repro_torch.data.ann import recall_at_k
    from repro_torch.planner import SCAN
    local.install_quantized("int8")
    built = [json.dumps(sub.planner.cost.state_dict())
             for sub in local.substrates]
    nq = len(qv)
    batches = -(-nq // batch)
    summary, totals = {}, {}
    lockstep, undo = _lockstep_counter()
    try:
        for prec in ("f32", "int8"):
            for bw in (1, 4):
                for plan in ("auto", "graph"):
                    for path in ("async", "seq"):
                        name = "own_" + _mesh_name(path, prec, bw, plan)
                        for sub, st in zip(local.substrates, built):
                            sub.planner.cost.load_state_dict(json.loads(st))
                        local.async_dispatch = path == "async"
                        lockstep.clear()
                        got = dict.fromkeys(ops.LAUNCHES, 0)
                        secs, ids, scan = 0.0, [], []
                        for b0 in range(0, nq, batch):
                            lo_b, hi_b = local.rank_range(
                                ranges[b0:b0 + batch])
                            if plan == "auto":
                                scan.append((_local_routing(
                                    local, lo_b, hi_b, 10, 64, bw, prec)
                                    == SCAN).all(0))
                            ops.reset_launches()
                            t1 = time.perf_counter()
                            res = local.search_ranks(
                                qv[b0:b0 + batch], lo_b, hi_b, k=10, ef=64,
                                plan=plan, beam_width=bw, precision=prec)
                            secs += time.perf_counter() - t1
                            for kern, c in ops.LAUNCHES.items():
                                got[kern] += c
                            ids.append(res.ids)
                        beam = f"{('beam_single', 'beam_batched')[bw > 1]}" \
                               f".{prec}"
                        need = [beam] + (["gather_rerank"] if prec != "f32"
                                         else [])
                        zero = [f"{g}.{p}" for g in ("gather_dist",
                                                     "gather_topk",
                                                     "beam_single",
                                                     "beam_batched",
                                                     "range_scan")
                                for p in PRECISIONS
                                if p != prec or g in ("gather_dist",
                                                      "gather_topk")] + (
                            ["gather_rerank"] if prec == "f32" else [])
                        _need_launches(f"mesh {name}", got, need, zero)
                        if lockstep:
                            raise AssertionError(f"mesh {name}: the lockstep "
                                                 f"loop ran {len(lockstep)} "
                                                 f"times")
                        nz = {k: v for k, v in got.items() if v}
                        share = (float(np.concatenate(scan).mean()) if scan
                                 else 0.0)
                        rec = recall_at_k(np.concatenate(ids), gt)
                        summary[name] = dict(
                            qps=nq / secs, seconds=secs, recall=rec,
                            scan_share=share, launches=nz,
                            launches_per_batch={k: v / batches
                                                for k, v in nz.items()})
                        totals[name] = nz
                        print(f"[mesh] {name} (own scales and calibration): "
                              f"qps={nq / secs:.1f} recall@10={rec:.4f} "
                              f"scan_share={share:.3f} launches per batch "
                              + json.dumps({k: round(v / batches, 3)
                                            for k, v in nz.items()}))
    finally:
        undo()
    return dict(summary=summary, launches=totals)


def phase_mesh(held, tmp: Path, ops, n_serve=100_000, nreq=1024, batch=64):
    """Multi-device serving and the sharded build, S = 8 shards of the full
    phase's corpus on the first card: (1) ``RNSGIndex.build_sharded`` at
    1M × 128, bit-equal to the full phase's ``build_rnsg`` graph; (2)
    ``DistributedRFANN`` local (async and sequential) and mesh paths over
    the full phase's queries, each at plan auto / graph, bw 1 / 4, f32 /
    int8, plus a plain pass (f32, bw 1, auto, ``use_kernel`` off): async
    equal to sequential, mesh equal to local (on the queries both route
    alike under auto), the kernel path equal to the plain pass, each on
    >= 99 % of queries up to near-ties; scan-routed queries exact (all at
    f32, >= 99 % at int8); launches zeroed just before each call and read
    just after (each kernel path its fused beam, range_scan under auto,
    gather_rerank at int8, never the lockstep loop or a gather kernel);
    (3) the launcher with --build-shards 8 at n_serve × 128: its graph
    equal to ``build_rnsg``'s, its recall within 0.01 of
    ``RNSGIndex.search`` under the served routing."""
    import torch
    from repro_torch.core.construction import ARRAY_FIELDS, build_rnsg
    from repro_torch.core.rfann import RNSGIndex
    from repro_torch.data.ann import (ground_truth, make_attrs, make_vectors,
                                      mixed_workload, recall_at_k)
    from repro_torch.parallel.sharding import make_mesh
    from repro_torch.planner import BEAM, SCAN
    from repro_torch.serving.distributed import DistributedRFANN
    S = MESH_SHARDS
    base, attrs, qv, ranges, level, gt, gd = (
        held[k] for k in ("base", "attrs", "qv", "ranges", "level", "gt",
                          "gd"))
    n, nq = len(base), len(qv)
    t_phase = time.perf_counter()
    build_kw = dict(m=32, ef_spatial=32, ef_attribute=48)

    # (1) the sharded build against the full phase's build_rnsg graph
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    g = RNSGIndex.build_sharded(base, attrs, n_shards=S, **build_kw).g
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    got = g.arrays()
    bad = [f for f in ARRAY_FIELDS
           if not np.array_equal(got[f], held["graph"][f])]
    nz = {k: v for k, v in ops.LAUNCHES.items() if v}
    print(f"[mesh] build_sharded n={n} S={S} in {sharded_s:.2f} s "
          f"(meta {g.meta}); arrays bit-equal to build_rnsg's: "
          f"{not bad} {bad}; launches {nz}")
    if bad:
        raise AssertionError(f"mesh: build_sharded differs from build_rnsg "
                             f"in {bad}")
    del g, got
    torch.cuda.empty_cache()

    # (2) DistributedRFANN: the local path and the mesh path
    t0 = time.perf_counter()
    local = DistributedRFANN(base, attrs, n_shards=S, **build_kw)
    torch.cuda.synchronize()
    local_build_s = time.perf_counter() - t0
    mesh = make_mesh(S)
    t0 = time.perf_counter()
    meshd = DistributedRFANN(base, attrs, n_shards=S, mesh=mesh, **build_kw)
    torch.cuda.synchronize()
    mesh_build_s = time.perf_counter() - t0
    for s in range(S):
        if not (torch.equal(local.nbrs[s], meshd.nbrs[s])
                and torch.equal(local.order[s], meshd.order[s])):
            raise AssertionError(f"mesh: shard {s}'s graph differs between "
                                 f"two builds")
    print(f"[mesh] DistributedRFANN n={n} S={S} (per={local.per}) built in "
          f"{local_build_s:.2f} s (local) / {mesh_build_s:.2f} s (mesh, "
          f"devices {sorted(set(map(str, mesh.devices)))}); shard graphs "
          f"equal; index_mb={local.index_bytes / 2**20:.1f}")
    # the local path as users deploy it: each shard's own int8 scale (the
    # reference's semantics) and each local planner its own calibration,
    # from its post-build state and learning as the path goes.  The local
    # paths' QPS and launches per batch are read here; the comparison below
    # runs them on the mesh's int8 copy and calibration instead.
    own = _mesh_local_own(local, qv, ranges, gt, ops, batch)
    # the mesh scales its int8 corpus over all shards jointly, each local
    # shard over its own rows (as in the reference); the local shards take
    # the mesh's copy here, so both paths score against one corpus
    meshd.install_quantized("int8")
    joint = meshd.mesh_substrate._quant_for("int8")
    for s, sub in enumerate(local.substrates):
        sub.preload_quantized("int8", joint["data"][s], joint["scale"][s])
    atol = 1e-4 * max(1.0, float(np.max(np.sum(
        base.astype(np.float64) ** 2, axis=1))))
    configs = [(path, prec, bw, plan, True)
               for prec in ("f32", "int8") for bw in (1, 4)
               for plan in ("auto", "graph") for path in MESH_PATHS]
    configs.append(("plain", "f32", 1, "auto", False))
    names = [_mesh_name(*c[:4]) for c in configs]
    ids = {c: [] for c in names}
    dists = {c: [] for c in names}
    strat = {c: [] for c in names}
    secs = dict.fromkeys(names, 0.0)
    launches = {c: dict.fromkeys(ops.LAUNCHES, 0) for c in names}
    locksteps = dict.fromkeys(names, 0)
    routing = {}                    # (prec, bw) -> local (S, nq) routing
    lo_all, hi_all = local.rank_range(ranges)
    planners = ([sub.planner for sub in local.substrates]
                + [meshd.mesh_substrate.planner])
    start = json.dumps(meshd.mesh_substrate.planner.cost.state_dict())
    lockstep, undo = _lockstep_counter()
    try:
        for b0 in range(0, nq, batch):
            q_b = qv[b0:b0 + batch]
            lo_b, hi_b = local.rank_range(ranges[b0:b0 + batch])
            follow = None
            for c, name in zip(configs, names):
                path, prec, bw, plan, uk = c
                # every path plans this batch from one calibration state,
                # so the local paths route alike and the mesh path routes
                # from the same costs
                for p in planners:
                    p.cost.load_state_dict(json.loads(start))
                if plan == "auto" and path == "async":
                    routing.setdefault((prec, bw), []).append(_local_routing(
                        local, lo_b, hi_b, 10, 64, bw, prec))
                local.async_dispatch = path != "seq"
                dist = meshd if path == "mesh" else local
                lockstep.clear()
                ops.reset_launches()      # this path's run, and only it
                t1 = time.perf_counter()
                res = dist.search_ranks(q_b, lo_b, hi_b, k=10, ef=64,
                                        plan=plan, beam_width=bw,
                                        precision=prec,
                                        use_kernel=None if uk else False)
                secs[name] += time.perf_counter() - t1
                for kern, cnt in ops.LAUNCHES.items():
                    launches[name][kern] += cnt
                locksteps[name] += len(lockstep)
                ids[name].append(res.ids)
                dists[name].append(res.dists)
                strat[name].append(res.stats.get(
                    "strategy", np.full(len(q_b), -1, np.int8)))
                if follow is None and path == "mesh":
                    follow = json.dumps(
                        meshd.mesh_substrate.planner.cost.state_dict())
            start = follow
    finally:
        undo()
    for c in names:
        ids[c], dists[c] = np.concatenate(ids[c]), np.concatenate(dists[c])
        strat[c] = np.concatenate(strat[c])
    routing = {k: np.concatenate(v, axis=1) for k, v in routing.items()}

    # launches: each kernel path its fused beam, range_scan under auto,
    # gather_rerank at int8, no gather kernel and no lockstep loop; the
    # plain pass the lockstep loop and no fused beam
    beams, gathers = ("beam_single", "beam_batched"), ("gather_dist",
                                                       "gather_topk")
    for c, name in zip(configs, names):
        path, prec, bw, plan, uk = c
        got = launches[name]
        beam = f"{beams[bw > 1]}.{prec}"
        need = ([beam] if uk else []) + (
            [f"range_scan.{prec}"] if plan == "auto" else []) + (
            ["gather_rerank"] if prec != "f32" else [])
        zero = [f"{g}.{p}" for g in gathers + beams + ("range_scan",)
                for p in PRECISIONS if f"{g}.{p}" not in need] + (
            ["gather_rerank"] if prec == "f32" else [])
        if not all(got[k] > 0 for k in need) or any(got[k] for k in zero):
            raise AssertionError(f"mesh {name}: launches {got} need {need} "
                                 f"and none of {zero}")
        if (locksteps[name] > 0) == uk:
            raise AssertionError(f"mesh {name}: the lockstep loop ran "
                                 f"{locksteps[name]} times")
    batches = -(-nq // batch)
    summary = {}
    for c, name in zip(configs, names):
        path, prec, bw, plan, uk = c
        # scan-routed: the mesh's one decision per query; on the local
        # paths every shard the query touches routed it to the scan
        if plan == "graph":
            scan = np.zeros(nq, bool)
        elif path == "mesh":
            scan = strat[name] == SCAN
        else:
            scan = (routing[(prec, bw)] == SCAN).all(0)
        bad = _same_sets(ids[name][scan], gt[scan], gd[scan],
                         dists[name][scan])
        exact = 1.0 - len(bad) / max(int(scan.sum()), 1)
        if (prec == "f32" and bad) or exact < 0.99:
            raise AssertionError(f"mesh {name}: scan-routed queries not "
                                 f"exact: "
                                 f"{np.flatnonzero(scan)[bad][:10].tolist()}")
        rec = {int(lv): recall_at_k(ids[name][level == lv], gt[level == lv])
               for lv in np.unique(level)}
        nz = {k: v for k, v in launches[name].items() if v}
        per_batch = {k: round(v / batches, 3) for k, v in nz.items()}
        summary[name] = dict(
            path=path, precision=prec, beam_width=bw, plan=plan,
            use_kernel=uk, qps=nq / secs[name], seconds=secs[name],
            recall=recall_at_k(ids[name], gt), recall_by_level=rec,
            scan_share=float(scan.mean()), scan_routed=int(scan.sum()),
            scan_exact=int(scan.sum()) - len(bad), launches=nz,
            launches_per_batch={k: v / batches for k, v in nz.items()},
            lockstep_calls=locksteps[name])
        print(f"[mesh] {name}: qps={nq / secs[name]:.1f} "
              f"recall@10={summary[name]['recall']:.4f} "
              f"scan_share={scan.mean():.3f} scan_exact="
              f"{int(scan.sum()) - len(bad)}/{int(scan.sum())} launches per "
              f"batch {json.dumps(per_batch)} "
              f"recall_by_level=" +
              ",".join(f"2^-{lv}:{r:.3f}" for lv, r in rec.items()))

    def hold(a, b, what, rows=None):
        ok = _agree(ids[a], dists[a], ids[b], dists[b], atol)
        exact = (ids[a] == ids[b]).all(1)
        sel = np.ones(nq, bool) if rows is None else rows
        share = float(ok[sel].mean()) if sel.any() else 1.0
        print(f"[mesh] {a} vs {b}: {share * 100:.2f}% of {int(sel.sum())} "
              f"{what} equal up to near-ties ({exact[sel].mean() * 100:.2f}% "
              f"exactly); differing rows "
              f"{np.flatnonzero(sel & ~ok)[:20].tolist()}")
        if share < 0.99:
            raise AssertionError(f"mesh: {a} differs from {b} on "
                                 f"{int((sel & ~ok).sum())} {what}")
        return share
    equal = {}
    for prec in ("f32", "int8"):
        for bw in (1, 4):
            for plan in ("auto", "graph"):
                a, s_, m_ = (_mesh_name(p, prec, bw, plan) for p in MESH_PATHS)
                equal[f"{a}=={s_}"] = hold(a, s_, "queries")
                alike = None
                if plan == "auto":
                    # a query both paths route alike: the mesh's decision
                    # on every shard its interval touches
                    touched = (np.stack([np.clip(np.minimum(
                        hi_all, (s + 1) * local.per - 1).astype(np.int64)
                        - np.maximum(lo_all, s * local.per) + 1, 0, None)
                        for s in range(S)]) > 0)
                    alike = ((routing[(prec, bw)] == strat[m_][None, :])
                             | ~touched).all(0)
                    print(f"[mesh] {m_}: {alike.mean() * 100:.2f}% of "
                          f"queries routed alike on the mesh and local "
                          f"paths")
                    summary[m_]["routed_alike"] = float(alike.mean())
                    overall = float(_agree(ids[m_], dists[m_], ids[a],
                                           dists[a], atol).mean())
                    summary[m_]["equal_to_local_all"] = overall
                    print(f"[mesh] {m_} vs {a}: {overall * 100:.2f}% of all "
                          f"{nq} queries equal up to near-ties")
                equal[f"{m_}=={a}"] = hold(
                    m_, a, "queries" if alike is None
                    else "queries routed alike", alike)
    equal["plain=kernel"] = hold(_mesh_name("async", "f32", 1, "auto"),
                                 _mesh_name("plain", "f32", 1, "auto"),
                                 "queries")
    # the async path enqueues every shard before anything waits on the card
    lo0, hi0 = local.rank_range(ranges[:batch])
    for prec, bw, plan in (("f32", 1, "auto"), ("f32", 4, "graph"),
                           ("int8", 4, "auto")):
        res = _enqueue_without_sync(local, qv[:batch], lo0, hi0, k=10, ef=64,
                                    strategy=plan, beam_width=bw,
                                    precision=prec)
        print(f"[mesh] local async enqueue of {len(res)} shards ({prec}, "
              f"bw {bw}, {plan}): no host sync before the merge")

    # the idle share of one mesh batch and one local async batch, read
    # under torch.profiler after every timed phase (their wall times now)
    probes = {}
    for name, dist in (("mesh_f32_bw1_auto", meshd),
                       ("async_f32_bw1_auto", local)):
        local.async_dispatch = True
        fn = functools.partial(dist.search_ranks, qv[:batch], lo0, hi0,
                               k=10, ef=64, plan="auto")
        fn()
        t1 = time.perf_counter()
        for _ in range(10):
            fn()
        probes[name] = dict(wall_ms=(time.perf_counter() - t1) * 100)
        _device_probe(probes[name], fn, f"mesh phase {name}, one batch "
                      f"of {batch}")

    # the mesh path's per-shard graph body as the dry-run counts it: one
    # device's share on fakes that it derives from the index's rows per
    # shard, dimension, degree and precision; each must have the shape and
    # dtype of the index's own shard-0 tensor
    lowered = {}
    for prec in ("f32", "int8"):
        r = meshd.lower_for_dryrun(batch, meshd.dim, k=10, ef=64,
                                   precision=prec)
        real = [meshd.vecs[0], meshd.nbrs[0], meshd.rmq[0],
                meshd.dist_c[0], meshd.order[0]]
        if prec != "f32":
            slot = meshd.mesh_substrate._quant_for(prec)
            real += [t for t in (slot["data"][0], slot["scale"][0])
                     if t is not None]
        fakes = [(tuple(t.shape), str(t.dtype)) for t in r.pop("operands")]
        reals = [(tuple(t.shape), str(t.dtype)) for t in real]
        want = sum(t.numel() * t.element_size() for t in real)
        lowered[prec] = dict(r, real_operand_bytes=want)
        print(f"[mesh] lower_for_dryrun {prec}: shard 0's operands derived "
              f"from (rows {meshd.per}, d {meshd.dim}, m {meshd.degree}): "
              f"{fakes}, {r['operand_bytes']} B; the index's tensors "
              f"{reals}, {want} B; queries {r['query_bytes']} B, the "
              f"merge's all-gathers {r['gather_bytes']} B per device, "
              f"{r['flops']:.4e} operations (one hop), counted in "
              f"{r['seconds']:.2f} s")
        if fakes != reals or r["operand_bytes"] != want:
            raise AssertionError(f"mesh: lower_for_dryrun's operands "
                                 f"{fakes} ({r['operand_bytes']} B) are not "
                                 f"the index's {reals} ({want} B)")

    # (3) the launcher's sharded build: its graph equal to build_rnsg's,
    # its recall within 0.01 of RNSGIndex.search under the served routing
    tmp.mkdir(parents=True, exist_ok=True)
    d = 128
    lockstep, undo = _lockstep_counter()
    try:
        t1 = time.perf_counter()
        rec, got_l = _serve(["--device", "cuda", "--n", str(n_serve),
                             "--dim", str(d), "--requests", str(nreq),
                             "--build-shards", str(S), "--index-path",
                             str(tmp / "idx")], ops, [lockstep])
        serve_wall = time.perf_counter() - t1
        _need_launches("mesh launcher", got_l,
                       ["beam_single.f32", "range_scan.f32"],
                       ["gather_rerank"])
        if lockstep:
            raise AssertionError(f"mesh launcher: the lockstep loop ran "
                                 f"{len(lockstep)} times")
    finally:
        undo()
    vecs = make_vectors(n_serve, d, seed=0)
    attrs_s = make_attrs(n_serve, seed=0)
    q_s = make_vectors(nreq, d, seed=7)
    r_s, _ = mixed_workload(attrs_s, nreq, seed=3)
    idx = RNSGIndex.load(str(tmp / "idx"), device="cuda")
    want = build_rnsg(vecs, attrs_s, **build_kw).arrays()
    got = idx.g.arrays()
    bad = [f for f in ARRAY_FIELDS if not np.array_equal(got[f], want[f])]
    if bad:
        raise AssertionError(f"mesh launcher: --build-shards {S} graph "
                             f"differs from build_rnsg's in {bad}")
    order = np.argsort(attrs_s, kind="stable")
    gt_r, _ = ground_truth(vecs[order], attrs_s[order], q_s, r_s, 10)
    gt_s = np.where(gt_r >= 0, order[np.maximum(gt_r, 0)], -1)
    lib = np.full_like(rec["ids"], -1)
    for plan, code in (("scan", SCAN), ("beam", BEAM)):
        sel = np.flatnonzero(rec["strategy"] == code)
        for i in range(0, len(sel), batch):
            s_ = sel[i:i + batch]
            lib[s_] = idx.search(q_s[s_], r_s[s_], k=10, ef=64,
                                 plan=plan).ids
    lib_rec = recall_at_k(lib, gt_s)
    summ = rec["summary"]
    launcher = dict(qps=rec["qps"], recall=rec["recall"],
                    library_recall=lib_rec, served=rec["served"],
                    wall_s=serve_wall, launches=got_l,
                    scan_frac=summ["scan_frac"], batches=summ["batches"],
                    equal_to_library=float((lib == rec["ids"]).all(1).mean()),
                    args=f"--n {n_serve} --dim {d} --requests {nreq} "
                         f"--build-shards {S}")
    print(f"[mesh] launcher --build-shards {S} n={n_serve}: graph equal to "
          f"build_rnsg's; qps={rec['qps']:.1f} recall@10={rec['recall']:.4f} "
          f"(RNSGIndex.search with the served routing {lib_rec:.4f}, ids "
          f"equal on {launcher['equal_to_library'] * 100:.2f}%) "
          f"scan_frac={summ['scan_frac']:.3f} launches={got_l} wall "
          f"{serve_wall:.1f} s")
    if abs(rec["recall"] - lib_rec) > 0.01:
        raise AssertionError(f"mesh launcher: recall {rec['recall']:.4f} is "
                             f"more than 0.01 from RNSGIndex.search's "
                             f"{lib_rec:.4f}")
    del idx
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[mesh] done in {wall:.1f} s")
    return dict(n=n, shards=S, per=local.per, sharded_build_s=sharded_s,
                local_build_s=local_build_s, mesh_build_s=mesh_build_s,
                configs=summary, equal=equal, probes=probes,
                lowered=lowered,
                launcher=launcher, batch=batch, nq=nq, wall_s=wall,
                own=own["summary"],
                launches={**{c: {k: v for k, v in launches[c].items() if v}
                             for c in names}, **own["launches"]})


#: the lm phase's tolerances.  f32 (TF32 off): the two paths or devices sum
#: in another order only.  bf16 keeps 8 mantissa bits and the two paths
#: round at different points through every layer: the relative L2 distance
#: of the decode logits from the longer prefill's
LM_F32_ATOL = 1e-3
LM_BF16_REL = 0.1


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _host(t) -> np.ndarray:
    return t.float().cpu().numpy().copy()


def _lm_full(label, cfg, seed, batch, seq, steps, probe=False):
    """One model on the card: parameters drawn there from ``seed``, a
    warm-up and a timed prefill of batch × seq tokens, ``steps`` greedy
    decode steps, then the prefill of seq + 1 tokens against the first
    decode step's logits.  Prints each number beside its bound.  With
    ``probe``, queues a device-time reading of one decode step (its own
    cache, made at the reading) for the last phase; the model stays on the
    card until then."""
    import torch
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models.lm import Model
    from repro_torch.models.params import count_params
    from repro_torch.training.tree import leaves
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != count_params(cfg):
        raise AssertionError(f"[lm] {label}: {n_params} parameters, the "
                             f"spec {count_params(cfg)}")
    p_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    emb = params["embed"]
    # a step gathers rows of an untied embedding table; every other weight
    # (a tied table is the head) is a product operand read whole.  The head
    # (vocab x d) scores only the last position of a prefill
    gathered = 0 if cfg.tie_embeddings else emb.numel()
    mm_params = n_params - gathered
    head = emb.numel()
    peak_flops = BF16_FLOPS if cfg.dtype == "bfloat16" else F32_FLOPS
    b = concrete_batch(cfg, "prefill", batch, seq, np.random.default_rng(seed),
                       device=dev)
    V = cfg.vocab_size
    with torch.inference_mode():
        t0 = time.perf_counter()
        model.prefill(params, b, cache_len=seq + steps)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cache, logits = model.prefill(params, b, cache_len=seq + steps)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        toks = [torch.argmax(logits[:, :V], -1).int()]
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        t0 = time.perf_counter()
        evs[0].record()
        for i in range(steps):
            lg, cache = model.decode(params, cache, seq + i, toks[-1])
            if i == 0:
                l_dec = lg
            toks.append(torch.argmax(lg[:, :V], -1).int())
            evs[i + 1].record()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        step_ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(steps)]
        c_bytes = sum(t.numel() * t.element_size() for t in leaves(cache))
        del cache
        _, l_full = model.prefill(params, dict(
            b, tokens=torch.cat([b["tokens"], toks[0][:, None]], 1)))
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ld, lf = _host(l_dec[:, :V]), _host(l_full[:, :V])
    rel, err = _rel(ld, lf), float(np.max(np.abs(ld - lf)))
    ok = bool(np.isfinite(ld).all() and np.isfinite(lf).all())
    ok &= (rel <= LM_BF16_REL) if cfg.dtype == "bfloat16" else \
        (err <= LM_F32_ATOL)
    out = _host(torch.stack(toks, 1))
    dec_ms = decode_s * 1e3 / steps
    pre_bound, pre_by = _bound(
        p_bytes, 2.0 * ((mm_params - head) * seq + head) * batch, peak_flops)
    dec_bound, dec_by = _bound(p_bytes - gathered * emb.element_size()
                               + c_bytes, 2.0 * mm_params * batch, peak_flops)
    rec = dict(arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
               batch=batch, seq=seq, steps=steps, params=n_params,
               param_bytes=p_bytes, cache_bytes=c_bytes, init_s=init_s,
               init_bound_ms=p_bytes / HBM_BYTES_PER_S * 1e3,
               first_prefill_ms=first_ms, prefill_ms=prefill_ms,
               prefill_bound_ms=pre_bound, prefill_bound_by=pre_by,
               decode_ms_per_step=dec_ms, decode_step_ms=step_ms,
               decode_bound_ms=dec_bound, decode_bound_by=dec_by,
               tok_s=batch * steps / decode_s,
               tok_s_bound=batch / dec_bound * 1e3,
               init_peak_bytes=init_peak, peak_bytes=peak, held_bytes=held,
               peak_bound_bytes=held + p_bytes + c_bytes,
               consistency_rel=rel, consistency_max_abs=err,
               consistency_ok=ok, tokens=out[0].tolist())
    if probe:
        state, tok = {}, toks[0]

        def step(model=model, params=params, b=b):
            with torch.inference_mode():
                if not state:
                    state["cache"] = model.prefill(params, b,
                                                   cache_len=seq + 1)[0]
                model.decode(params, state["cache"], seq, tok)

        rec["probe"] = dict(wall_ms=dec_ms)
        _device_probe(rec["probe"], step, f"lm {label}: one decode step", 5)
    print(f"[lm] {label}: {n_params:,} parameters, {p_bytes / 1e9:.3f} GB "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype})")
    print(f"[lm] {label}: init {init_s * 1e3:.1f} ms (bound "
          f"{rec['init_bound_ms']:.2f} ms: the parameter bytes written once)")
    print(f"[lm] {label}: prefill {batch} x {seq} tokens {prefill_ms:.2f} ms "
          f"(first call {first_ms:.2f} ms; bound {pre_bound:.2f} ms, by "
          f"{pre_by})")
    print(f"[lm] {label}: decode {dec_ms:.3f} ms per step (median event time "
          f"{float(np.median(step_ms)):.3f} ms, first step {step_ms[0]:.3f}; "
          f"bound {dec_bound:.3f} ms, by {dec_by})")
    print(f"[lm] {label}: {rec['tok_s']:.1f} tok/s (bound "
          f"{rec['tok_s_bound']:.1f})")
    print(f"[lm] {label}: peak memory {peak / 1e9:.3f} GB over the prefills "
          f"and decode steps, {init_peak / 1e9:.3f} GB over the init (bound "
          f"{rec['peak_bound_bytes'] / 1e9:.3f} GB: {held / 1e9:.3f} held "
          f"before, the parameters and the cache)")
    print(f"[lm] {label}: decode after a prefill of {seq} against the last "
          f"position of a prefill of {seq + 1}: relative L2 {rel:.3e}, max "
          f"abs {err:.3e} (limit "
          + (f"relative {LM_BF16_REL})" if cfg.dtype == "bfloat16"
             else f"abs {LM_F32_ATOL})"))
    if not ok:
        raise AssertionError(f"[lm] {label}: prefill and decode disagree "
                             f"(relative L2 {rel:.3e}, max abs {err:.3e})")
    del params, logits, lg, l_dec, l_full, b, model
    torch.cuda.empty_cache()
    return rec


def _lm_trace(cfg, flat, batch, dev, steps, toks=None):
    """Prefill then ``steps`` decode steps on ``dev`` with the parameters
    ``flat`` ((path, array) pairs) and the host batch ``batch``; feeds
    ``toks`` or greedy tokens.  Returns ([(logits, {leaf: array})] after
    the prefill and each step, the tokens fed)."""
    import torch
    from repro_torch.models.lm import Model
    from repro_torch.models.params import DTYPES, params_from_reference
    model = Model(cfg, device=dev)
    params = params_from_reference(flat, cfg, dev)
    b = {k: (v if v.dtype == torch.int32 else v.to(DTYPES[cfg.dtype])).to(dev)
         for k, v in batch.items()}
    S = b["tokens"].shape[1]
    out, fed = [], []
    with torch.inference_mode():
        cache, logits = model.prefill(params, b, cache_len=S + steps)
        for i in range(steps + 1):
            out.append((_host(logits), {k: _host(v) for k, v in cache.items()}))
            if i == steps:
                break
            fed.append(torch.argmax(logits[:, :cfg.vocab_size], -1).int().cpu()
                       if toks is None else toks[i])
            logits, cache = model.decode(params, cache, S + i, fed[-1].to(dev))
    return out, fed


def _cat(cache):
    return np.concatenate([cache[k].ravel() for k in sorted(cache)])


def _lm_smoke(arch, seed):
    """``arch``'s smoke config on the card against the same port code on the
    CPU, same parameters (numpy from ``seed``), batch and tokens: prefill
    and 4 decode steps.  f32: logits within 1e-4 absolute, each cache leaf
    within 1e-4·max(1, its max |value|).  bf16: at every step the relative
    L2 distance of the card's logits (and of its whole cache) from the
    CPU's at most twice the CPU's own bf16-vs-f32 distance (its f32 run on
    the bf16-rounded parameters and inputs, fed the same tokens)."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models.params import numpy_params
    steps, rec = 4, {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
        flat = list(numpy_params(cfg, seed))
        batch = concrete_batch(cfg, "prefill", 2, 16,
                               np.random.default_rng(seed), device="cpu")
        cpu, toks = _lm_trace(cfg, flat, batch, torch.device("cpu"), steps)
        card, _ = _lm_trace(cfg, flat, batch, torch.device("cuda"), steps,
                            toks)
        if dtype == "float32":
            err_l = max(float(np.max(np.abs(c[0] - g[0])))
                        for c, g in zip(cpu, card))
            err_c = max(float(np.max(np.abs(c[1][k] - g[1][k])))
                        / max(1.0, float(np.max(np.abs(c[1][k]))))
                        for c, g in zip(cpu, card) for k in c[1])
            ok = err_l <= 1e-4 and err_c <= 1e-4
            rec[dtype] = dict(logits_max_abs=err_l, cache_max_scaled=err_c,
                              ok=ok)
            msg = (f"logits max abs {err_l:.2e}, cache max "
                   f"{err_c:.2e} (of max(1, |leaf|)); limits 1e-4")
        else:
            c32 = dataclasses.replace(cfg, dtype="float32")
            rounded = [(p, torch.from_numpy(a).to(torch.bfloat16).float().numpy())
                       for p, a in flat]
            own, _ = _lm_trace(c32, rounded, batch, torch.device("cpu"),
                               steps, toks)
            ratio_l = max(_rel(g[0], c[0]) / max(_rel(c[0], f[0]), 1e-30)
                          for c, g, f in zip(cpu, card, own))
            ratio_c = max(_rel(_cat(g[1]), _cat(c[1]))
                          / max(_rel(_cat(c[1]), _cat(f[1])), 1e-30)
                          for c, g, f in zip(cpu, card, own))
            ok = ratio_l <= 2.0 and ratio_c <= 2.0
            rec[dtype] = dict(
                logits_rel=max(_rel(g[0], c[0]) for c, g in zip(cpu, card)),
                own_rel=min(_rel(c[0], f[0]) for c, f in zip(cpu, own)),
                logits_ratio=ratio_l, cache_ratio=ratio_c, ok=ok)
            msg = (f"logits relative L2 up to {rec[dtype]['logits_rel']:.2e}"
                   f", {ratio_l:.3f} of the CPU's own bf16 distance (cache "
                   f"{ratio_c:.3f}); limit 2")
        print(f"[lm] smoke {arch} {dtype}: card vs CPU, prefill + {steps} "
              f"decode steps: {msg}")
        if not ok:
            raise AssertionError(f"[lm] smoke {arch} {dtype}: card and CPU "
                                 f"disagree: {msg}")
    return rec


def _lm_witness(seed, out: Path, batch=4, seq=32, steps=4):
    """llama3-8b cut to 2 layers at full width, parameters drawn with numpy
    from ``seed`` (so the host can draw them again), on the card: the
    prefill's and each greedy decode step's logits, with the tokens, to
    ``out/witness_lm_llama3-8b.npz`` for ``lm_witness.py``."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models.params import numpy_params
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    t0 = time.perf_counter()
    b = concrete_batch(cfg, "prefill", batch, seq, np.random.default_rng(seed),
                       device="cpu")
    res, fed = _lm_trace(cfg, numpy_params(cfg, seed), b,
                         torch.device("cuda"), steps)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "witness_lm_llama3-8b.npz"
    np.savez(path, seed=seed, arch="llama3-8b", n_layers=cfg.n_layers,
             batch=batch, seq=seq, tokens=b["tokens"].numpy(),
             fed=np.stack([t.numpy() for t in fed]),
             prefill_logits=res[0][0],
             decode_logits=np.stack([r[0] for r in res[1:]]))
    torch.cuda.empty_cache()
    print(f"[lm] witness: llama3-8b at 2 layers, full width, seed {seed}: "
          f"{path} ({time.perf_counter() - t0:.1f} s)")
    return str(path)


def phase_lm(seed, out: Path):
    """The LM scaffold's serving path on the card: llama3-8b at full width
    and depth and mamba2-780m at full size (prefill 64 x 32, 16 greedy
    decode steps, prefill against decode), llama3-8b's f32 copy cut to 2
    layers (prefill against decode within 1e-3), the witness, every arch's
    smoke config against the CPU, and the launcher's lm mode in process."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config, list_archs
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    rec = {}
    llama = get_config("llama3-8b")
    rec["llama3-8b"] = _lm_full("llama3-8b", llama, seed, 64, 32, 16,
                                probe=True)
    rec["llama3-8b_f32_2layers"] = _lm_full(
        "llama3-8b f32, 2 layers",
        dataclasses.replace(llama, n_layers=2, dtype="float32"), seed, 64,
        32, 2)
    rec["mamba2-780m"] = _lm_full("mamba2-780m", get_config("mamba2-780m"),
                                  seed, 64, 32, 16, probe=True)
    rec["witness"] = _lm_witness(seed, out)
    rec["smoke"] = {arch: _lm_smoke(arch, seed) for arch in list_archs()}
    t0 = time.perf_counter()
    toks = serve.main(["--mode", "lm", "--arch", "llama3-8b"])
    if toks.shape != (64, 17) or not ((toks >= 0)
                                      & (toks < llama.vocab_size)).all():
        raise AssertionError(f"[lm] launcher: tokens {toks.shape}")
    rec["launcher"] = dict(shape=list(toks.shape),
                           wall_s=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"[lm] launcher --mode lm --arch llama3-8b (smoke config): tokens "
          f"{toks.shape}; phase done in {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------- train
#: the train phase's tolerances.  Card against CPU in f32 (TF32 off): the
#: loss within 1e-5 and each gradient leaf within 1e-4·max(1, max |g|) (the
#: devices sum in other orders, and the card's scatter-adds are unordered).
#: After one AdamW step the parameters: the first step moves an element by
#: lr·g/(|g| + 1e-8), whose slope near |g| ~ 1e-8 is 1e8/4, so a gradient
#: that differs between the devices by 1e-9 there moves its parameter by
#: up to 0.1·lr more on one of them.  Every parameter within 2·lr, and
#: every one that differs by more than 1e-5 must have a (clipped) gradient
#: within 1e-6 of 0.  The full-width gradient check: the central
#: difference of the f32 loss at ε = 1e-4 along a seeded N(0, 1) direction
#: against ⟨∇L, v⟩ within relative 1e-2 (the f32 loss's rounding is about
#: 1e-6, a few 1e-3 of the quotient's signal; the curvature term is O(ε²)).
TRAIN_GRAD_TOL = 1e-4
TRAIN_STEP_LR = 1e-2
TRAIN_FD_EPS = 1e-4
TRAIN_FD_REL = 1e-2
#: the launcher's schedule (--lr 3e-3 --warmup 10, total max(steps, 100))
TRAIN_SCHEDULE = dict(base_lr=3e-3, warmup=10, total=100)


def _train_bound(cfg, n_params, emb_numel, tokens, batch, seq, opt_bytes):
    """(ms, by): the larger of the step's products at the bf16 dense peak
    (6 × matmul parameters × tokens, plus the attention's 12·L·B·S²·d; an
    untied embedding table is gathered, not multiplied) and the
    optimizer's bytes at the HBM rate.  Remat's recompute is not counted."""
    mm = n_params - (0 if cfg.tie_embeddings else emb_numel)
    layers = {"dense": cfg.n_layers, "moe": cfg.n_layers,
              "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}.get(
        cfg.family, 0)
    d_attn = cfg.n_heads * cfg.resolved_head_dim
    flops = 6.0 * mm * tokens + 12.0 * layers * batch * seq ** 2 * d_attn
    return _bound(opt_bytes, flops, BF16_FLOPS) + (flops,)


def _train_full(label, cfg, seed, batch, seq, steps, micro=1,
                keep_state=False):
    """One model trained on the card: its state drawn there from ``seed``
    (``init_train_state``), ``steps`` steps of ``build_train_step`` with
    the launcher's schedule on the launcher's token stream, ``micro``
    micro-batches of ``batch`` sequences each.  Prints each number beside
    its bound; loss and gradient norm must be finite and > 0."""
    import torch
    from repro_torch.data.tokens import SyntheticTokenStream, TokenStreamConfig
    from repro_torch.models.lm import Model
    from repro_torch.models.params import count_params
    from repro_torch.training.optim import cosine_schedule
    from repro_torch.training.train_step import (build_train_step,
                                                 init_train_state)
    from repro_torch.training.tree import leaves
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    params, opt = state["params"], state["opt"]
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != count_params(cfg):
        raise AssertionError(f"[train] {label}: {n_params} parameters, the "
                             f"spec {count_params(cfg)}")
    nbytes = lambda tree: sum(t.numel() * t.element_size()  # noqa: E731
                              for t in leaves(tree))
    p_bytes, mv_bytes = nbytes(params), nbytes(opt["m"]) + nbytes(opt["v"])
    g_bytes = p_bytes if micro == 1 else 4 * n_params
    tokens = batch * micro * seq
    bound_ms, bound_by, flops = _train_bound(
        cfg, n_params, params["embed"].numel(), tokens, batch * micro, seq,
        2 * p_bytes + g_bytes + 2 * mv_bytes)
    step_fn = build_train_step(
        model, lr_schedule=functools.partial(cosine_schedule,
                                             **TRAIN_SCHEDULE),
        micro_batches=micro)
    stream = SyntheticTokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch * micro,
        seed=seed))
    print(f"[train] {label}: {n_params:,} parameters, {p_bytes / 1e9:.3f} GB "
          f"of parameters, state {(p_bytes + mv_bytes) / 1e9:.3f} GB "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}, "
          f"moments {cfg.opt_dtype}, remat {cfg.remat}, remat_group "
          f"{cfg.remat_group}); init {init_ms:.1f} ms")
    recs = []
    for i in range(steps):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in stream.batch_at(i).items()}
        if micro > 1:
            b = {k: v.reshape(micro, batch, seq) for k, v in b.items()}
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        state, m = step_fn(state, b)
        e1.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        r = dict(ms=wall, event_ms=e0.elapsed_time(e1), loss=float(m["loss"]),
                 grad_norm=float(m["grad_norm"]), lr=float(m["lr"]))
        recs.append(r)
        print(f"[train] {label}: step {i}: {r['event_ms']:.1f} ms (CUDA "
              f"events), {wall:.1f} ms (host clock, synchronised); loss "
              f"{r['loss']:.4f}, gradient norm {r['grad_norm']:.4f}, lr "
              f"{r['lr']:.3g}")
        if not (np.isfinite([r["loss"], r["grad_norm"]]).all()
                and r["loss"] > 0 and r["grad_norm"] > 0):
            raise AssertionError(f"[train] {label}: step {i}: loss "
                                 f"{r['loss']}, gradient norm "
                                 f"{r['grad_norm']}")
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    steady = recs[1:] or recs
    step_ms = float(np.mean([r["ms"] for r in steady]))
    rec = dict(arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
               batch=batch, micro_batches=micro, seq=seq, steps=recs,
               params=n_params, param_bytes=p_bytes,
               state_bytes=p_bytes + mv_bytes, init_ms=init_ms,
               step_ms=step_ms, tok_s=tokens / step_ms * 1e3,
               bound_ms=bound_ms, bound_by=bound_by, flops=flops,
               share_of_bound=bound_ms / step_ms, peak_bytes=peak,
               held_bytes=held, card_bytes=card)
    print(f"[train] {label}: {step_ms:.1f} ms per step after the first "
          f"({tokens} tokens: {rec['tok_s']:.1f} tok/s); bound "
          f"{bound_ms:.1f} ms, by {bound_by} ({flops:.3e} flops at bf16 "
          f"dense): {rec['share_of_bound']:.3f} of the bound")
    print(f"[train] {label}: peak memory {peak / 1e9:.3f} GB of the card's "
          f"{card / 1e9:.3f} GB ({held / 1e9:.3f} held before)")
    if keep_state:
        return rec, state
    del state, params, opt, m, model, step_fn
    torch.cuda.empty_cache()
    return rec


def _train_checkpoint(state, tmp: Path, step: int):
    """A full-size train state through ``CheckpointManager``: an async save
    (the blocking device-to-host part and the background write timed
    apart), then a restore onto the card that must be bit-equal."""
    import torch
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.training.tree import leaves
    shutil.rmtree(tmp, ignore_errors=True)
    ckpt = CheckpointManager(str(tmp))
    t0 = time.perf_counter()
    ckpt.save(step, state)
    blocking_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ckpt.wait()
    write_s = time.perf_counter() - t0
    nbytes = ckpt._path(step).stat().st_size
    t0 = time.perf_counter()
    back = ckpt.restore(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    equal = all(a.dtype == b.dtype and a.device == b.device
                and torch.equal(a, b)
                for a, b in zip(leaves(state), leaves(back)))
    del back
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    rec = dict(bytes=nbytes, blocking_ms=blocking_ms, write_s=write_s,
               restore_s=restore_s, bit_equal=equal)
    print(f"[train] checkpoint: {nbytes / 1e9:.3f} GB; save blocks "
          f"{blocking_ms:.1f} ms (device-to-host copy), writes in "
          f"{write_s:.2f} s; restore onto the card {restore_s:.2f} s; "
          f"bit-equal {equal}")
    if not equal:
        raise AssertionError("[train] checkpoint: the restored state differs")
    return rec


def _train_cut(seed, out: Path, batch=2, seq=512):
    """qwen1.5-4b's f32 copy cut to 2 layers at full width, parameters drawn
    with numpy from ``seed``: loss and gradients on the card, the gradient
    check along a seeded direction, and the witness for ``lm_witness.py``
    (per-leaf gradient norms and fixed slices, then the loss after one
    clipped AdamW step at lr 1e-3 on fresh moments)."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import Model
    from repro_torch.models.params import numpy_params, params_from_reference
    from repro_torch.training.optim import (adamw_init, adamw_update,
                                            clip_by_global_norm, global_norm)
    from repro_torch.training.tree import (leaves, leaves_with_path,
                                           path_key, unflatten_like)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=2,
                              dtype="float32")
    model = Model(cfg, device=dev)
    params = params_from_reference(numpy_params(cfg, seed), cfg, dev)
    rng = np.random.default_rng(seed)
    host = {k: rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
            for k in ("tokens", "labels")}
    b = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    names = [path_key(p) for p, _ in leaves_with_path(params)]
    ps = leaves(params)
    req = [p.detach().requires_grad_() for p in ps]
    loss, _ = model.loss(unflatten_like(params, req), b)
    grads = list(torch.autograd.grad(loss, req))
    loss = float(loss.detach())
    del req
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        vs = [torch.randn(p.shape, generator=gen, device=dev) for p in ps]
        dd = float(sum(torch.sum(g.double() * v.double())
                       for g, v in zip(grads, vs)))
        lp, lm = (float(model.loss(unflatten_like(
            params, [p + sgn * TRAIN_FD_EPS * v for p, v in zip(ps, vs)]),
            b)[0]) for sgn in (1.0, -1.0))
    del vs
    fd = (lp - lm) / (2 * TRAIN_FD_EPS)
    rel = abs(fd - dd) / abs(dd)
    gtree = unflatten_like(params, grads)
    gnorm = float(global_norm(gtree))
    leaf_norms = np.array([float(torch.linalg.vector_norm(g.double()))
                           for g in grads])
    idx = np.stack([np.linspace(0, g.numel() - 1, 256).astype(np.int64)
                    for g in grads])
    slices = np.stack([g.reshape(-1)[torch.as_tensor(i, device=dev)]
                       .cpu().numpy() for g, i in zip(grads, idx)])
    lr = 1e-3
    with torch.no_grad():
        clipped, _ = clip_by_global_norm(gtree, 1.0)
        del gtree, grads
        adamw_update(params, clipped, adamw_init(params),
                     torch.tensor(lr, device=dev))
        del clipped
        post = float(model.loss(params, b)[0])
    out.mkdir(parents=True, exist_ok=True)
    path = out / "witness_train_qwen1.5-4b.npz"
    np.savez(path, kind="train", seed=seed, arch="qwen1.5-4b",
             n_layers=cfg.n_layers, tokens=host["tokens"],
             labels=host["labels"], loss=loss, grad_norm=gnorm,
             leaf_names=np.array(names), leaf_norms=leaf_norms,
             slice_idx=idx, slices=slices, lr=lr, post_step_loss=post,
             fd=fd, directional=dd)
    del params, ps, model, b
    torch.cuda.empty_cache()
    rec = dict(loss=loss, grad_norm=gnorm, directional=dd, central_diff=fd,
               fd_rel=rel, eps=TRAIN_FD_EPS, post_step_loss=post,
               witness=str(path), wall_s=time.perf_counter() - t_start)
    print(f"[train] gradient check, qwen1.5-4b f32 at 2 layers, full width, "
          f"{batch} x {seq} tokens: <grad L, v> {dd:.6f}, central difference "
          f"{fd:.6f} (eps {TRAIN_FD_EPS}): relative {rel:.3e} (limit "
          f"{TRAIN_FD_REL}); loss {loss:.6f}, gradient norm {gnorm:.6f}, "
          f"after one AdamW step {post:.6f}; witness {path}")
    if not (np.isfinite([loss, gnorm, post]).all() and rel <= TRAIN_FD_REL):
        raise AssertionError(f"[train] gradient check failed: relative "
                             f"{rel:.3e}")
    return rec


def _train_smoke(arch, seed):
    """``arch``'s smoke config in f32: loss and gradients on the card
    against the same port code on the CPU (same parameters, numpy from
    ``seed``, and batch), then one train step (AdamW at lr 1e-2) on each."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models.lm import Model
    from repro_torch.models.params import numpy_params, params_from_reference
    from repro_torch.training.optim import adamw_init, cosine_schedule
    from repro_torch.training.train_step import build_train_step
    from repro_torch.training.tree import (leaves, leaves_with_path,
                                           path_key, unflatten_like)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    flat = list(numpy_params(cfg, seed))
    batch = concrete_batch(cfg, "train", 2, 32, np.random.default_rng(seed),
                           device="cpu")
    runs = []                               # the CPU's run, then the card's
    for dev in (torch.device("cpu"), torch.device("cuda")):
        model = Model(cfg, device=dev)
        params = params_from_reference(flat, cfg, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        ps = leaves(params)
        req = [p.detach().requires_grad_() for p in ps]
        loss, _ = model.loss(unflatten_like(params, req), b)
        grads = torch.autograd.grad(loss, req)
        step = build_train_step(model, lr_schedule=functools.partial(
            cosine_schedule, base_lr=TRAIN_STEP_LR, warmup=0, total=100))
        st, m = step({"params": params, "opt": adamw_init(params)}, b)
        runs.append(dict(
            loss=float(loss.detach()),
            grads={path_key(p): _host(g) for (p, _), g in
                   zip(leaves_with_path(params), grads)},
            metrics={k: float(v) for k, v in m.items()},
            after={n: {path_key(p): _host(t) for p, t in
                       leaves_with_path(tree)}
                   for n, tree in (("params", st["params"]),
                                   ("m", st["opt"]["m"]),
                                   ("v", st["opt"]["v"]))}))
    c, g = runs
    err_loss = abs(g["loss"] - c["loss"])
    err_g = max(float(np.max(np.abs(g["grads"][k] - c["grads"][k])))
                / max(1.0, float(np.max(np.abs(c["grads"][k]))))
                for k in c["grads"])
    err_m = max(abs(g["metrics"][k] - c["metrics"][k])
                / max(1.0, abs(c["metrics"][k]))
                for k in ("loss", "aux", "grad_norm", "lr"))
    err_mv = max(float(np.max(np.abs(g["after"][n][k] - c["after"][n][k])))
                 / max(1.0, float(np.max(np.abs(c["after"][n][k]))))
                 for n in ("m", "v") for k in c["after"][n])
    scale = min(1.0, 1.0 / c["metrics"]["grad_norm"])     # the clip
    d = {k: np.abs(g["after"]["params"][k] - c["after"]["params"][k])
         for k in c["after"]["params"]}
    far = sum(int((x > 1e-5).sum()) for x in d.values())
    far_large_g = sum(int(((x > 1e-5)
                           & (np.abs(c["grads"][k]) * scale >= 1e-6)).sum())
                      for k, x in d.items())
    err_p = max(float(x.max()) for x in d.values())
    ok = (err_loss <= 1e-5 and err_g <= TRAIN_GRAD_TOL
          and err_m <= TRAIN_GRAD_TOL and err_mv <= TRAIN_GRAD_TOL
          and far_large_g == 0 and err_p <= 2 * TRAIN_STEP_LR)
    msg = (f"loss {err_loss:.2e}, gradients {err_g:.2e} of max(1, |g|), step "
           f"metrics {err_m:.2e}, moments {err_mv:.2e}; parameters after "
           f"the step max {err_p:.2e}, {far} past 1e-5, {far_large_g} of "
           f"them with |g| >= 1e-6")
    print(f"[train] smoke {arch} float32: card vs CPU: {msg}")
    if not ok:
        raise AssertionError(f"[train] smoke {arch}: card and CPU disagree: "
                             f"{msg}")
    return dict(loss=err_loss, grads=err_g, metrics=err_m, moments=err_mv,
                params_max=err_p, params_far=far, ok=ok)


def _train_launcher(tmp: Path):
    """The launcher's own cases on the card: the reference's "loss
    decreases" (qwen1.5-4b smoke, 30 steps, batch 4, seq 64) and its
    resume (mamba2-780m smoke, 8 steps against 4 + 4 through a
    checkpoint, losses within rtol 1e-4)."""
    from repro_torch.launch import train
    t0 = time.perf_counter()
    _, losses = train.main(["--arch", "qwen1.5-4b", "--steps", "30",
                            "--batch", "4", "--seq", "64",
                            "--log-every", "10"])
    if not losses[-1] < losses[0] - 0.1:
        raise AssertionError(f"[train] launcher: loss {losses[0]} -> "
                             f"{losses[-1]} did not fall by 0.1")
    base = ["--arch", "mamba2-780m", "--batch", "2", "--seq", "32",
            "--log-every", "1000"]
    _, full = train.main(base + ["--steps", "8"])
    d = str(tmp / "resume")
    shutil.rmtree(d, ignore_errors=True)
    train.main(base + ["--steps", "4", "--ckpt-dir", d, "--ckpt-every",
                       "100"])
    _, resumed = train.main(base + ["--steps", "8", "--ckpt-dir", d,
                                    "--resume"])
    shutil.rmtree(d, ignore_errors=True)
    err = float(np.max(np.abs(np.array(full[4:]) - resumed)
                       / np.abs(full[4:])))
    print(f"[train] launcher on the card: qwen1.5-4b smoke loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} over 30 steps; mamba2-780m "
          f"resume after 4 of 8 steps: losses within relative {err:.2e} "
          f"(limit 1e-4); {time.perf_counter() - t0:.1f} s")
    if not np.allclose(full[4:], resumed, rtol=1e-4):
        raise AssertionError(f"[train] launcher resume: {full[4:]} against "
                             f"{resumed}")
    return dict(loss_first=losses[0], loss_last=losses[-1], resume_rel=err)


def phase_train(seed, out: Path, tmp: Path):
    """The LM scaffold's training half on the card: qwen1.5-4b at full width
    and depth (seq 4096, batch 2) and mamba2-780m at full size (seq 4096,
    4 micro-batches of 2), 3 steps each; mamba2-780m's state through a
    checkpoint; the full-width gradient check and witness; every smoke
    config's loss, gradients and one step against the CPU; the launcher's
    own cases."""
    from repro_torch.configs.registry import get_config, list_archs
    t_phase = time.perf_counter()
    rec = {}
    rec["qwen1.5-4b"] = _train_full("qwen1.5-4b", get_config("qwen1.5-4b"),
                                    seed, 2, 4096, 3)
    rec["mamba2-780m"], state = _train_full(
        "mamba2-780m", get_config("mamba2-780m"), seed, 2, 4096, 3, micro=4,
        keep_state=True)
    rec["checkpoint"] = _train_checkpoint(state, tmp / "ckpt", 3)
    del state
    rec["cut"] = _train_cut(seed, out)
    rec["smoke"] = {arch: _train_smoke(arch, seed) for arch in list_archs()}
    rec["launcher"] = _train_launcher(tmp)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"[train] phase done in {rec['wall_s']:.1f} s")
    return rec


#: the shard phase: qwen1.5-4b's ZeRO-3 (FSDP-strategy) step at S shards,
#: every shard on the first card.  A global batch of 8 × 1024 tokens (the
#: train phase's 8,192 tokens; the batch divides by 8); the loss in slices
#: of 256 positions, so the f32 logits of one slice, (8, 256, vocab), are
#: the train phase's (2, 1024, vocab) in size.
SHARD_MESHES = {2: {"data": 2}, 8: {"data": 4, "model": 2}}
SHARD_BATCH, SHARD_SEQ = 8, 1024
SHARD_OPTS = {"ce_chunk": 256}
#: a constant rate, so that the compared step moves every parameter (the
#: launcher's schedule starts at 0)
SHARD_LR = 1e-4
#: evenly spaced elements of each parameter leaf compared after a step
SHARD_SLICE = 4096
#: a few f32 units of relative distance: the floor of a limit that is twice
#: the micro-batch step's distance to the unsharded step, and the limit of
#: the sharded step's distance to its micro-batch step
SHARD_FLOOR = 2.0 ** -20


def _slices(tree):
    """Each leaf's SHARD_SLICE evenly spaced elements, f32 on the host."""
    import torch
    from repro_torch.training.tree import leaves_with_path, path_key
    out = {}
    for p, t in leaves_with_path(tree):
        idx = (torch.arange(SHARD_SLICE, device=t.device)
               * (t.numel() - 1)) // (SHARD_SLICE - 1)
        out[path_key(p)] = t.reshape(-1)[idx].float().cpu().numpy()
    return out


def _shard_step(label, make_state, step, batch, params_of, reps=2):
    """``reps`` steps, each on a state drawn again by ``make_state`` (a step
    updates its state in place); the last one's metrics, post-step
    parameter slices, CUDA-event and host ms, peak memory and collective
    counts."""
    import torch
    from repro_torch.parallel.sharding import CollectiveCounter
    from repro_torch.training.tree import leaves
    for rep in range(reps):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = make_state()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        with CollectiveCounter() as cc:
            t0 = time.perf_counter()
            e0.record()
            state, m = step(state, batch)
            e1.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        rec = dict(ms=wall, event_ms=e0.elapsed_time(e1), peak_bytes=peak,
                   loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   collectives=cc.as_dict(), calls=dict(cc.calls))
        kind = "timed" if rep == reps - 1 else "warm-up"
        print(f"[shard] {label}: step {rep} ({kind}): "
              f"{rec['event_ms']:.1f} ms (CUDA events), {wall:.1f} ms (host "
              f"clock); loss {rec['loss']:.6f}, gradient norm "
              f"{rec['grad_norm']:.6f}; peak {peak / 1e9:.3f} GB")
        if not np.isfinite([rec["loss"], rec["grad_norm"]]).all():
            raise AssertionError(f"[shard] {label}: loss {rec['loss']}, "
                                 f"gradient norm {rec['grad_norm']}")
        if rep == reps - 1:
            rec["slices"] = _slices(params_of(state))
            rec["shard0_param_bytes"] = (
                sum(t.numel() * t.element_size()
                    for t in leaves(state[0]["params"]))
                if isinstance(state, list) else None)
        del state, m
    torch.cuda.empty_cache()
    return rec


def _rel_to(a, b, pre) -> float:
    """||a - b|| over the slices, relative to b's move from ``pre``."""
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in b)
    den = sum(float(np.sum((b[k].astype(np.float64) - pre[k]) ** 2))
              for k in b)
    return (num / max(den, 1e-300)) ** 0.5


def _shard_cut(seed, dev):
    """qwen1.5-4b's f32 copy cut to 2 layers at full width (numpy
    parameters from ``seed``): the sharded step at S = 8 against the
    unsharded step, loss within 1e-5 and each gradient leaf and each
    post-step moment leaf within 1e-4 · max(1, max |g|) (the train phase's
    card-vs-CPU rule); and its post-step parameters and moments equal to
    the unsharded micro_batches=8 step's, block by block, within
    SHARD_FLOOR · max(1, max |x|) (each shard runs that step's shapes and
    sums in its order; a wrong learning rate or a skipped leaf on an owner
    moves a block by far more)."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import Model
    from repro_torch.models.params import numpy_params, params_from_reference
    from repro_torch.parallel.fsdp import (StateLayout,
                                           build_sharded_train_step,
                                           shard_state)
    from repro_torch.parallel.sharding import (FSDP_RULES, make_act_sharder,
                                               make_mesh)
    from repro_torch.training.optim import adamw_init
    from repro_torch.training.train_step import build_train_step
    from repro_torch.training.tree import leaves_with_path, path_key
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=2,
                              dtype="float32")
    mesh = make_mesh(SHARD_MESHES[8], [dev])
    rng = np.random.default_rng(seed)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                             (SHARD_BATCH, 256)),
                                dtype=torch.int32, device=dev)
             for k in ("tokens", "labels")}
    sched = lambda step: torch.tensor(SHARD_LR, device=dev)  # noqa: E731

    drawn = dict(numpy_params(cfg, seed))   # drawn once, copied per step

    def fresh():
        p = params_from_reference(drawn, cfg, dev)
        return {"params": p, "opt": adamw_init(p, cfg.opt_dtype)}

    grads0 = {}

    def keep(g):
        grads0.update({path_key(p): t.float() for p, t in
                       leaves_with_path(g)})
        return g
    model = Model(cfg, device=dev, opts=SHARD_OPTS)
    s0, m0 = build_train_step(model, lr_schedule=sched,
                              grad_transform=keep)(fresh(), batch)
    moments0 = {k: s0["opt"][k] for k in ("m", "v")}
    del s0
    mb, _ = build_train_step(model, lr_schedule=sched, micro_batches=8)(
        fresh(), {k: v.reshape(8, SHARD_BATCH // 8, -1)
                  for k, v in batch.items()})
    smodel = Model(cfg, device=dev, opts=SHARD_OPTS,
                   act_shard=make_act_sharder(mesh, FSDP_RULES))
    lay = StateLayout(smodel, mesh)
    shards = shard_state(fresh(), smodel, mesh)
    shards, m1 = build_sharded_train_step(smodel, mesh, lr_schedule=sched,
                                          keep_grads=True)(shards, batch)
    g1 = {path_key(p): t for p, t in leaves_with_path(
        lay.unshard_tree(m1.pop("grads")))}
    dl = abs(float(m1["loss"]) - float(m0["loss"]))
    worst = max(float((g1[k] - g).abs().max()) / max(1.0, float(
        g.abs().max())) for k, g in grads0.items())
    gmax = {k: max(1.0, float(g.abs().max())) for k, g in grads0.items()}
    del grads0, g1

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree
    worst_mom, worst_mb = 0.0, 0.0          # of the unsharded, of micro 8
    for path, pl in lay.params.items():
        key = "/".join(path)
        for i, s in enumerate(mesh.present):
            blk = lay.block(pl, s)
            for tree, ref, ref_mb in (
                    (shards[i]["params"], None, mb["params"]),
                    (shards[i]["opt"]["m"], moments0["m"], mb["opt"]["m"]),
                    (shards[i]["opt"]["v"], moments0["v"], mb["opt"]["v"])):
                a = get(tree, path).float()
                if ref is not None:
                    worst_mom = max(worst_mom, float(
                        (a - get(ref, path)[blk].float()).abs().max())
                        / gmax[key])
                b = get(ref_mb, path)[blk].float()
                worst_mb = max(worst_mb, float((a - b).abs().max())
                               / max(1.0, float(b.abs().max())))
    del shards, mb, moments0, drawn
    torch.cuda.empty_cache()
    print(f"[shard] 2-layer f32 copy at full width, {SHARD_BATCH} x 256 "
          f"tokens, S = 8: loss {float(m1['loss']):.6f} against "
          f"{float(m0['loss']):.6f} unsharded (|d| {dl:.2e}, limit 1e-5); "
          f"gradients within {worst:.2e} of max(1, |g|) and post-step "
          f"moments within {worst_mom:.2e} (limit {TRAIN_GRAD_TOL}); "
          f"post-step parameters and moments within {worst_mb:.2e} of "
          f"max(1, |x|) of the micro_batches=8 step's (limit "
          f"{SHARD_FLOOR:.2e}); {time.perf_counter() - t0:.1f} s")
    if not (dl <= 1e-5 and worst <= TRAIN_GRAD_TOL
            and worst_mom <= TRAIN_GRAD_TOL and worst_mb <= SHARD_FLOOR):
        raise AssertionError("[shard] the 2-layer f32 sharded step differs "
                             "from the unsharded steps")
    return dict(loss_diff=dl, grad_rel=worst, moment_rel=worst_mom,
                micro8_rel=worst_mb)


def phase_shard(seed, out: Path):
    """qwen1.5-4b's ZeRO-3 (FSDP-strategy) train step at S = 2 (data 2) and
    S = 8 (data 4 × model 2) shards, all on the first card, at full width
    and depth against its unsharded step and its micro-batch steps; the
    2-layer f32 check; the dry-run's count of the S = 8 step's share
    against the card's."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import SyntheticTokenStream, TokenStreamConfig
    from repro_torch.models.lm import Model
    from repro_torch.models.params import count_params
    from repro_torch.parallel.fsdp import (StateLayout,
                                           build_sharded_train_step,
                                           init_sharded_state)
    from repro_torch.parallel.sharding import (FSDP_RULES, make_act_sharder,
                                               make_mesh)
    from repro_torch.training.train_step import (build_train_step,
                                                 init_train_state)
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")
    # the dry-run's count of the S = 8 step's share runs on the host while
    # the card steps
    dry_json = out / "shard_dryrun_s8.json"
    out.mkdir(parents=True, exist_ok=True)
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cfg.name, "--mesh", ",".join(f"{k}={v}" for k, v in
                                      SHARD_MESHES[8].items()),
         "--batch", str(SHARD_BATCH), "--seq", str(SHARD_SEQ),
         "--opt", f"ce_chunk={SHARD_OPTS['ce_chunk']}", "--json",
         str(dry_json)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 SyntheticTokenStream(TokenStreamConfig(
                     vocab_size=cfg.vocab_size, seq_len=SHARD_SEQ,
                     global_batch=SHARD_BATCH, seed=seed)).batch_at(0).items()}
        sched = lambda step: torch.tensor(SHARD_LR, device=step.device)  # noqa: E731
        gen = lambda: torch.Generator(device=dev).manual_seed(seed)  # noqa: E731
        model = Model(cfg, device=dev, opts=SHARD_OPTS)
        n_params = count_params(cfg)
        pre = _slices(model.init(gen()))
        torch.cuda.empty_cache()
        recs = {}
        recs["unsharded"] = _shard_step(
            "unsharded", lambda: init_train_state(model, gen()),
            build_train_step(model, lr_schedule=sched), batch,
            lambda st: st["params"])
        for S in SHARD_MESHES:
            mb = {k: v.reshape(S, SHARD_BATCH // S, SHARD_SEQ)
                  for k, v in batch.items()}
            recs[f"micro{S}"] = _shard_step(
                f"unsharded, micro_batches={S}",
                lambda: init_train_state(model, gen()),
                build_train_step(model, lr_schedule=sched, micro_batches=S), mb,
                lambda st: st["params"], reps=1)
        layouts = {}
        for S, axes in SHARD_MESHES.items():
            mesh = make_mesh(axes, [dev])
            smodel = Model(cfg, device=dev, opts=SHARD_OPTS,
                           act_shard=make_act_sharder(mesh, FSDP_RULES))
            lay = layouts[S] = StateLayout(smodel, mesh)
            recs[f"S{S}"] = _shard_step(
                f"FSDP S = {S} {axes}",
                lambda: init_sharded_state(smodel, mesh, gen()),
                build_sharded_train_step(smodel, mesh, lr_schedule=sched), batch,
                lambda sh: lay.unshard_tree([s["params"] for s in sh]))
        cut = _shard_cut(seed, dev)

        # what must hold, and the bounds
        u = recs["unsharded"]
        p_bytes = 2 * n_params
        state_bytes = p_bytes + 2 * 4 * n_params
        bound_ms, bound_by, flops = _train_bound(
            cfg, n_params, cfg.vocab_size * cfg.d_model, SHARD_BATCH * SHARD_SEQ,
            SHARD_BATCH, SHARD_SEQ, 2 * p_bytes + p_bytes + 2 * 8 * n_params)
        print(f"[shard] bound of the step {bound_ms:.1f} ms, by {bound_by} "
              f"({flops:.3e} flops at bf16 dense); the floor of resident memory "
              f"(parameters, moments, gradients): {(state_bytes + p_bytes) / 1e9:.3f} GB "
              f"(bf16 gradients), {(state_bytes + 4 * n_params) / 1e9:.3f} GB "
              f"(f32: the micro-batch accumulator, the shards' gradient blocks)")
        checks = {}
        for S in SHARD_MESHES:
            r, mref = recs[f"S{S}"], recs[f"micro{S}"]
            c = {}
            for key in ("loss", "grad_norm"):
                d_ref = abs(mref[key] - u[key]) / abs(u[key])
                d = abs(r[key] - u[key]) / abs(u[key])
                c[key] = (d, d_ref, 2 * max(d_ref, SHARD_FLOOR))
            d_ref = _rel_to(mref["slices"], u["slices"], pre)
            d = _rel_to(r["slices"], u["slices"], pre)
            c["params"] = (d, d_ref, 2 * max(d_ref, SHARD_FLOOR))
            checks[S] = c
            lay = layouts[S]
            per_dev = sum(int(np.prod([b.stop - b.start for b in lay.block(pl, 0)]))
                          * 2 for pl in lay.params.values())
            coll = r["collectives"]
            print(f"[shard] S = {S}: {r['ms']:.1f} ms per step (host clock; "
                  f"{r['event_ms']:.1f} ms CUDA events) against the unsharded "
                  f"{u['ms']:.1f} ms and the bound {bound_ms:.1f} ms: "
                  f"{bound_ms / r['ms']:.3f} of the bound; peak "
                  f"{r['peak_bytes'] / 1e9:.3f} GB (unsharded "
                  f"{u['peak_bytes'] / 1e9:.3f} GB)")
            print(f"[shard] S = {S}: per device, all-gather "
                  f"{coll['all-gather'] / 1e9:.4f} GB against the per-device "
                  f"parameter bytes {per_dev / 1e9:.4f} GB (every leaf gathered "
                  f"once; remat's recompute gathers each group again): "
                  f"{coll['all-gather'] / per_dev:.3f}x; reduce-scatter "
                  f"{coll['reduce-scatter'] / 1e9:.4f} GB against the bf16 "
                  f"gradient of every split leaf {p_bytes / 1e9:.4f} GB; "
                  f"all-reduce {coll['all-reduce']} B; calls {r['calls']}")
            for key, (d, d_ref, lim) in c.items():
                print(f"[shard] S = {S}: {key} {d:.3e} from the unsharded step "
                      f"(relative), whose micro_batches={S} step is {d_ref:.3e} "
                      f"from it: limit {lim:.3e}")
                if not d <= lim:
                    raise AssertionError(f"[shard] S = {S}: {key} {d:.3e} "
                                         f"beyond {lim:.3e}")
            # each shard runs the micro step's shapes and the f32
            # reduce-scatter is its accumulator: the two steps must agree
            # at an f32 floor (a wrong rate or a skipped leaf on an owner
            # moves the post-step slices by far more)
            c["vs_micro"] = {
                key: abs(r[key] - mref[key]) / abs(mref[key])
                for key in ("loss", "grad_norm")}
            c["vs_micro"]["params"] = _rel_to(r["slices"], mref["slices"], pre)
            for key, d in c["vs_micro"].items():
                print(f"[shard] S = {S}: {key} {d:.3e} from its "
                      f"micro_batches={S} step (relative; the parameters' "
                      f"to that step's move): limit {SHARD_FLOOR:.3e}")
                if not d <= SHARD_FLOOR:
                    raise AssertionError(f"[shard] S = {S}: {key} {d:.3e} "
                                         f"from the micro_batches={S} step, "
                                         f"beyond {SHARD_FLOOR:.3e}")
        # the dry-run's share of the S = 8 step against the card's
        log, _ = dry.communicate(timeout=600)
        if dry.returncode != 0:
            raise AssertionError(f"[shard] the dry-run count failed:\n{log}")
        got = json.loads(dry_json.read_text())
        card = recs["S8"]
        print(f"[shard] dry-run share of S = 8 on fakes ({got['seconds']:.1f} s "
              f"on the host): collectives {got['collectives']}, parameters "
              f"{got['param_bytes']} B per device; the card's step: "
              f"{card['collectives']}, shard 0's blocks "
              f"{card['shard0_param_bytes']} B")
        if got["collectives"] != card["collectives"] or \
                got["param_bytes"] != card["shard0_param_bytes"]:
            raise AssertionError("[shard] the dry-run's count differs from the "
                                 "card's step")
    finally:                        # the host count never outlives the phase
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    wall = time.perf_counter() - t_phase
    for r in recs.values():
        r.pop("slices", None)
    print(f"[shard] phase done in {wall:.1f} s")
    return dict(recs=recs, checks={str(k): v for k, v in checks.items()},
                cut=cut, dryrun=got, bound_ms=bound_ms, wall_s=wall)


def train_device_time(rec, seed):
    """One step of ``rec``'s model (its arch, batch, micro-batches and seq)
    under torch.profiler, after the other device-time readings have freed
    their models: the state is drawn again here, then freed."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import SyntheticTokenStream, TokenStreamConfig
    from repro_torch.models.lm import Model
    from repro_torch.training.optim import cosine_schedule
    from repro_torch.training.train_step import (build_train_step,
                                                 init_train_state)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    label, micro, batch, seq = (rec["arch"], rec["micro_batches"],
                                rec["batch"], rec["seq"])
    cfg = get_config(label)
    model = Model(cfg, device=dev)
    box = {"state": init_train_state(
        model, torch.Generator(device=dev).manual_seed(seed))}
    step_fn = build_train_step(model, lr_schedule=functools.partial(
        cosine_schedule, **TRAIN_SCHEDULE), micro_batches=micro)
    b = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticTokenStream(
        TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch * micro, seed=seed)
    ).batch_at(0).items()}
    if micro > 1:
        b = {k: v.reshape(micro, batch, seq) for k, v in b.items()}

    walls = []                  # the warm-up step's, then the profiled's

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box["state"] = step_fn(box["state"], b)[0]
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    dms, launches, kernels = _device_ms(step, calls=1)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    # the idle share of the profiled step alone: its own wall (the
    # profiler's host overhead included) against its device time
    p = dict(wall_ms=walls[-1], warmup_wall_ms=walls[0], device_ms=dms,
             launches_per_call=launches, idle_share=1.0 - dms / walls[-1],
             top_kernels=[dict(name=k, ms=v) for k, v in top])
    rec["probe"] = p
    box.clear()
    torch.cuda.empty_cache()
    print(f"[train] {label}: the profiled step {p['wall_ms']:.1f} ms of "
          f"wall (the unprofiled step before it {walls[0]:.1f} ms; phase "
          f"train's timed steps' mean {rec['step_ms']:.1f} ms), {dms:.1f} ms "
          f"of device time, {launches:g} device launches: idle share "
          f"{p['idle_share']:.3f}; the largest kernels' device ms: "
          + "; ".join(f"{v:.1f} {k[:60]}" for k, v in top))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="full-size corpus rows (d is always 128)")
    ap.add_argument("--nq", type=int, default=1000)
    ap.add_argument("--bench-n", type=int, default=100_000,
                    help="the bench phase's corpus rows (d = 128)")
    ap.add_argument("--bench-nq", type=int, default=1000)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.ann import make_vectors
    from repro_torch.kernels import ops

    t_start = time.perf_counter()
    card = phase_device()
    build_s = phase_build()

    dev = torch.device("cuda")
    n = args.n
    vecs_np = make_vectors(n, 128, seed=args.seed + 2)
    vecs = torch.as_tensor(vecs_np, device=dev)
    n_pad = -(-n // 128) * 128
    x_pad = torch.nn.functional.pad(vecs, (0, 0, 0, n_pad - n))
    rs, gd, gk = phase_parity(x_pad, vecs, n, args.seed)
    qrecs, rr = phase_parity_quant(x_pad, vecs, n, args.seed)
    del vecs, x_pad
    torch.cuda.empty_cache()
    l2 = phase_l2dist(args.seed, args.bench_n)

    phase_exact(args.seed)
    full, held = phase_full(n, args.nq, 64, args.seed, ops)
    torch.cuda.empty_cache()
    scratch = ROOT / "build" / "chip_smoke"
    served = phase_serve(n, scratch / "serve", ops)
    torch.cuda.empty_cache()
    stream = phase_stream(n, scratch / "stream", ops)
    torch.cuda.empty_cache()
    mesh = phase_mesh(held, scratch / "mesh", ops)
    del held
    torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    phase_witness(args.seed + 3, out)
    phase_witness_segtree(out)
    bench = phase_bench(args.bench_n, args.bench_nq, out)
    torch.cuda.empty_cache()
    trained = phase_train(args.seed, out, scratch / "train")
    torch.cuda.empty_cache()
    sharded = phase_shard(args.seed, out)
    torch.cuda.empty_cache()
    lm = phase_lm(args.seed, out)
    phase_device_times()
    for name in ("qwen1.5-4b", "mamba2-780m"):
        train_device_time(trained[name], args.seed)
    for name, p in mesh["probes"].items():
        p["idle_share"] = 1.0 - p["device_ms"] / p["wall_ms"]
        print(f"[mesh] {name}: one batch {p['wall_ms']:.3f} ms of wall, "
              f"{p['device_ms']:.3f} ms of device time, "
              f"{p['launches_per_call']:g} device launches: idle share "
              f"{p['idle_share']:.3f}")
    for name in ("llama3-8b", "mamba2-780m"):
        p = lm[name]["probe"]
        p["idle_share"] = 1.0 - p["device_ms"] / p["wall_ms"]
        print(f"[lm] {name}: one decode step {p['wall_ms']:.3f} ms of wall "
              f"(the 16 steps' mean), {p['device_ms']:.3f} ms of device "
              f"time, {p['launches_per_call']:g} device launches: idle share "
              f"{p['idle_share']:.3f}")

    main_rs = next(r for r in rs if r["bucket"] == 8192)
    la = full["launches"]

    def variants(kernel, path, pick):
        """Per-dtype readings of one kernel: its parity timing at the main
        path's shape and its launches on that precision's path."""
        res = {}
        for prec, rec in qrecs[kernel].items():
            r = pick(rec)
            name = _path_name(prec, path)
            res[prec] = dict(
                launches=la[name][f"{kernel}.{prec}"], launches_path=name,
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], shape=r.get("shape"))
            if "device_ms" in r:
                res[prec]["device_ms"] = r["device_ms"]
        return res

    scan_main = lambda rec: dict(
        next(r for r in rec if r["bucket"] == 8192 and r["k"] == 128),
        shape=f"q=64 d_pad=128 bucket=8192 k=128 n={n}")
    rr_main = next(r for r in rr if r["m"] == 128 and r["k"] == 10)
    kern = [
        dict(name="range_scan", route="cuda",
             source="src/repro_torch/csrc/range_scan.cu",
             replaces="src/repro/kernels/range_scan.py:119",
             launches=la["bw1_kernel"]["range_scan.f32"],
             launches_path="bw1_kernel",
             max_abs_err=max(r["max_abs_err"] for r in rs),
             ms=main_rs["ms"], plain_ms=main_rs["plain_ms"],
             bound_ms=main_rs["bound_ms"], bound_by=main_rs["bound_by"],
             library_ms=None, parity_ok=True,
             state="redesigned: one launch for k <= 256 (per-warp "
                   "threshold lists, last-arrival merge)",
             device_ms=main_rs["device_ms"],
             launches_per_call=main_rs["launches_per_call"],
             shape=f"q=64 d_pad=128 bucket=8192 k=10 n={n}",
             variants=variants("range_scan", "bw1_kernel", scan_main)),
        dict(name="gather_dist", route="cuda",
             state="fused into beam_single on the search path",
             source="src/repro_torch/csrc/gather_dist.cu",
             replaces="src/repro/kernels/gather_dist.py:79",
             launches=la["bw1_kernel"]["gather_dist.f32"],
             launches_path="bw1_kernel",
             on_path="the search path scores in beam_single's inner step "
                     "(csrc/beam.cu); this kernel stays as the counterpart "
                     "of repro.kernels.ops.gather_dist",
             max_abs_err=gd["max_abs_err"], ms=gd["ms"],
             plain_ms=gd["plain_ms"], bound_ms=gd["bound_ms"],
             bound_by=gd["bound_by"], library_ms=None, parity_ok=True,
             shape="q=64 m=32 d=128",
             variants=variants("gather_dist", "bw1_kernel",
                               lambda r: dict(r, shape="q=64 m=32 d=128"))),
        dict(name="gather_topk", route="cuda",
             state="fused into beam_batched on the search path",
             source="src/repro_torch/csrc/gather_dist.cu",
             replaces="src/repro/kernels/gather_dist.py:179",
             launches=la["bw4_kernel"]["gather_topk.f32"],
             launches_path="bw4_kernel",
             on_path="the search path ranks its fresh keys in "
                     "beam_batched's inner step (csrc/beam.cu); this kernel "
                     "stays as the counterpart of "
                     "repro.kernels.ops.gather_topk",
             max_abs_err=gk["max_abs_err"], ms=gk["ms"],
             plain_ms=gk["plain_ms"], bound_ms=gk["bound_ms"],
             bound_by=gk["bound_by"], library_ms=None, parity_ok=True,
             shape="q=64 m=128 k=64 d=128",
             variants=variants("gather_topk", "bw4_kernel",
                               lambda r: dict(r,
                                              shape="q=64 m=128 k=64 d=128"))),
        dict(name="gather_rerank", route="cuda",
             state="redesigned: one launch for k <= 256 (per-warp "
                   "threshold lists over gathered rows, ties keyed by id, "
                   "last-arrival merge)",
             source="src/repro_torch/csrc/gather_dist.cu",
             replaces="src/repro/kernels/gather_dist.py:260",
             launches=la["int8_bw1_kernel"]["gather_rerank"],
             launches_path="int8_bw1_kernel",
             launches_by_path={c: cnt["gather_rerank"]
                               for c, cnt in la.items()
                               if cnt["gather_rerank"]},
             max_abs_err=max(r["max_abs_err"] for r in rr),
             ms=rr_main["ms"], plain_ms=rr_main["plain_ms"],
             bound_ms=rr_main["bound_ms"], bound_by=rr_main["bound_by"],
             library_ms=None, parity_ok=True,
             device_ms=rr_main["device_ms"],
             launches_per_call=rr_main["launches_per_call"],
             shape="q=64 m=128 k=10 d=128 (the scan's survivors, "
                   "unsorted)",
             other_shapes=[dict(r, shape=f"q=64 m={r['m']} k={r['k']} d=128")
                           for r in rr if r is not rr_main]),
    ]
    for name, path, line in (("beam_single", "bw1_kernel", 79),
                             ("beam_batched", "bw4_kernel", 179)):
        rec = full["beam"][name]
        main_b = rec["f32"]
        kern.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/beam.cu",
            state="the fused hop loop",
            replaces=f"src/repro/kernels/gather_dist.py:{line}",
            launches=la[path][f"{name}.f32"], launches_path=path,
            graph_partitions=full["dispatches"][path],
            max_abs_err=max(r["max_abs_err"] for r in rec.values()),
            ms=main_b["ms"], plain_ms=main_b["plain_ms"],
            bound_ms=main_b["bound_ms"], bound_by=main_b["bound_by"],
            library_ms=None, parity_ok=True, shape=main_b["shape"],
            per_hop_ms=main_b["per_hop_ms"],
            max_lane_hops=main_b["max_lane_hops"],
            variants={p: dict(r, launches=la[_path_name(p, path)][
                f"{name}.{p}"], launches_path=_path_name(p, path))
                      for p, r in rec.items() if p != "f32"}))
    top = segtree_l2_shapes(args.bench_n)[0]
    l2_main = next(r for r in l2 if r["shape"] == "x".join(map(str, top))
                   and r["dtype"] == "f32")
    kern.append(dict(
        name="l2dist", route="cuda", source="src/repro_torch/csrc/l2dist.cu",
        replaces="src/repro/kernels/l2dist.py:41",
        launches=bench["build_launches"]["segtree"]["l2dist.f32"],
        launches_path="bench_segtree_build",
        max_abs_err=max(r["max_abs_err"] for r in l2 if r["dtype"] == "f32"),
        ms=l2_main["ms"], plain_ms=l2_main["plain_ms"],
        bound_ms=l2_main["bound_ms"], bound_by=l2_main["bound_by"],
        library_ms=l2_main["library_ms"], parity_ok=True,
        state="redesigned: 128 x 128 tiles, 8 x 8 per thread, two d-major "
              "shared-memory stages",
        device_ms=l2_main["device_ms"],
        shape=f"q={top[0]} n={top[1]} d={top[2]} f32 (the segment-tree "
              f"build's top-level tile)",
        other_shapes=[dict(r, shape=f"{r['shape']} {r['dtype']}")
                      for r in l2 if "ms" in r and r is not l2_main]))
    # what the serve and stream phases launched, per kernel and run
    for rec in kern:
        per_run = {f"serve_{run}": {k: v for k, v in r["launches"].items()
                                    if k.split(".")[0] == rec["name"]}
                   for run, r in served["runs"].items()}
        per_run["stream"] = {k: v for k, v in stream["launches"].items()
                             if k.split(".")[0] == rec["name"]}
        rec["serve_launches"] = {run: c for run, c in per_run.items() if c}
        per_path = {path: {k: v for k, v in cnt.items()
                           if k.split(".")[0] == rec["name"]}
                    for path, cnt in mesh["launches"].items()}
        rec["mesh_launches"] = {path: c for path, c in per_path.items() if c}
    kern[0]["delta_scan"] = dict(launches=stream["delta_scan_launches"],
                                 parity=stream["delta_parity"])
    details = dict(card=card, build_seconds=build_s, range_scan=rs,
                   gather_dist=gd, gather_topk=gk, quantized=qrecs,
                   gather_rerank=rr, l2dist=l2, full=full, serve=served,
                   stream=stream, mesh=mesh, bench=bench, lm=lm,
                   train=trained, shard=sharded,
                   wall_seconds=time.perf_counter() - t_start)
    (out / "chip_smoke.json").write_text(json.dumps(details, indent=1,
                                                    default=str))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

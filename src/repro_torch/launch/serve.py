"""Serving launcher of the port: the reference's ``repro.launch.serve`` on
one device.

``--mode rfann`` (the paper's kind): build an RNSG over a synthetic corpus and
drive the dynamic-batching engine with Poisson request arrivals — reports
QPS, recall and latency percentiles.

``--mode lm``: batched LM serving (prefill + greedy decode loop) of
``--arch``'s smoke config, parameters drawn from seed 0; prints the decode
rate and a sample continuation, and ``main`` returns the tokens (batch ×
(1 + ``--new-tokens``)).

  PYTHONPATH=src python -m repro_torch.launch.serve --mode rfann --n 8192 --requests 512
  PYTHONPATH=src python -m repro_torch.launch.serve --mode rfann --device cpu --n 1024 --dim 16 --requests 48
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --device cpu --arch qwen1.5-4b --new-tokens 4

``--device`` (default ``cuda``) is where the index is built and searched,
or the model runs; ``cpu`` runs the kernels' plain PyTorch versions.
``--build-shards S`` routes a fresh static build through the sharded
constructor (``RNSGIndex.build_sharded``) over S slabs placed on
``--device`` (bit-identical output).

``--metrics-path out.prom`` dumps the final metrics snapshot on shutdown:
Prometheus text exposition at the given path plus a JSON sibling
(``out.prom.json``); ``--log-interval S`` turns on the engine's periodic
one-line stats log while serving.

``--index-path DIR`` makes startup stateful: the first run builds the index
and persists it (sharded directory format, ``repro_torch.index.io``,
readable by the reference too) on shutdown; later runs restore it in
seconds instead of rebuilding.

``--wal-dir DIR`` (streaming mode) adds crash durability on top: every
mutation is appended to a checksummed write-ahead log before it is
acknowledged, restart replays the uncompacted tail onto the
``--index-path`` checkpoint, SIGTERM drains gracefully (seal WAL,
checkpoint, persist calibration + metrics), and a WAL write failure
degrades the server to read-only instead of crashing it.

In rfann mode ``main`` returns the run's record: ``recall``, ``qps``,
``served``, ``seconds``, the engine's ``summary``, the served ``ids`` and each
request's routing (``strategy``, the planner's ``SCAN`` / ``BEAM``),
``restored`` (``None`` after a build, else the restore's ``seconds`` and,
streaming, the ``replayed`` WAL records and the live set right after the
replay), with a cache its ``cache`` snapshot, and when streaming the final
live set (``live_ids``, ``live_digest``; see :func:`live_digest`).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np

from repro_torch.core.rfann import RNSGIndex
from repro_torch.data.ann import (ground_truth, make_attrs, make_vectors,
                                  mixed_workload, recall_at_k)
from repro_torch.parallel.sharding import make_mesh
from repro_torch.runtime.fault_tolerance import PreemptionHandler
from repro_torch.serving.engine import RFANNEngine
from repro_torch.streaming import ReadOnlyIndexError


def live_digest(ids: np.ndarray, attrs: np.ndarray,
                vecs: np.ndarray) -> str:
    """SHA-256 over a live set given in ascending id order: the ids as
    int64, then the attributes and the vectors as float32."""
    h = hashlib.sha256()
    for x, dt in ((ids, np.int64), (attrs, np.float32), (vecs, np.float32)):
        h.update(np.ascontiguousarray(x, dt).tobytes())
    return h.hexdigest()


def live_record(idx) -> dict:
    """A streaming index's live set: its ids in ascending order and the
    :func:`live_digest` of (ids, attributes, vectors) in that order."""
    v, a, i = idx.live_items()
    o = np.argsort(i, kind="stable")
    return dict(live_ids=i[o], live_digest=live_digest(i[o], a[o], v[o]))


def _restore_index(args, streaming: bool):
    """Restore a prebuilt index from ``--index-path`` (sharded directory
    format) when one is there and matches the requested mode/corpus shape;
    returns ``(index, record of the restore)``, or ``(None, None)`` when a
    fresh build is needed."""
    from repro_torch.index import io
    if not (args.index_path and io.is_index_dir(args.index_path)):
        return None, None
    t0 = time.perf_counter()
    idx = io.load_index(args.index_path, device=args.device)
    from repro_torch.streaming import StreamingRFANN
    if isinstance(idx, StreamingRFANN) != streaming:
        print(f"[serve] index at {args.index_path} is the wrong kind for "
              f"this mode — rebuilding")
        return None, None
    d = idx.d if streaming else idx.g.vecs.shape[1]
    n_ok = streaming or idx.g.n == args.n
    if d != args.dim or not n_ok:
        print(f"[serve] index at {args.index_path} does not match the "
              f"requested corpus (n={args.n}, dim={args.dim}) — rebuilding")
        return None, None
    restored = dict(seconds=time.perf_counter() - t0)
    print(f"[serve] restored index from {args.index_path} "
          f"in {restored['seconds']:.2f}s (no rebuild)")
    if streaming and getattr(args, "wal_dir", ""):
        # crash-consistent restart: the checkpoint is the floor, the WAL
        # tail on top of it is every acknowledged mutation the previous
        # process did not get to fold in
        replayed = idx.replay_wal(args.wal_dir)
        print(f"[serve] replayed {replayed} WAL records from "
              f"{args.wal_dir} (lsn watermark {idx.applied_lsn})")
        restored.update(replayed=replayed, **live_record(idx))
    return idx, restored


def serve_rfann(args) -> dict:
    dev = args.device
    vecs = make_vectors(args.n, args.dim, seed=0)
    attrs = make_attrs(args.n, seed=0)
    qv = make_vectors(args.requests, args.dim, seed=7)
    ranges, _ = mixed_workload(attrs, args.requests, seed=3)
    streaming = args.max_delta > 0 or args.compact_every > 0
    rng = np.random.default_rng(0)
    idx, restored = _restore_index(args, streaming)
    if idx is not None and streaming:
        pending_ins = [j for j in range(args.n) if j not in idx._id_loc]
        print(f"[serve] {idx.stats()}")
    elif idx is not None:
        print(f"[serve] {idx.stats()}")
    elif streaming:
        # streaming serve: seed the base with 80% of the corpus, churn the
        # held-out tail (inserts) plus random deletes through the engine
        # while the first half of the requests stream in, then measure
        # recall on the second half against the *final* live set
        from repro_torch.streaming import StreamingRFANN
        n0 = max(args.n * 4 // 5, 256)
        print(f"[serve] building streaming RNSG base (n0={n0}) ...")
        idx = StreamingRFANN(vecs[:n0], attrs[:n0], m=args.m,
                             ef_spatial=32, ef_attribute=48,
                             max_delta=args.max_delta or 1024,
                             compact_every=args.compact_every, device=dev)
        pending_ins = list(range(n0, args.n))
        print(f"[serve] {idx.stats()}")
    elif args.build_shards:
        print(f"[serve] building RNSG index ({args.build_shards} shards) ...")
        idx = RNSGIndex.build_sharded(
            vecs, attrs, mesh=make_mesh(args.build_shards, [dev]), m=args.m,
            ef_spatial=32, ef_attribute=48)
        print(f"[serve] {idx.stats()}")
    else:
        print("[serve] building RNSG index ...")
        idx = RNSGIndex.build(vecs, attrs, m=args.m, ef_spatial=32,
                              ef_attribute=48, device=dev)
        print(f"[serve] {idx.stats()}")
    if args.precision != "f32":
        idx.install_quantized(args.precision)   # build quantized corpus once
    warm = idx.search(qv[:8], ranges[:8], k=args.k, ef=args.ef,
                      plan=args.plan, beam_width=args.beam_width,
                      precision=args.precision)     # build the kernels
    assert warm.ids.shape == (min(8, args.requests), args.k)

    engine = RFANNEngine(idx, k=args.k, ef=args.ef, plan=args.plan,
                         beam_width=args.beam_width,
                         precision=args.precision,
                         max_batch=args.max_batch, max_wait_ms=2.0,
                         calibration_path=args.calibration or None,
                         cache_bytes=args.cache_mb << 20,
                         log_interval_s=args.log_interval,
                         trace_sample_every=args.trace_sample_every,
                         max_delta=args.max_delta or None,
                         compact_every=args.compact_every or None,
                         index_path=args.index_path or None,
                         index_save_shards=args.index_shards,
                         wal_dir=(args.wal_dir or None) if streaming else None,
                         wal_sync=args.wal_sync)
    if streaming and args.wal_dir and not args.index_path:
        print("[serve] note: --wal-dir without --index-path logs mutations "
              "but leaves no checkpoint to recover onto")
    # graceful SIGTERM: stop accepting work, drain in-flight futures, then
    # the normal shutdown path seals the WAL and persists index +
    # calibration + metrics — zero acknowledged mutations lost
    preempt = PreemptionHandler().install()
    futs = []
    churn_until = args.requests // 2
    churn_on = streaming
    t0 = time.perf_counter()
    for i in range(args.requests):
        if preempt.should_stop():
            print(f"[serve] SIGTERM: draining after {len(futs)} submitted "
                  f"requests, then checkpointing")
            break
        futs.append(engine.submit(qv[i], ranges[i]))
        if churn_on and i < churn_until:
            try:
                if pending_ins:
                    j = pending_ins.pop()
                    engine.insert(vecs[j], float(attrs[j]), ext_id=j)
                if i % 4 == 3:      # one delete per four churn steps
                    live = list(engine.index._id_loc)
                    engine.delete(int(live[rng.integers(len(live))]))
            except ReadOnlyIndexError as e:
                # WAL append failed: the index degraded to read-only
                # (stream_read_only gauge = 1).  Searches keep working —
                # stop mutating, keep serving.
                churn_on = False
                print(f"[serve] churn stopped, serving continues: {e}")
        if args.rate > 0:
            time.sleep(rng.exponential(1.0 / args.rate))
    # SIGTERM can land before the first submit — drain an empty futs list
    # without tripping np.stack, so shutdown still seals the WAL below
    rows = [f.result() for f in futs]
    results = (np.stack([r.ids for r in rows]) if rows
               else np.zeros((0, args.k), np.int64))
    strategy = np.asarray([r.stats.get("strategy", -1) for r in rows],
                          np.int8)
    dt = time.perf_counter() - t0
    engine.close()
    if streaming:
        idx.close()     # drain any in-flight compaction, seal the WAL
    if engine.cache is not None:
        print(f"[serve] result cache: {engine.cache.snapshot()}")
    if args.calibration:
        print(f"[serve] cost-model calibration persisted to {args.calibration}")
    if args.index_path:
        print(f"[serve] index persisted to {args.index_path} "
              f"({args.index_shards} shards) — restored on next startup")
    if args.metrics_path:
        # final snapshot on shutdown, alongside the calibration save:
        # Prometheus text at the given path, JSON snapshot as a sibling
        from repro_torch.obs import write_prometheus
        write_prometheus(engine.registry, args.metrics_path)
        with open(args.metrics_path + ".json", "w") as f:
            json.dump(engine.metrics(), f, indent=2, sort_keys=True,
                      default=float)
        print(f"[serve] metrics written to {args.metrics_path} (+.json)")

    served = len(futs)
    if served == 0:
        rec = float("nan")          # drained before any request was served
        if streaming:
            print(f"[serve] streaming: {idx.stats()}")
    elif streaming and served > churn_until:
        # score only the post-churn half against the final live set (the
        # requests that raced mutations have no single ground truth)
        lv, la, li = idx.live_items()
        order = np.argsort(la, kind="stable")
        gt_r, _ = ground_truth(lv[order], la[order], qv[churn_until:served],
                               ranges[churn_until:served], args.k,
                               device=dev)
        gt = np.where(gt_r >= 0, li[order][np.maximum(gt_r, 0)], -1)
        rec = recall_at_k(results[churn_until:], gt)
        print(f"[serve] streaming: {idx.stats()}")
    elif streaming:
        rec = float("nan")          # drained before the scored half began
        print(f"[serve] streaming: {idx.stats()}")
    else:
        order = np.argsort(attrs, kind="stable")
        gt_r, _ = ground_truth(vecs[order], attrs[order], qv[:served],
                               ranges[:served], args.k, device=dev)
        gt = np.where(gt_r >= 0, order[np.maximum(gt_r, 0)], -1)
        rec = recall_at_k(results, gt)
    print(f"[serve] served {served} reqs in {dt:.2f}s "
          f"({served/dt:.0f} QPS) recall@{args.k}={rec:.4f}")
    summary = engine.stats.summary()
    print(f"[serve] {summary}")
    out = dict(recall=rec, qps=served / dt, served=served, seconds=dt,
               summary=summary, ids=results, strategy=strategy,
               restored=restored)
    if engine.cache is not None:
        out["cache"] = engine.cache.snapshot()
    if streaming:
        out.update(live_record(idx))
    return out


def serve_lm(args):
    """Prefill a batch of ``--max-batch`` × 32 tokens, then decode
    ``--new-tokens`` greedy tokens; returns the tokens (numpy)."""
    import torch

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models.lm import Model

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    b, s = args.max_batch, 32
    batch = concrete_batch(cfg, "prefill", b, s, rng, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with torch.inference_mode():
        cache, logits = model.prefill(params, batch,
                                      cache_len=s + args.new_tokens)
        toks = [torch.argmax(logits[:, :cfg.vocab_size], -1).int()]
        sync()
        t0 = time.perf_counter()
        for i in range(args.new_tokens):
            logits, cache = model.decode(params, cache, s + i, toks[-1])
            toks.append(torch.argmax(logits[:, :cfg.vocab_size], -1).int())
        sync()
        dt = time.perf_counter() - t0
    out = torch.stack(toks, 1).cpu().numpy()
    print(f"[serve] {args.arch}: batch={b} decoded {args.new_tokens} tokens "
          f"in {dt:.2f}s ({b*args.new_tokens/dt:.0f} tok/s)")
    print(f"[serve] sample continuation ids: {out[0][:12].tolist()}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["rfann", "lm"], default="rfann")
    ap.add_argument("--arch", default="llama3-8b",
                    help="lm mode: the architecture (its smoke config)")
    ap.add_argument("--device", default="cuda",
                    help="device the index is built and searched on, or the "
                         "model runs on (cuda | cpu)")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate (req/s); 0 = as fast as possible")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--plan", choices=["auto", "graph", "scan", "beam"],
                    default="auto", help="query-planner strategy routing")
    ap.add_argument("--beam-width", type=int, default=1,
                    help="batched beam expansion width (1 = single-node "
                         "hops; try 4 for throughput)")
    ap.add_argument("--precision", choices=["f32", "int8", "bf16"],
                    default="f32",
                    help="distance-scoring precision: quantized corpora "
                         "(int8/bf16) scan cheaper and rerank the survivors "
                         "in exact f32 (same ids as f32)")
    ap.add_argument("--index-path", default="",
                    help="index directory: restore the index from here at "
                         "startup (skipping the build) and persist it on "
                         "shutdown (repro_torch.index.io sharded format)")
    ap.add_argument("--index-shards", type=int, default=1,
                    help="row-shard count for --index-path saves (restore "
                         "fills shards with parallel reads)")
    ap.add_argument("--build-shards", type=int, default=0,
                    help="static mode: build the graph with the sharded "
                         "constructor over this many slabs, placed on "
                         "--device (0 = single-device build; results are "
                         "bit-identical either way)")
    ap.add_argument("--calibration", default="",
                    help="JSON path: load cost-model calibration at startup, "
                         "persist it on shutdown")
    ap.add_argument("--cache-mb", type=int, default=0,
                    help="result-cache byte budget in MiB (0 = no cache)")
    ap.add_argument("--metrics-path", default="",
                    help="write the final metrics snapshot here on shutdown "
                         "(Prometheus text; JSON sibling at <path>.json)")
    ap.add_argument("--log-interval", type=float, default=0.0,
                    help="seconds between one-line stats logs (0 = off)")
    ap.add_argument("--trace-sample-every", type=int, default=0,
                    help="attach a QueryTrace to every Nth batch (0 = off)")
    ap.add_argument("--max-delta", type=int, default=0,
                    help="streaming mode: compact when the delta segment "
                         "reaches this many rows (0 = static index)")
    ap.add_argument("--compact-every", type=int, default=0,
                    help="streaming mode: compact every N mutations "
                         "(0 = size-triggered only)")
    ap.add_argument("--wal-dir", default="",
                    help="streaming mode: write-ahead-log directory — every "
                         "mutation is logged (checksummed) before it is "
                         "applied, and a crashed server replays the tail "
                         "onto the --index-path checkpoint at restart")
    ap.add_argument("--wal-sync", choices=["always", "batch", "none"],
                    default="batch",
                    help="WAL durability: fsync per record / group commit "
                         "(every N records or T seconds) / OS page cache "
                         "only")
    ap.add_argument("--new-tokens", type=int, default=16,
                    help="lm mode: greedy tokens decoded after the prefill")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        return serve_lm(args)
    return serve_rfann(args)


if __name__ == "__main__":
    main()

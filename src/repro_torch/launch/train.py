"""Training launcher of the port (the reference's ``repro.launch.train``):
data pipeline → train step → checkpoint/restart, with preemption handling,
straggler monitoring and optional int8 gradient compression, on one
device.  ``main`` returns (state, losses).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch qwen1.5-4b --steps 30 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b --full --seq 4096 --batch 2 --steps 3

``--device`` (default ``cuda``) is where the model trains; without a card
the launcher raises unless given ``--device cpu``.  The parameters are
drawn from ``torch.Generator(device).manual_seed(0)``; a checkpoint written
by either package's launcher resumes in the other (``--ckpt-dir`` /
``--resume``).
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.tokens import (Prefetcher, SyntheticTokenStream,
                                     TokenStreamConfig)
from repro_torch.device import resolve_device
from repro_torch.models.lm import Model
from repro_torch.models.params import ShardPlan
from repro_torch.runtime.fault_tolerance import (PreemptionHandler,
                                                 StragglerMonitor,
                                                 make_compressed_grad_transform)
from repro_torch.training.optim import cosine_schedule
from repro_torch.training.train_step import build_train_step, init_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--full", action="store_true",
                    help="full config instead of the smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--simulate-straggler", type=float, default=0.0,
                    help="inject this many seconds of delay on fake host 3")
    ap.add_argument("--n-hosts", type=int, default=4,
                    help="simulated hosts for the straggler monitor")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="device the model trains on (cpu: the plain path "
                         "on the host)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    model = Model(cfg, ShardPlan(), device=dev)
    sched = functools.partial(cosine_schedule, base_lr=args.lr,
                              warmup=args.warmup, total=max(args.steps, 100))
    step_fn = build_train_step(
        model, lr_schedule=sched,
        grad_transform=(make_compressed_grad_transform()
                        if args.compress_grads else None))

    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0))
    start_step = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_step = ckpt.meta()["step"]
        print(f"[train] resumed from step {start_step}")

    stream = SyntheticTokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch))
    data = Prefetcher(stream.iter_from(start_step), depth=2)

    preempt = PreemptionHandler().install()
    monitor = StragglerMonitor(args.n_hosts)
    losses = []
    t_start = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = next(data)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {k: torch.as_tensor(v, device=dev)
                                         for k, v in batch.items()})
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        # simulated per-host step times (host 3 optionally delayed)
        host_t = np.full(args.n_hosts, dt)
        if args.simulate_straggler:
            host_t[3 % args.n_hosts] += args.simulate_straggler
        verdict = monitor.record(host_t)
        if verdict["stragglers"]:
            print(f"[train] step {step}: stragglers={verdict['stragglers']} "
                  f"evict={verdict['evict']}")
        if step % args.log_every == 0:
            print(f"[train] step {step} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} {dt*1e3:.0f}ms")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
        if preempt.should_stop():
            print("[train] preemption requested — checkpointing and exiting")
            if ckpt:
                ckpt.save(step + 1, state, blocking=True)
            return state, losses
    if ckpt:
        ckpt.save(args.steps, state, blocking=True)
    tput = (args.steps - start_step) * args.batch * args.seq / \
        max(time.perf_counter() - t_start, 1e-9)
    if losses:
        print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"({tput:.0f} tok/s)")
    return state, losses


if __name__ == "__main__":
    main()

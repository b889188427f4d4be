#!/usr/bin/env python3
"""How far qwen1.5-4b's bf16 train step moves when only its rounding
changes, on the card: the yardstick of the TP step's distance to the
unsharded step in ``chip_smoke.py``'s shard phase.

    python3 benchmarks/tp_distance_torch.py [--seed 0]

The shard phase's model and batch (qwen1.5-4b at full width and depth,
bf16, f32 moments, remat full in super-groups of 2, 8 × 1024, the loss in
slices of 256, the constant rate ``SHARD_LR``); every run draws the same
parameters from the seed and takes one step.  Each run's loss, gradient
norm and post-step parameter slices are compared with the unsharded
step's (relative; the parameters' distance relative to the unsharded
step's move, ``chip_smoke._rel_to``):

* ``micro2``: ``micro_batches=2``, the same products, only the f32 sums
  of the gradient reordered (the shard phase's yardstick);
* ``tiles512`` / ``tiles256``: the unsharded step with its attention in q
  and kv tiles of 512 / 256 positions instead of 1024 (the online
  softmax's f32 sums reordered);
* ``tp``: the TP step at (data 2, model 4), 8 shards on the card;
* ``tp_f32_partials``: the same with each row-parallel product (the
  attention's ``wo``, the MLP's ``w_out``) taken in f32 and summed over
  ``model`` before one rounding to bf16, as the unsharded product rounds
  (an f32 product of the bf16 inputs, TF32 off);
* ``tp_fault``: the TP step with a planted fault, every attention
  sublayer's output scaled by 1.01.

The two TP variants patch ``parallel.tp``'s sublayers in this process
only.  Prints one line per run and, last, one JSON object (also written to
``chiprun_out/tp_distance.json``).  Needs one CUDA card."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("tp_distance_torch: no CUDA device is present", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import SyntheticTokenStream, TokenStreamConfig
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import norm
    from repro_torch.models.lm import Model
    from repro_torch.parallel import tp
    from repro_torch.parallel.fsdp import (StateLayout,
                                           build_sharded_train_step,
                                           init_sharded_state)
    from repro_torch.parallel.sharding import (DEFAULT_RULES,
                                               make_act_sharder, make_mesh)
    from repro_torch.training.train_step import (build_train_step,
                                                 init_train_state)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             SyntheticTokenStream(TokenStreamConfig(
                 vocab_size=cfg.vocab_size, seq_len=cs.SHARD_SEQ,
                 global_batch=cs.SHARD_BATCH, seed=args.seed)
             ).batch_at(0).items()}
    sched = lambda step: torch.tensor(cs.SHARD_LR,  # noqa: E731
                                      device=step.device)
    gen = lambda: torch.Generator(device=dev).manual_seed(  # noqa: E731
        args.seed)

    def unsharded(label, micro=1, **opts):
        model = Model(cfg, device=dev, opts=dict(cs.SHARD_OPTS, **opts))
        b = batch if micro == 1 else {
            k: v.reshape(micro, cs.SHARD_BATCH // micro, cs.SHARD_SEQ)
            for k, v in batch.items()}
        return cs._shard_step(label, lambda: init_train_state(model, gen()),
                              build_train_step(model, lr_schedule=sched,
                                               micro_batches=micro), b,
                              lambda st: st["params"],
                              reps=2 if label == "unsharded" else 1)

    mesh = make_mesh(cs.SHARD_TP, [dev])
    tmodel = Model(cfg, device=dev, mesh=mesh, opts=cs.SHARD_OPTS,
                   act_shard=make_act_sharder(mesh, DEFAULT_RULES))
    lay = StateLayout(tmodel, mesh, DEFAULT_RULES)

    def tp_step(label):
        return cs._shard_step(
            label, lambda: init_sharded_state(tmodel, mesh, gen(),
                                              DEFAULT_RULES),
            build_sharded_train_step(tmodel, mesh, DEFAULT_RULES,
                                     lr_schedule=sched), batch,
            lambda sh: lay.unshard_tree([s["params"] for s in sh]), reps=1)

    pre = cs._slices(Model(cfg, device=dev).init(gen()))
    torch.cuda.empty_cache()
    recs = {"unsharded": unsharded("unsharded"),
            "micro2": unsharded("micro_batches=2", micro=2),
            "tiles512": unsharded("tiles 512", q_chunk=512, kv_chunk=512),
            "tiles256": unsharded("tiles 256", q_chunk=256, kv_chunk=256),
            "tp": tp_step(f"TP {cs.SHARD_TP}")}

    self_attn, mlp, reduce = attn.self_attn_train, tp.mlp, tp._Hooks._reduce

    def attn_f32(x, p, cfg, dm, positions, causal=True, opts=None):
        h = norm(x, p, cfg.norm)
        q, k, v = attn._qkv(h, p, cfg, dm)
        if cfg.rope_theta:
            q = tp.apply_rope(q, positions, cfg.rope_theta)
            k = tp.apply_rope(k, positions, cfg.rope_theta)
        o = attn.flash_attention(q, k, v, causal=causal,
                                 window=cfg.sliding_window, **(opts or {}))
        return o.reshape(*x.shape[:2], dm.h * dm.hd).float() @ \
            p["wo"].float()

    def mlp_f32(x, p, act):
        h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_in"])
        return h.float() @ p["w_out"].float()

    def reduce_to_bf16(self, ys):
        return self.c.all_reduce(ys, self.mesh, "model", dtype=torch.bfloat16)

    attn.self_attn_train, tp.mlp, tp._Hooks._reduce = (attn_f32, mlp_f32,
                                                       reduce_to_bf16)
    recs["tp_f32_partials"] = tp_step("TP, f32 row-parallel partials")
    attn.self_attn_train, tp.mlp, tp._Hooks._reduce = self_attn, mlp, reduce
    attn.self_attn_train = lambda *a, **k: self_attn(*a, **k) * 1.01
    recs["tp_fault"] = tp_step("TP, attention outputs x 1.01 (planted)")
    attn.self_attn_train = self_attn

    u = recs["unsharded"]
    out = {"card": torch.cuda.get_device_name(0), "runs": {}}
    for name, r in recs.items():
        if name == "unsharded":
            continue
        d = {k: abs(r[k] - u[k]) / abs(u[k]) for k in ("loss", "grad_norm")}
        d["params"] = cs._rel_to(r["slices"], u["slices"], pre)
        d["ms"] = r["ms"]
        out["runs"][name] = d
        print(f"[tp_distance] {name}: loss {d['loss']:.3e}, gradient norm "
              f"{d['grad_norm']:.3e}, parameters {d['params']:.3e} from the "
              f"unsharded step (relative); {r['ms']:.1f} ms")
    dest = ROOT / "chiprun_out" / "tp_distance.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

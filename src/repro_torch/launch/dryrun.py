"""Multi-pod dry-run: one device's share of every (arch × shape × mesh)
cell's step, run on fake tensors (no allocation) and counted, for
§Roofline (the reference's ``repro.launch.dryrun``, which lowers and
compiles each cell with ShapeDtypeStruct stand-ins).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rnsg-serve
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod] [--jobs k/N]

It needs no card: the mesh's devices are ``meta``
(``launch.mesh.make_production_mesh``), and a cell runs shard 0's share of
its step (``ShardMesh.share``) under ``FakeTensorMode``, its products
counted by ``FlopCounterMode`` and its collectives' per-device operand
bytes by a ``CollectiveCounter`` (``launch.hlo_analysis``); the collectives
stand in for the other shards.  Train cells run the FSDP strategy's
sharded step (``parallel.fsdp``), ``replica`` variants the replica rules.
Cells whose strategy is tensor parallelism (base prefill and decode) have
no program in the port yet: their records hold the spec-derived fields
(``meta``, per-device parameter bytes, ``analytic_memory``,
``model_flops``) and ``"pending": "tensor-parallel program"``, and no
counted field.  The multi-pod pass places and sizes every cell without
counting it (the reference's production-only pass).

Eager counting sees every layer and every recompute, so cells are counted
at full depth (the reference extrapolates from two depths because XLA
counts a while body once).  The largest train cell counts in about two
minutes on one CPU core.

Results land in results/dryrun_torch/<arch>__<shape>__<mesh>[__variant].json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import cells, get_config, get_smoke_config
from repro_torch.launch.hlo_analysis import (count_program, model_flops,
                                             roofline_terms)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import analytic_memory
from repro_torch.launch.specs import input_specs
from repro_torch.models.lm import Model
from repro_torch.models.params import (DTYPES, ShardPlan, build_param_specs,
                                       logical_axes)
from repro_torch.parallel.fsdp import StateLayout, build_sharded_train_step
from repro_torch.parallel.sharding import (STRATEGIES, batch_logical,
                                           block_slices, local_shape,
                                           make_act_sharder, make_mesh,
                                           spec_for_logical)
from repro_torch.search.substrate import graph_share, shard_operand_specs
from repro_torch.training.train_step import train_state_shapes
from repro_torch.training.tree import leaves

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
PENDING_TP = "tensor-parallel program"

VARIANTS = {
    # §Perf hillclimb variants: cfg field overrides + Model opts overrides
    "base": {},
    "nosp": {"opts": {"sp": False}},
    "remat_dots": {"cfg": {"remat": "dots"}},
    "remat_full": {"cfg": {"remat": "full"}},
    "remat_none": {"cfg": {"remat": "none"}},
    "ce2048": {"opts": {"ce_chunk": 2048}},
    "ce512": {"opts": {"ce_chunk": 512}},
    "qc2048": {"opts": {"q_chunk": 2048, "kv_chunk": 2048}},
    "blockskip": {"opts": {"block_skip": True}},          # analysis-mode only
    "cf1": {"cfg": {"capacity_factor": 1.0}},
    "ssm256": {"opts": {"ssm_chunk": 256}},
    "ssm64": {"opts": {"ssm_chunk": 64}},
    "ssm512": {"opts": {"ssm_chunk": 512}},
    "ssm128": {"opts": {"ssm_chunk": 128}},
    "replica": {"opts": {"strategy": "replica"}},
    "ssd16": {"opts": {"ssd_dtype": "bfloat16"}},
    # composed hillclimb variants
    "llama4_opt": {"cfg": {"capacity_factor": 1.0},
                   "opts": {"block_skip": True}},
    "mamba2_opt": {"opts": {"strategy": "replica", "ssd_dtype": "bfloat16",
                            "ssm_chunk": 64}},
    "mamba2_opt2": {"opts": {"strategy": "replica", "ssd_dtype": "bfloat16",
                             "ssm_chunk": 256}},
    "ssd16_256": {"opts": {"ssd_dtype": "bfloat16", "ssm_chunk": 256}},
}


def _apply_variant(cfg, variant: str):
    if variant not in VARIANTS:
        raise KeyError(f"unknown variant {variant!r}; known: {sorted(VARIANTS)}")
    v = VARIANTS[variant]
    if "cfg" in v:
        cfg = dataclasses.replace(cfg, **v["cfg"])
    return cfg, dict(v.get("opts", {}))


def _tag(arch, shape_name, mesh_name, variant):
    return f"{arch}__{shape_name}__{mesh_name}" + \
        ("" if variant == "base" else f"__{variant}")


def _param_bytes(cfg, plan, mesh, rules) -> int:
    """One device's parameter blocks, from the specs alone."""
    return sum(math.prod(local_shape(s.shape, spec_for_logical(
        s.logical, s.shape, mesh, rules), mesh))
        * DTYPES[s.dtype].itemsize
        for s in build_param_specs(cfg, plan).values())


@dataclasses.dataclass
class Cell:
    """One cell, ready to count: its config, shape, strategy and plan, the
    spec-derived per-device parameter bytes, and ``build`` / ``run`` for
    ``count_program`` (None when the strategy's program is pending)."""
    cfg: object
    shape: object
    strategy: str
    plan: ShardPlan
    meta: dict
    param_bytes: int
    build: object = None
    run: object = None
    pending: str = ""


def _share_batch(batch, cfg, kind, mesh, rules):
    """Shard 0's block of every batch leaf."""
    blog = batch_logical(cfg, kind)
    out = {}
    for k, v in batch.items():
        spec = spec_for_logical(blog[k], tuple(v.shape), mesh, rules)
        out[k] = v[block_slices(tuple(v.shape), spec, mesh, 0)]
    return out


def train_share(cfg, mesh, batch_shape, rules, plan=ShardPlan(), opts=None):
    """``build`` / ``run`` for ``count_program``: shard 0's share of the
    FSDP-strategy step of ``cfg`` on ``mesh`` (its present shard is the
    only one placed) at a global batch of ``batch_shape`` = (B, S)."""
    share = mesh.share(0)

    def build():
        model = Model(cfg, plan, mesh=share,
                      act_shard=make_act_sharder(share, rules), opts=opts,
                      device="meta")
        lay = StateLayout(model, share, rules)
        shards = lay.shard(train_state_shapes(model))
        b, s = batch_shape
        batch = input_specs(cfg, ShapeConfig("cell", "train", s, b))
        local = _share_batch(batch, cfg, "train", share, rules)
        nbytes = sum(t.numel() * t.element_size()
                     for t in leaves(shards) + list(local.values()))
        return (model, shards, batch), nbytes

    def run(args):
        model, shards, batch = args
        step = build_sharded_train_step(model, share, rules)
        return step(shards, batch)[1]

    return build, run


def _blocks(logical, shapes, mesh, rules):
    """One device's blocks of a tree of meta tensors, as meta tensors."""
    if isinstance(logical, dict):
        return {k: _blocks(v, shapes[k], mesh, rules)
                for k, v in logical.items()}
    shp = tuple(shapes.shape)
    return torch.empty(local_shape(shp, spec_for_logical(logical, shp, mesh,
                                                         rules), mesh),
                       dtype=shapes.dtype, device="meta")


def _serve_share(cfg, shape, mesh, rules, plan, opts):
    """``build`` / ``run``: shard 0's share of a replica-rules prefill or
    decode (replicated weights, the batch split by its spec)."""
    share = mesh.share(0)

    def build():
        model = Model(cfg, plan, mesh=None, opts=opts, device="meta")
        params = _blocks(logical_axes(cfg, plan), model.param_shapes(),
                         share, rules)
        local = _share_batch(input_specs(cfg, shape), cfg, shape.kind, share,
                             rules)
        nbytes = sum(t.numel() * t.element_size()
                     for t in leaves(params) + list(local.values()))
        cache = None
        if shape.kind == "decode":
            cache = model.init_cache(local["token"].shape[0], shape.seq_len)
            nbytes += sum(t.numel() * t.element_size()
                          for t in cache.values())
        return (model, params, local, cache), nbytes

    def run(args):
        model, params, local, cache = args
        with torch.no_grad():
            if shape.kind == "prefill":
                return model.prefill(params, local, cache_len=shape.seq_len)[1]
            return model.decode(params, cache, shape.seq_len - 1,
                                local["token"])[0]

    return build, run


def build_cell(arch: str, shape_name: str, mesh, variant: str = "base",
               smoke: bool = False) -> Cell:
    """The cell's config under its variant, its strategy (FSDP for train,
    TP for serving, unless the variant says otherwise) and plan, and the
    share of its step to count."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cfg, opts = _apply_variant(cfg, variant)
    shape = SHAPES[shape_name]
    # parallelism strategy: pure-FSDP for training (no TP activation
    # all-reduces; ZeRO-3 weights), TP for serving (KV-cache sharding)
    strategy = opts.pop("strategy", "fsdp" if shape.kind == "train" else "tp")
    rules = STRATEGIES[strategy]
    tp = mesh.shape["model"] if strategy == "tp" else 1
    fsdp = mesh.shape["data"]
    dp = mesh.shape.get("pod", 1)
    plan = ShardPlan(tp=tp, fsdp=fsdp, dp=dp, vocab_multiple=256)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    meta = dict(arch=arch, shape=shape_name, kind=shape.kind, tokens=tokens,
                n_params=cfg.n_params(), n_active=cfg.n_active_params())
    cell = Cell(cfg, shape, strategy, plan, meta,
                _param_bytes(cfg, plan, mesh, rules))
    if strategy == "tp":
        cell.pending = PENDING_TP
    elif shape.kind == "train":
        cell.build, cell.run = train_share(
            cfg, mesh, (shape.global_batch, shape.seq_len), rules, plan, opts)
    else:
        cell.build, cell.run = _serve_share(cfg, shape, mesh, rules, plan,
                                            opts)
    return cell


def run_rnsg_cell(multi_pod: bool, variant: str = "base", save: bool = True,
                  ns: int = 65536, d: int = 128, m: int = 32, nq: int = 1024,
                  k: int = 10, ef: int = 64, results: Path = RESULTS):
    """Dry-run of the paper's own system at production scale: a 16.8M-vector
    corpus (65536 per 'data' shard × 16, d=128, m=32) served with the
    range-partitioned mesh search (``search.substrate.graph_share``: each
    shard clips the global rank interval, picks its RMQ entry, runs the
    beam — its while-loop body counted once, as the reference's HLO cost
    analysis counts it — and remaps; the shards' top-k are all-gathered
    and merged).  The mesh path resolves the attribute ranges on the host,
    so the shard's operands are rank intervals.  Variant 'qshard'
    additionally shards the query batch over the 'model' axis (every model
    rank serves its own 1/16 slice)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = 512 if multi_pod else 256
    S = mesh.shape["data"] * mesh.shape.get("pod", 1)
    qshard = variant == "qshard"
    nq_dev = nq // mesh.shape["model"] if qshard else nq
    share = make_mesh(S, ["meta"]).share(0)

    def build():
        f = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")  # noqa: E731
        ops, _ = shard_operand_specs(ns, d, m)
        q = [f((nq_dev, d), torch.float32), f((nq_dev,), torch.int32),
             f((nq_dev,), torch.int32)]
        return (ops, q), sum(t.numel() * t.element_size() for t in ops + q)

    def run(args):
        sh, (qv, lo, hi) = args
        return graph_share(share, [sh], qv, lo, hi, k=k, ef=ef)

    c = count_program(build, run, elementwise=True)
    flops_dev = c["flops"]
    bytes_dev = float(c["argument_bytes"] + c["temp_bytes"])
    coll = c["collectives"]
    terms = roofline_terms(flops_dev, bytes_dev, float(coll["total"]), chips)
    rec = dict(arch="rnsg-serve", shape=f"q{nq}_n{S*ns}", mesh=mesh_name,
               chips=chips, variant=variant, compile_s=c["seconds"],
               cost=dict(flops_per_device=flops_dev,
                         bytes_per_device=bytes_dev),
               memory=dict(temp_bytes=c["temp_bytes"],
                           argument_bytes=c["argument_bytes"]),
               collectives=coll, roofline=terms,
               note="beam while-loop body counted once (the entry pool and "
                    "one hop); use per-query dist-eval stats from "
                    "benchmarks for absolute work accounting")
    if save:
        results.mkdir(parents=True, exist_ok=True)
        tag = f"rnsg-serve__q{nq}__{mesh_name}" + \
              ("" if variant == "base" else f"__{variant}")
        (results / f"{tag}.json").write_text(json.dumps(rec, indent=1,
                                                        default=float))
    print(f"[dryrun] rnsg-serve {mesh_name} {variant}: counted in "
          f"{c['seconds']:.1f}s ops/dev={flops_dev:.2e} "
          f"coll={coll['total']/2**20:.3f}MiB/dev "
          f"args={c['argument_bytes']/2**30:.3f}GiB")
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, variant: str = "base",
             save: bool = True, verbose: bool = True, analysis: bool = True,
             smoke: bool = False, results: Path = RESULTS):
    """Count one cell and write its record (``analysis=False``: place and
    size it without counting, the reference's multi-pod pass)."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = _tag(arch, shape_name, mesh_name, variant)
    out_path = results / f"{tag}.json"
    shape = SHAPES[shape_name]
    cfg = get_smoke_config(arch) if smoke else get_config(arch)

    def write(rec):
        if save:
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps(rec, indent=1, default=float))
        return rec

    if not shape.applicable(cfg):
        return write(dict(arch=arch, shape=shape_name, mesh=mesh_name,
                          variant=variant,
                          skipped=f"long_500k requires sub-quadratic attention "
                                  f"({cfg.family} is full-attention)"))
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = 512 if multi_pod else 256
    t0 = time.perf_counter()
    cell = build_cell(arch, shape_name, mesh, variant, smoke)
    t_lower = time.perf_counter() - t0
    am = analytic_memory(arch, shape_name, cfg=cell.cfg)
    mf = model_flops(cell.cfg, shape, cell.meta["n_active"])
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
               variant=variant, meta=cell.meta, lower_s=t_lower,
               memory=dict(argument_bytes=cell.param_bytes),
               analytic_memory=am, model_flops=mf)
    if cell.pending or not analysis:
        if cell.pending:
            rec["pending"] = cell.pending
        write(rec)
        if verbose:
            print(f"[dryrun] {tag}: "
                  + (f"pending ({cell.pending})" if cell.pending else
                     "placed (not counted)")
                  + f"; params {cell.param_bytes/2**30:.2f}GiB/dev")
        return rec
    c = count_program(cell.build, cell.run)
    flops_dev = c["flops"]
    bytes_dev = float(c["argument_bytes"] + c["temp_bytes"])
    coll = c["collectives"]
    terms = roofline_terms(flops_dev, bytes_dev, float(coll["total"]), chips)
    rec.update(compile_s=c["seconds"], compile_analysis_s=c["seconds"],
               cost=dict(flops_per_device=flops_dev,
                         bytes_per_device=bytes_dev),
               memory=dict(argument_bytes=c["argument_bytes"],
                           temp_bytes=c["temp_bytes"],
                           param_bytes=cell.param_bytes),
               collectives=coll, collective_calls=c["calls"],
               roofline=terms,
               useful_ratio=(mf / terms["flops_global"]
                             if terms["flops_global"] else None))
    write(rec)
    if verbose:
        print(f"[dryrun] {tag}: counted in {c['seconds']:.1f}s "
              f"dom={terms['dominant']} t={terms['t_bound']*1e3:.2f}ms "
              f"useful={rec['useful_ratio'] and round(rec['useful_ratio'],3)} "
              f"coll={coll['total']/2**20:.1f}MiB/dev "
              f"temp={c['temp_bytes']/2**30:.2f}GiB/dev")
    return rec


def count_train(cfg, axes: dict, batch: int, seq: int, rules=None,
                plan=ShardPlan(), opts=None) -> dict:
    """Shard 0's share of the FSDP-strategy step of ``cfg`` on a meta mesh
    of ``axes`` at a global batch of ``batch`` × ``seq``, counted: the
    ``count_program`` fields (its fake result dropped) and
    ``param_bytes``, the shard's parameter blocks."""
    rules = rules or STRATEGIES["fsdp"]
    mesh = make_mesh(dict(axes), ["meta"])
    build, run = train_share(cfg, mesh, (batch, seq), rules, plan, opts)
    c = count_program(build, run)
    c.pop("result")
    c["param_bytes"] = _param_bytes(cfg, plan, mesh, rules)
    return c


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--jobs", default="",
                    help="k/N: process cells with index %% N == k (a sharded sweep)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-analysis", action="store_true",
                    help="place and size only (the multi-pod pass)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config (tests)")
    ap.add_argument("--results", type=Path, default=RESULTS)
    ap.add_argument("--mesh", default="",
                    help="name=size,...: count --arch's train step share on "
                         "this mesh at --batch x --seq with an unpadded plan "
                         "(an unsharded Model's) instead of a cell; the "
                         "counts go to --json")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--opt", action="append", default=[],
                    help="key=value: a Model option of the --mesh count "
                         "(e.g. ce_chunk=256)")
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)

    if args.mesh:
        axes = {k: int(v) for k, v in
                (kv.split("=") for kv in args.mesh.split(","))}
        cfg = get_smoke_config(args.arch) if args.smoke else \
            get_config(args.arch)
        opts = {k: int(v) if v.isdigit() else v
                for k, v in (kv.split("=") for kv in args.opt)}
        c = count_train(cfg, axes, args.batch, args.seq, opts=opts or None)
        c.update(arch=args.arch, mesh=axes, batch=args.batch, seq=args.seq)
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(c, indent=1, default=float))
        print(f"[dryrun] {args.arch} train share on {axes} at {args.batch} x "
              f"{args.seq}: counted in {c['seconds']:.1f}s, "
              f"{c['flops']:.3e} flops/dev, collectives {c['collectives']}, "
              f"params {c['param_bytes']} B/dev")
        return

    if args.arch == "rnsg-serve":
        run_rnsg_cell(args.multipod, args.variant, results=args.results)
        return

    todo = []
    if args.all:
        meshes = [False, True] if args.both_meshes else [args.multipod]
        for mp in meshes:
            for arch, shape, skip in cells(include_inapplicable=True):
                todo.append((arch, shape, mp))
    else:
        todo = [(args.arch, args.shape, args.multipod)]
    if args.jobs:
        k, n = map(int, args.jobs.split("/"))
        todo = [t for i, t in enumerate(todo) if i % n == k]

    failures, pending = [], 0
    for arch, shape, mp in todo:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        tag = _tag(arch, shape, mesh_name, args.variant)
        out_path = args.results / f"{tag}.json"
        if out_path.exists() and not args.force:
            print(f"[dryrun] {tag}: cached")
            pending += "pending" in json.loads(out_path.read_text())
            continue
        try:
            rec = run_cell(arch, shape, mp, args.variant,
                           analysis=not args.no_analysis and not mp,
                           smoke=args.smoke, results=args.results)
            pending += "pending" in rec
        except Exception:
            failures.append(tag)
            print(f"[dryrun] {tag}: FAILED")
            traceback.print_exc()
    if args.all:
        print(f"[dryrun] {pending} of {len(todo)} cells pending "
              f"({PENDING_TP})")
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()

"""Aggregate results/dryrun_torch/*.json into the §Dry-run and §Roofline
markdown tables, plus an analytic per-device memory model (the reference's
``repro.launch.roofline``: params/optimizer/cache/carry arithmetic, here
against one H100's 80 GB).

  PYTHONPATH=src python -m repro_torch.launch.roofline [--variant base]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch.hlo_analysis import BF16_FLOPS, HBM_PER_CARD
from repro_torch.models.params import ShardPlan, resolve_dims

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def analytic_memory(arch: str, shape_name: str, chips_grid=(16, 16),
                    cfg=None) -> dict:
    """Per-device bytes: params + optimizer + grads + remat carries + caches
    (``cfg``: another config than ``arch``'s, e.g. its smoke copy)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    data, model = chips_grid
    dev = data * model
    n = cfg.n_params()
    out = {}
    if shape.kind == "train":
        # FSDP strategy: everything ZeRO-3 over all devices
        opt_b = 2 if cfg.opt_dtype == "bfloat16" else 4
        params = 2 * n / dev
        opt = 2 * opt_b * n / dev
        grads = 2 * n / dev          # grads carry the param dtype (bf16)
        # remat carries: (B/dev_eff) × seq × d × 2B × (groups / remat_group)
        gl = resolve_dims(cfg, ShardPlan()).group_layers
        groups = cfg.n_layers // gl
        b_eff = min(shape.global_batch, dev)
        tokens_dev = shape.global_batch * shape.seq_len / b_eff
        carries = tokens_dev * cfg.d_model * 2 * max(
            groups // max(cfg.remat_group, 1), 1)
        out.update(params=params, opt=opt, grads=grads, act_carries=carries,
                   total=params + opt + grads + carries)
    else:
        # TP strategy: params fsdp×tp; KV heads padded to TP
        params = 2 * n / dev
        dm = resolve_dims(cfg, ShardPlan(tp=model, fsdp=data, vocab_multiple=256))
        cache = 0.0
        if cfg.family in ("dense", "moe", "encdec", "vlm", "hybrid"):
            layers_with_kv = (cfg.n_layers // cfg.attn_every if cfg.attn_every
                              else cfg.n_layers)
            kv = (2 * layers_with_kv * shape.global_batch * shape.seq_len
                  * dm.kh * dm.hd * 2)
            b_shard = min(shape.global_batch, data)
            h_shard = model if dm.kh % model == 0 else 1
            if shape.long_context:       # seq sharded over data instead
                kv_dev = kv / data / h_shard
            else:
                kv_dev = kv / b_shard / h_shard
            cache += kv_dev
        if cfg.ssm_state:
            n_m = (cfg.n_layers - (cfg.n_layers // cfg.attn_every
                                   if cfg.attn_every else 0)
                   if cfg.family == "hybrid" else cfg.n_layers)
            st = n_m * shape.global_batch * dm.ssm_h * dm.ssm_p * dm.ssm_n * 4
            cache += st / min(shape.global_batch, data) / \
                (model if dm.ssm_h % model == 0 else 1)
        out.update(params=params, cache=cache, total=params + cache)
    out["fits_80GB"] = out["total"] < HBM_PER_CARD
    return out


def load(variant: str = "base", mesh: str = "pod16x16",
         results: Path = RESULTS):
    recs = {}
    suffix = "" if variant == "base" else f"__{variant}"
    for arch in list_archs():
        for sname in SHAPES:
            p = results / f"{arch}__{sname}__{mesh}{suffix}.json"
            if p.exists():
                recs[(arch, sname)] = json.loads(p.read_text())
    return recs


def fraction(rec) -> float:
    """Useful-compute fraction of the roofline bound: the time the tensor
    cores would need for MODEL_FLOPS over the bound implied by the dominant
    term."""
    t_model = rec["model_flops"] / rec["chips"] / BF16_FLOPS
    return t_model / max(rec["roofline"]["t_bound"], 1e-12)


def roofline_table(variant: str = "base", results: Path = RESULTS) -> str:
    recs = load(variant, results=results)
    lines = ["| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) | dominant "
             "| MODEL_FLOPS | useful | roofline frac | fits80G |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, sname), r in sorted(recs.items()):
        if "skipped" in r:
            lines.append(f"| {arch} | {sname} | — | — | — | skipped | — | — | — "
                         f"| — |")
            continue
        am = analytic_memory(arch, sname)
        fits = ('✓' if am['fits_80GB'] else
                '✗ (' + format(am['total'] / 2**30, '.0f') + 'G)')
        if "roofline" not in r:
            lines.append(f"| {arch} | {sname} | — | — | — | "
                         f"not counted | "
                         f"{r['model_flops']:.2e} | — | — | {fits} |")
            continue
        t = r["roofline"]
        lines.append(
            f"| {arch} | {sname} | {t['t_compute']*1e3:.2f} | "
            f"{t['t_memory']*1e3:.2f} | {t['t_collective']*1e3:.2f} | "
            f"{t['dominant']} | {r['model_flops']:.2e} | "
            f"{(r['useful_ratio'] or 0):.3f} | {fraction(r):.3f} | {fits} |")
    return "\n".join(lines)


def dryrun_table(results: Path = RESULTS) -> str:
    lines = ["| arch | shape | 16×16 counted | 2×16×16 placed | coll MiB/dev "
             "(1-pod) |", "|---|---|---|---|---|"]
    single = load("base", "pod16x16", results)
    multi = load("base", "pod2x16x16", results)
    for key in sorted(single):
        r1, r2 = single[key], multi.get(key, {})
        if "skipped" in r1:
            lines.append(f"| {key[0]} | {key[1]} | skipped (full attention) "
                         f"| skipped | — |")
            continue
        c1 = (f"{r1['compile_s']:.1f}s ✓" if "compile_s" in r1
              else "—")
        c2 = f"{r2['lower_s']:.1f}s ✓" if r2 and "skipped" not in r2 else "—"
        coll = (f"{r1['collectives']['total'] / 2**20:,.0f}"
                if "collectives" in r1 else "—")
        lines.append(f"| {key[0]} | {key[1]} | {c1} | {c2} | {coll} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="base")
    ap.add_argument("--table", choices=["roofline", "dryrun", "both"],
                    default="both")
    ap.add_argument("--results", type=Path, default=RESULTS)
    args = ap.parse_args()
    if args.table in ("dryrun", "both"):
        print("### Dry-run\n")
        print(dryrun_table(args.results))
        print()
    if args.table in ("roofline", "both"):
        print("### Roofline (single pod, 256 × H100 SXM)\n")
        print(roofline_table(args.variant, args.results))


if __name__ == "__main__":
    main()

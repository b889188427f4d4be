#!/usr/bin/env python3
"""Holds the PyTorch port's LM path on the card against the JAX reference
at full width, cut to 2 layers so the host can run it.  It reads either of
the two witnesses that ``chip_smoke.py`` writes, and tells them apart by
the file's ``kind``:

**Serving** (``chiprun_out/witness_lm_llama3-8b.npz``; llama3-8b: d_model
4096, 32 q / 8 kv heads, d_ff 14336, vocab 128256, bf16).  The lm phase
draws the parameters with numpy from its seed
(``repro_torch.models.params.numpy_params``), runs a prefill of 4 × 32
tokens and 4 greedy decode steps on the card, and stores the seed, the
depth, the tokens, the tokens fed to each decode step, and the card's
logits after the prefill and after each step.  This script draws the same
parameters again on the CPU and runs, fed the same tokens, the JAX
reference (``repro.models.lm.Model``) in bf16 and the port's CPU path
(``repro_torch.models.lm.Model(device="cpu")``).  It compares the card's
logits with each, and the two CPU runs with each other: the relative L2
distance over the batch, at the prefill and at every decode step, must stay
within 5e-2.  bf16 keeps 8 mantissa bits; the card, the port's CPU path and
XLA round the activations at different points, and two layers at this
width move the logits by about a percent, not more.  About 3 GB of bf16
parameters per package and a few minutes of CPU.

**Training** (``chiprun_out/witness_train_qwen1.5-4b.npz``; qwen1.5-4b:
d_model 2560, 20 heads with QKV bias, d_ff 6912, vocab 151936, in f32).
The train phase draws the parameters the same way, and stores the seed,
the tokens and labels (2 × 512), the card's loss and global gradient norm,
each gradient leaf's norm and 256 fixed, evenly spaced elements of it, and
the loss after one AdamW step (the gradients clipped to norm 1, fresh
moments, lr 1e-3).  This script runs, on the same parameters and batch,
the reference's ``jax.value_and_grad(model.loss)``, ``clip_by_global_norm``
and ``adamw_update``, and the port's CPU path (autograd, the port's clip
and AdamW), and compares the card with each and the two with each other,
in f32: the loss and the loss after the step within 1e-5 and 1e-4
relative, the global and per-leaf gradient norms within 1e-4 relative,
and each leaf's 256 elements within 1e-3 of that slice's largest
magnitude (the packages and devices sum over 1,024 tokens in other
orders).  About 0.94 B f32 parameters (3.8 GB) per package, the packages
run one after the other, each leaf updated alone.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 lm_witness.py \
        chiprun_out/witness_lm_llama3-8b.npz
    JAX_PLATFORMS=cpu PYTHONPATH=src python3 lm_witness.py \
        chiprun_out/witness_train_qwen1.5-4b.npz

Prints one line per comparison and a JSON summary last; exits 1 beyond a
tolerance.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

REL_TOL = 5e-2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _reference(cfg, seed, tokens, fed):
    """The JAX reference's logits after the prefill and each decode step."""
    import jax.numpy as jnp
    from repro.models.lm import Model
    from repro.models.params import unflatten
    from repro_torch.models.params import numpy_params
    params = unflatten({p: jnp.asarray(a, jnp.bfloat16)
                        for p, a in numpy_params(cfg, seed)})
    model = Model(cfg)
    steps = len(fed)
    cache, logits = model.prefill(params, {"tokens": jnp.asarray(tokens)},
                                  cache_len=tokens.shape[1] + steps)
    out = [np.asarray(logits, np.float32)]
    for i, tok in enumerate(fed):
        logits, cache = model.decode(params, cache,
                                     jnp.asarray(tokens.shape[1] + i,
                                                 jnp.int32),
                                     jnp.asarray(tok))
        out.append(np.asarray(logits, np.float32))
    return out


def _port_cpu(cfg, seed, tokens, fed):
    """The port's CPU path, same parameters and tokens."""
    import torch
    from repro_torch.models.lm import Model
    from repro_torch.models.params import numpy_params, params_from_reference
    params = params_from_reference(numpy_params(cfg, seed), cfg, "cpu")
    model = Model(cfg, device="cpu")
    steps = len(fed)
    with torch.inference_mode():
        cache, logits = model.prefill(
            params, {"tokens": torch.from_numpy(tokens)},
            cache_len=tokens.shape[1] + steps)
        out = [logits.numpy().copy()]
        for i, tok in enumerate(fed):
            logits, cache = model.decode(params, cache, tokens.shape[1] + i,
                                         torch.from_numpy(tok))
            out.append(logits.numpy().copy())
    return out


TRAIN_TOL = dict(loss=1e-5, post_step_loss=1e-4, grad_norm=1e-4,
                 leaf_norms=1e-4, slices=1e-3)


def _train_reference(cfg, seed, batch, idx, lr):
    """The JAX reference's loss, gradient norms and slices, then the loss
    after one clipped AdamW step, leaf by leaf."""
    import jax
    import jax.numpy as jnp
    from repro.models.lm import Model
    from repro.models.params import unflatten
    from repro.training.optim import (adamw_init, adamw_update,
                                      clip_by_global_norm, global_norm)
    from repro_torch.models.params import numpy_params
    params = unflatten({p: jnp.asarray(a) for p, a in numpy_params(cfg, seed)})
    model = Model(cfg)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        params, b)
    paths = [p for p, _ in jax.tree_util.tree_leaves_with_path(grads)]
    flat = [np.asarray(g) for g in jax.tree.leaves(grads)]
    out = dict(loss=float(loss), grad_norm=float(global_norm(grads)),
               leaf_norms=np.array([np.linalg.norm(g.astype(np.float64))
                                    for g in flat]),
               slices=np.stack([g.reshape(-1)[i] for g, i in zip(flat, idx)]))
    del flat
    clipped, _ = clip_by_global_norm(grads, 1.0)
    del grads
    new = []
    for (path, p), g in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree.leaves(clipped)):
        one = {"x": p}
        new.append(adamw_update(one, {"x": g}, adamw_init(one),
                                jnp.float32(lr))[0]["x"])
    del clipped
    params = jax.tree.unflatten(jax.tree.structure(params), new)
    del new
    out["post_step_loss"] = float(jax.jit(model.loss)(params, b)[0])
    names = ["/".join(str(getattr(k, "key", k)) for k in p) for p in paths]
    return out, names


def _train_port_cpu(cfg, seed, batch, idx, lr):
    """The port's CPU path on the same parameters and batch."""
    import torch
    from repro_torch.models.lm import Model
    from repro_torch.models.params import numpy_params, params_from_reference
    from repro_torch.training.optim import (adamw_init, adamw_update,
                                            clip_by_global_norm, global_norm)
    from repro_torch.training.tree import (leaves, leaves_with_path,
                                           path_key, unflatten_like)
    params = params_from_reference(numpy_params(cfg, seed), cfg, "cpu")
    model = Model(cfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    ps = leaves(params)
    req = [p.detach().requires_grad_() for p in ps]
    loss, _ = model.loss(unflatten_like(params, req), b)
    grads = torch.autograd.grad(loss, req)
    del req
    out = dict(loss=float(loss.detach()),
               grad_norm=float(global_norm(list(grads))),
               leaf_norms=np.array([float(torch.linalg.vector_norm(
                   g.double())) for g in grads]),
               slices=np.stack([g.reshape(-1)[torch.from_numpy(i)].numpy()
                                for g, i in zip(grads, idx)]))
    clipped, _ = clip_by_global_norm(list(grads), 1.0)
    del grads
    with torch.no_grad():
        for p, g in zip(ps, clipped):
            adamw_update({"x": p}, {"x": g}, adamw_init({"x": p}),
                         torch.tensor(lr))
        del clipped
        out["post_step_loss"] = float(model.loss(params, b)[0])
    return out, [path_key(p) for p, _ in leaves_with_path(params)]


def _close(name, a, b):
    """(max deviation, within the tolerance) of one quantity."""
    if name == "slices":
        scale = np.maximum(np.abs(b).max(axis=1, keepdims=True), 1e-30)
        dev = float((np.abs(a - b) / scale).max())
    else:
        dev = float(np.max(np.abs(np.asarray(a, np.float64) - b)
                           / np.abs(np.asarray(b, np.float64))))
    return dev, dev <= TRAIN_TOL[name]


def main_train(w) -> int:
    from repro.configs.registry import get_config as ref_config
    from repro_torch.configs.registry import get_config
    arch, seed, layers = str(w["arch"]), int(w["seed"]), int(w["n_layers"])
    batch = {"tokens": w["tokens"].astype(np.int32),
             "labels": w["labels"].astype(np.int32)}
    idx, lr = w["slice_idx"].astype(np.int64), float(w["lr"])
    card = dict(loss=float(w["loss"]), grad_norm=float(w["grad_norm"]),
                leaf_norms=w["leaf_norms"], slices=w["slices"],
                post_step_loss=float(w["post_step_loss"]))
    names = [str(n) for n in w["leaf_names"]]
    t0 = time.perf_counter()
    ref, ref_names = _train_reference(
        dataclasses.replace(ref_config(arch), n_layers=layers,
                            dtype="float32"), seed, batch, idx, lr)
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu, cpu_names = _train_port_cpu(
        dataclasses.replace(get_config(arch), n_layers=layers,
                            dtype="float32"), seed, batch, idx, lr)
    t_cpu = time.perf_counter() - t0
    if not names == ref_names == cpu_names:
        print(f"[lm_witness] leaf order differs: {names} / {ref_names} / "
              f"{cpu_names}", file=sys.stderr)
        return 1
    checks = {}
    for pair, a, b in (("card vs reference", card, ref),
                       ("port CPU vs reference", cpu, ref),
                       ("card vs port CPU", card, cpu)):
        res = {k: _close(k, a[k], b[k]) for k in TRAIN_TOL}
        checks[pair] = {k: dict(max_rel=d, ok=ok) for k, (d, ok) in
                        res.items()}
        print(f"[lm_witness] train {pair}: " + "; ".join(
            f"{k} {d:.3e} (limit {TRAIN_TOL[k]:g})" for k, (d, _) in
            res.items()) + (": ok" if all(ok for _, ok in res.values())
                            else ": FAIL"))
    ok = all(c["ok"] for v in checks.values() for c in v.values())
    print(json.dumps(dict(kind="train", arch=arch, n_layers=layers,
                          seed=seed, batch=list(batch["tokens"].shape),
                          card_loss=card["loss"], reference_loss=ref["loss"],
                          card_post_step_loss=card["post_step_loss"],
                          reference_post_step_loss=ref["post_step_loss"],
                          checks=checks, reference_s=t_ref, port_cpu_s=t_cpu,
                          ok=ok)))
    return 0 if ok else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__.split("\n\n")[0], file=sys.stderr)
        return 2
    w = np.load(argv[0])
    if "kind" in w.files and str(w["kind"]) == "train":
        return main_train(w)
    from repro.configs.registry import get_config as ref_config
    from repro_torch.configs.registry import get_config
    arch, seed, layers = str(w["arch"]), int(w["seed"]), int(w["n_layers"])
    tokens, fed = w["tokens"].astype(np.int32), w["fed"].astype(np.int32)
    card = [w["prefill_logits"]] + list(w["decode_logits"])
    t0 = time.perf_counter()
    ref = _reference(dataclasses.replace(ref_config(arch), n_layers=layers),
                     seed, tokens, fed)
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = _port_cpu(dataclasses.replace(get_config(arch), n_layers=layers),
                    seed, tokens, fed)
    t_cpu = time.perf_counter() - t0
    checks = {}
    for name, a, b in (("card vs reference", card, ref),
                       ("port CPU vs reference", cpu, ref),
                       ("card vs port CPU", card, cpu)):
        rel = [_rel(x, y) for x, y in zip(a, b)]
        err = [float(np.max(np.abs(x - y))) for x, y in zip(a, b)]
        checks[name] = dict(rel=rel, max_abs=err,
                            ok=bool(max(rel) <= REL_TOL))
        print(f"[lm_witness] {name}: relative L2 per step (prefill, then "
              f"{len(fed)} decode steps) "
              f"{', '.join(f'{r:.3e}' for r in rel)}; max abs up to "
              f"{max(err):.3e}; limit {REL_TOL}: "
              f"{'ok' if checks[name]['ok'] else 'FAIL'}")
    agree = float(np.mean([np.array_equal(np.argmax(x, -1), np.argmax(y, -1))
                           for x, y in zip(card, ref)]))
    ok = all(c["ok"] for c in checks.values())
    print(json.dumps(dict(arch=arch, n_layers=layers, seed=seed,
                          batch=int(tokens.shape[0]), seq=int(tokens.shape[1]),
                          steps=int(len(fed)), checks=checks,
                          greedy_equal_share=agree,
                          reference_s=t_ref, port_cpu_s=t_cpu, ok=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

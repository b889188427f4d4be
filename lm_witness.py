#!/usr/bin/env python3
"""Holds the PyTorch port's LM serving path on the card against the JAX
reference at full width (llama3-8b: d_model 4096, 32 q / 8 kv heads, d_ff
14336, vocab 128256, bf16), cut to 2 layers so the host can run it.

``chip_smoke.py``'s lm phase draws that model's parameters with numpy from
its seed (``repro_torch.models.params.numpy_params``), runs a prefill of 4
× 32 tokens and 4 greedy decode steps on the card, and writes
``chiprun_out/witness_lm_llama3-8b.npz``: the seed, the depth, the tokens,
the tokens fed to each decode step, and the card's logits after the
prefill and after each step.  This script draws the same parameters again
on the CPU and runs, fed the same tokens:

1. the JAX reference (``repro.models.lm.Model``) in bf16;
2. the port's CPU path (``repro_torch.models.lm.Model(device="cpu")``).

It compares the card's logits with each, and the two CPU runs with each
other: the relative L2 distance over the batch, at the prefill and at every
decode step, must stay within 5e-2.  bf16 keeps 8 mantissa bits; the card,
the port's CPU path and XLA round the activations at different points, and
two layers at this width move the logits by about a percent, not more.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 lm_witness.py \\
        chiprun_out/witness_lm_llama3-8b.npz

About 3 GB of bf16 parameters per package and a few minutes of CPU.
Prints one line per comparison and a JSON summary last; exits 1 beyond the
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__.split("\n\n")[0], file=sys.stderr)
        return 2
    w = np.load(argv[0])
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

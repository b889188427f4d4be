"""Range-filtered beam search over the RNSG.

The search never materializes the induced subgraph: the range filter is an
id-interval mask applied to neighbor expansions (ids are attribute ranks),
and Theorem 4.7 (heredity) guarantees this equals searching the induced
RNSG.

Two expansion paths, as in the reference: ``beam_width=1`` expands one
node per hop with an exact visited set; ``beam_width=B>1`` expands the
best B unexpanded candidates per hop with a lossy two-probe visited table.
The hop loop runs through ``ops.beam_single`` / ``ops.beam_batched`` with
``use_kernel`` (on a CUDA tensor one fused kernel per batch,
``csrc/beam.cu``, one thread block per query running its loop to its end),
else through their plain version, the lockstep torch loops
``ref.beam_single_ref`` / ``ref.beam_batched_ref``.

With a quantized corpus (``quant=(data, scale)``) the traversal, entry
distances included, scores against the int8/bf16 copy, and the final ef
pool is rescored in f32 (``rerank_pool``) before the top-k is taken.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref

INF = float("inf")


def rerank_pool(vecs, pool_ids, qv, k: int, use_kernel: bool):
    """Exact f32 rescore of each query's candidate pool: the rerank stage
    of the quantized paths.  Ties go to the lower rank, the exact path's
    tie, whatever the pool's order: the plain version sorts the ids first
    (``sort_candidates``), the kernel keys on (dist, id).  ``use_kernel``
    runs the ``gather_rerank`` kernel for every k (the reference leaves its
    kernel above k = 128)."""
    if use_kernel:
        return ops.gather_rerank(vecs, pool_ids, qv, k=k)
    return ref.gather_rerank_ref(vecs, pool_ids, qv, k=k)


def _pool_finish(cand_d, cand_ids, live, k: int, quant):
    """Final pool stage: drop tombstoned candidates (``live`` (n,) bool —
    dead nodes stay traversable but never leave the search), then slice the
    top-k, or hand the whole pool to the f32 rerank under ``quant``.  The
    re-sort after masking is stable."""
    if live is not None:
        dead = (cand_ids < 0) | ~live[cand_ids.clamp_min(0)]
        cand_d = torch.where(dead, INF, cand_d)
        o = torch.argsort(cand_d, dim=1, stable=True)
        cand_d, cand_ids = cand_d.gather(1, o), cand_ids.gather(1, o)
    if quant is None:
        cand_d, cand_ids = cand_d[:, :k], cand_ids[:, :k]
    return (torch.where(torch.isfinite(cand_d), cand_ids, -1).to(torch.int32),
            cand_d)


def beam_search_batch(vecs: torch.Tensor, nbrs: torch.Tensor,
                      qv: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      entry: torch.Tensor, *, k: int = 10, ef: int = 64,
                      use_kernel: bool = False, beam_width: int = 1,
                      quant=None, live: torch.Tensor | None = None,
                      early_stop: bool = True):
    """vecs:(n,d) f32; nbrs:(n,m) i32; qv:(Q,d); lo/hi:(Q,) rank ids;
    entry:(Q,) or (Q,E) entry ranks.  Returns (ids:(Q,k) i32 rank ids (-1
    pad), dists:(Q,k) f32, stats {"hops", "ndist"} (Q,) i32), all on the
    device of ``vecs``.

    ``quant=(data, scale)`` scores the traversal against a quantized copy
    (``data``: (n,d) int8/bf16 in the same rank order; ``scale``: (d,) f32
    or None for bf16) and rescores the final pool in f32
    (``rerank_pool``), so whenever the pool saw every true neighbor the
    returned ids are the f32 ones.

    A lane stops after 8·ef+64 hops, or (``early_stop``, the default) as
    soon as no finite unexpanded candidate remains; without it a pool that
    never fills re-expands its best node until the cap, with the same
    answers and more hops (the reference's legacy condition).  ``beam_width=B>1``
    expands the best B candidates per iteration (clamped to ef); ``hops``
    then counts iterations.  ``live`` ((n,) bool) is the tombstone mask:
    dead nodes are traversed but filtered out of the final pool.
    ``use_kernel`` runs the hop loop through ``ops.beam_single`` /
    ``ops.beam_batched`` (one fused kernel per call on the card) and the
    quantized rerank through ``ops.gather_rerank``."""
    steps_cap = 8 * ef + 64
    dev = vecs.device
    qv = qv.to(device=dev, dtype=torch.float32)
    lo = lo.to(dev).long()
    hi = hi.to(dev).long()
    entry = entry.to(dev)
    if live is not None:
        live = live.to(device=dev, dtype=torch.bool)
    nq = qv.shape[0]
    if nq == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return (torch.zeros((0, k), dtype=torch.int32, device=dev),
                torch.zeros((0, k), dtype=torch.float32, device=dev),
                {"hops": z, "ndist": z})
    score = (vecs, None) if quant is None else quant
    kw = dict(ef=ef, steps_cap=steps_cap, early_stop=early_stop)
    if beam_width > 1:
        run = ops.beam_batched if use_kernel else ref.beam_batched_ref
        kw["beam_width"] = beam_width
    else:
        run = ops.beam_single if use_kernel else ref.beam_single_ref
    cand_d, cand_ids, steps, ndist = run(*score, nbrs, qv, lo, hi, entry,
                                         **kw)
    ids, dists = _pool_finish(cand_d, cand_ids, live, k, quant)
    if quant is not None:
        ids, dists = rerank_pool(vecs, ids, qv, k, use_kernel)
    return ids, dists, {"hops": steps.to(torch.int32),
                        "ndist": ndist.to(torch.int32)}

"""Range-filtered beam search over the RNSG, batched in lockstep in torch.

The search never materializes the induced subgraph: the range filter is an
id-interval mask applied to neighbor expansions (ids are attribute ranks),
and Theorem 4.7 (heredity) guarantees this equals searching the induced
RNSG.

The reference vmaps a per-query ``while_loop``.  Here every query of the
batch steps together: each iteration evaluates every lane's loop condition,
runs the body on the whole batch, and a lane whose condition is false keeps
its state unchanged (``torch.where``) and stops counting ``hops``/``ndist``
— exactly the per-lane results of the vmapped loop.  The loop ends when no
lane is left.

Two expansion paths, as in the reference:

* ``beam_width=1`` — single-node expansion: candidate pool = (Q, ef) re-
  sorted each hop by a stable argsort, visited set = (Q, n+1) bitmask.
  With ``use_kernel`` the neighbors are scored by the ``gather_dist``
  kernel.
* ``beam_width=B>1`` — batched expansion: each iteration pops the best B
  unexpanded candidates, scores their B·m neighbors in one fused call
  (``gather_topk`` when the fresh list fits its 128-lane bound, else
  ``gather_dist`` + sort), folds them into the sorted pool with a bounded
  merge, and tracks visited nodes in a fixed-size lossy 2-probe hash table.

With a quantized corpus (``quant=(data, scale)``) the traversal, entry
distances included, scores against the int8/bf16 copy, and the final ef
pool is rescored in f32 (``rerank_pool``) before the top-k is taken.

The parity points with the reference: stable argsorts everywhere, the
first-occurrence ``argmin``, the uint32 hash emulated in int64, the merge's
``searchsorted(side="left")``, and the hash table's scatter resolving
duplicate slots as XLA does (the last update wins).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.quantize import sort_candidates

INF = float("inf")

# Knuth / Murmur-style odd multipliers for the two probe hashes.
_HASH1 = 2654435761
_HASH2 = 2246822519


def visited_table_size(ef: int, m: int) -> int:
    """Slots in the per-query lossy visited table (power of two), ~half a
    slot per potential insertion, independent of n."""
    target = max(int(ef), 1) * max(int(m), 4) // 2
    size = 1 << (target - 1).bit_length()
    return int(min(max(size, 256), 1 << 13))


def _mul_u32(u: torch.Tensor, c: int) -> torch.Tensor:
    """(u * c) mod 2**32 for u in [0, 2**32), without int64 overflow."""
    lo = (u & 0xFFFF) * c
    hi = ((u >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & 0xFFFFFFFF


def _hash_slots(ids: torch.Tensor,
                size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent probe slots in [0, size) for each id (size pow2):
    the reference's uint32 multiply-shift, wrapping mod 2**32."""
    bits = int(size).bit_length() - 1
    u = ids & 0xFFFFFFFF                       # the id's uint32 bit pattern
    return (_mul_u32(u, _HASH1) >> (32 - bits),
            _mul_u32(u, _HASH2) >> (32 - bits))


def _table_insert(table: torch.Tensor, ids: torch.Tensor,
                  size: int) -> None:
    """Insert ids (−1 = skip) into each row's 2-probe table ((Q, size+1),
    slot ``size`` is the write sink), in place.  First probe wins if its
    slot is empty or already holds the id; otherwise the second probe is
    overwritten.  Where two ids of one insert land on one slot, the later
    id wins, as XLA's scatter applies the reference's updates in order."""
    valid = ids >= 0
    h1, h2 = _hash_slots(ids, size)
    cur = table.gather(1, h1)
    slot = torch.where((cur == -1) | (cur == ids), h1, h2)
    slot = torch.where(valid, slot, size)
    f = ids.shape[1]
    ar = torch.arange(f, device=ids.device)
    later = ((slot[:, :, None] == slot[:, None, :])
             & (ar[None, :] > ar[:, None])[None])
    slot = torch.where(later.any(2), size, slot)     # overwritten: to the sink
    table.scatter_(1, slot, torch.where(valid, ids, -1))


def _table_lookup(table: torch.Tensor, ids: torch.Tensor,
                  size: int) -> torch.Tensor:
    """Membership test: exact-positive, lossy-negative."""
    h1, h2 = _hash_slots(ids, size)
    return (table.gather(1, h1) == ids) | (table.gather(1, h2) == ids)


def _merge_sorted(pool_d, pool_i, pool_e, fresh_d, fresh_i, fresh_e,
                  ef: int):
    """Stable bounded merge of two distance-sorted candidate lists (per
    row) into the best ``ef``: pool entries win distance ties."""
    nq, f = fresh_d.shape
    j = torch.arange(ef, device=pool_d.device).expand(nq, ef).contiguous()
    pos_p = j + torch.searchsorted(fresh_d.contiguous(),            # sorted-merge
                                   pool_d.contiguous(), right=False)
    i = torch.searchsorted(pos_p, j, right=False)                   # sorted-merge
    ic = i.clamp_max(ef - 1)
    is_pool = pos_p.gather(1, ic) == j
    jf = (j - i).clamp(0, f - 1)
    md = torch.where(is_pool, pool_d.gather(1, ic), fresh_d.gather(1, jf))
    mi = torch.where(is_pool, pool_i.gather(1, ic), fresh_i.gather(1, jf))
    me = torch.where(is_pool, pool_e.gather(1, ic), fresh_e.gather(1, jf))
    return md, mi, me


def rerank_pool(vecs, pool_ids, qv, k: int, use_kernel: bool):
    """Exact f32 rescore of each query's candidate pool: the rerank stage
    of the quantized paths.  Pool ids are sorted ascending first
    (``sort_candidates``) so the top-k's tie toward the lower input index
    is the exact path's tie toward the lower rank.  ``use_kernel`` runs the
    ``gather_rerank`` kernel for every k (the reference leaves its kernel
    above k = 128)."""
    ids_s = sort_candidates(pool_ids)                        # (Q, M)
    if use_kernel:
        return ops.gather_rerank(vecs, ids_s, qv, k=k)
    return ref.gather_rerank_ref(vecs, ids_s, qv, k=k)


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


def _row_dists(x, ids, q, scale=None):
    """Plain Σ(x·scale−q)² of each id's row (ids ≥ 0) against its query
    row, the row upcast to f32 first."""
    diff = ref.dequantized_rows(x, ids, scale) - q[:, None, :]
    return torch.sum(diff * diff, dim=-1)


def _go(cand_d, expanded, steps, steps_cap: int, early_stop: bool = True):
    """Per-lane loop condition of the reference's ``while_loop``;
    ``early_stop`` also ends a lane with no finite unexpanded candidate."""
    best = torch.where(~expanded, cand_d, INF).amin(1)
    fin = torch.isfinite(cand_d)
    worst = torch.where(fin, cand_d, -INF).amax(1)
    worst = torch.where((~fin).any(1), INF, worst)
    go = (best <= worst) & (steps < steps_cap)
    return go & torch.isfinite(best) if early_stop else go


def _init_pool(x, scale, qv, lo, hi, entry, ef: int):
    """Entry candidates of every lane: ids, distances (against x/scale, the
    corpus the traversal scores), expanded flags and the in-range entry
    mask."""
    n = x.shape[0]
    nq = qv.shape[0]
    e0 = entry.reshape(nq, -1)[:, :ef].long()                 # (Q,E) multi-entry
    ev = (e0 >= 0) & ~(lo > hi)[:, None]
    e0c = e0.clamp(0, n - 1)
    ne = e0.shape[1]
    nv0 = ref.dequantized_rows(x, e0c, scale)
    d0 = torch.where(ev, torch.sum(torch.square(nv0 - qv[:, None, :]),
                                   dim=-1), INF)
    cand_ids = torch.full((nq, ef), -1, dtype=torch.long, device=qv.device)
    cand_d = torch.full((nq, ef), INF, dtype=torch.float32, device=qv.device)
    expanded = torch.zeros((nq, ef), dtype=torch.bool, device=qv.device)
    cand_ids[:, :ne] = e0c
    cand_d[:, :ne] = d0
    expanded[:, :ne] = ~ev
    return cand_d, cand_ids, expanded, e0c, ev


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
    dead nodes are traversed but filtered out of the final pool."""
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
    if beam_width > 1:
        cand_d, cand_ids, steps, ndist = _beam_batched(
            *score, nbrs, qv, lo, hi, entry, ef=ef, steps_cap=steps_cap,
            use_kernel=use_kernel, beam_width=beam_width,
            early_stop=early_stop)
    else:
        cand_d, cand_ids, steps, ndist = _beam_single(
            *score, nbrs, qv, lo, hi, entry, ef=ef, steps_cap=steps_cap,
            use_kernel=use_kernel, early_stop=early_stop)
    ids, dists = _pool_finish(cand_d, cand_ids, live, k, quant)
    if quant is not None:
        ids, dists = rerank_pool(vecs, ids, qv, k, use_kernel)
    return ids, dists, {"hops": steps.to(torch.int32),
                        "ndist": ndist.to(torch.int32)}


def _beam_single(x, scale, nbrs, qv, lo, hi, entry, *, ef: int,
                 steps_cap: int, use_kernel: bool, early_stop: bool):
    """Single-node expansion; x/scale: the corpus the traversal scores."""
    n = nbrs.shape[0]
    nq = qv.shape[0]
    dev = x.device
    cand_d, cand_ids, expanded, e0c, ev = _init_pool(x, scale, qv, lo, hi,
                                                     entry, ef)
    visited = torch.zeros((nq, n + 1), dtype=torch.bool, device=dev)
    visited.scatter_(1, torch.where(ev, e0c, n), True)
    steps = torch.zeros(nq, dtype=torch.long, device=dev)
    ndist = torch.zeros(nq, dtype=torch.long, device=dev)
    rows = torch.arange(nq, device=dev)

    while True:
        act = _go(cand_d, expanded, steps, steps_cap, early_stop)
        if not bool(act.any()):
            break
        bi = torch.where(~expanded, cand_d, INF).argmin(1)   # first minimum
        exp_n = expanded.clone()
        exp_n[rows, bi] = True
        node = cand_ids[rows, bi].clamp_min(0)
        nb32 = nbrs[node]                       # (Q,m) i32, as the kernel takes
        nb = nb32.long()
        valid = (nb >= 0) & (nb >= lo[:, None]) & (nb <= hi[:, None])
        nbc = nb.clamp_min(0)
        valid &= ~visited.gather(1, nbc)
        valid &= act[:, None]                   # a finished lane is frozen
        visited.scatter_(1, torch.where(valid, nb, n), True)
        if use_kernel:
            d_nb = ops.gather_dist(x, nb32, qv, scale)
        else:
            d_nb = _row_dists(x, nbc, qv, scale)
        d_nb = torch.where(valid, d_nb, INF)
        ids_all = torch.cat([cand_ids, nb], dim=1)
        d_all = torch.cat([cand_d, d_nb], dim=1)
        exp_all = torch.cat([exp_n, ~valid], dim=1)           # invalid: never expand
        order = torch.argsort(d_all, dim=1, stable=True)[:, :ef]
        a = act[:, None]
        cand_d = torch.where(a, d_all.gather(1, order), cand_d)
        expanded = torch.where(a, exp_all.gather(1, order), expanded)
        cand_ids = torch.where(a, ids_all.gather(1, order), cand_ids)
        steps += act
        ndist += valid.sum(1)
    return cand_d, cand_ids, steps, ndist


def _beam_batched(x, scale, nbrs, qv, lo, hi, entry, *, ef: int,
                  steps_cap: int, use_kernel: bool, beam_width: int,
                  early_stop: bool):
    """Batched expansion; x/scale: the corpus the traversal scores."""
    n, m = nbrs.shape
    nq = qv.shape[0]
    dev = x.device
    # the pool holds ef candidates, so at most ef can be unexpanded
    B = min(int(beam_width), ef)
    F = B * m                           # fresh neighbors per iteration
    H = visited_table_size(ef, m)
    # only the best min(F, ef) fresh candidates can survive the merge
    fm = min(F, ef)
    kernel_topk = use_kernel and fm <= 128

    def fresh_sorted(ids_f, ids32, valid):
        """(Q,F) masked neighbor ids (int64, and the int32 copy the kernels
        take) -> distance-sorted (Q,fm) fresh list (ids -1 / dist inf beyond
        the valid entries)."""
        if kernel_topk:
            fi, fd = ops.gather_topk(x, torch.where(valid, ids32, -1), qv,
                                     k=fm, scale=scale)
            return fd, fi.long()
        ids_m = torch.where(valid, ids_f, -1)
        if use_kernel:
            d = ops.gather_dist(x, ids32, qv, scale)
        else:
            d = _row_dists(x, ids_f.clamp_min(0), qv, scale)
        d = torch.where(valid, d, INF)
        o = torch.argsort(d, dim=1, stable=True)[:, :fm]
        return d.gather(1, o), ids_m.gather(1, o)

    cand_d, cand_ids, expanded, e0c, ev = _init_pool(x, scale, qv, lo, hi,
                                                     entry, ef)
    o = torch.argsort(cand_d, dim=1, stable=True)   # the merge keeps it sorted
    cand_d, cand_ids = cand_d.gather(1, o), cand_ids.gather(1, o)
    expanded = expanded.gather(1, o)
    table = torch.full((nq, H + 1), -1, dtype=torch.long, device=dev)
    _table_insert(table, torch.where(ev, e0c, -1), H)
    steps = torch.zeros(nq, dtype=torch.long, device=dev)
    ndist = torch.zeros(nq, dtype=torch.long, device=dev)
    ar_ef = torch.arange(ef, device=dev)
    ar_f = torch.arange(F, device=dev)
    before = ar_f[None, :] < ar_f[:, None]           # before[i, j]: j < i

    while True:
        act = _go(cand_d, expanded, steps, steps_cap, early_stop)
        if not bool(act.any()):
            break
        # best B unexpanded: the pool is sorted, so the first B selectable
        lane = torch.where(~expanded & torch.isfinite(cand_d), ar_ef, ef)
        lanes = torch.sort(lane, dim=1).values[:, :B]              # (Q,B)
        take = lanes < ef
        node = torch.where(take, cand_ids.gather(1, lanes.clamp_max(ef - 1)),
                           -1)
        exp_n = expanded | torch.any((ar_ef[None, None, :] == lanes[:, :, None])
                                     & take[:, :, None], dim=1)
        ids32 = nbrs[node.clamp_min(0)].reshape(nq, F)
        ids_f = ids32.long()
        valid = ((ids_f >= 0) & (ids_f >= lo[:, None]) & (ids_f <= hi[:, None])
                 & (node >= 0).repeat_interleave(m, dim=1))
        # intra-hop dedup: keep the first occurrence of a shared neighbor
        eq = ids_f[:, :, None] == ids_f[:, None, :]
        valid &= ~torch.any(eq & before[None] & valid[:, None, :], dim=2)
        # pool-membership dedup: anything held in the pool is scored
        valid &= ~torch.any(ids_f[:, :, None] == cand_ids[:, None, :], dim=2)
        # lossy visited set: false negatives fall through to a re-score
        valid &= ~_table_lookup(table, ids_f, H)
        valid &= act[:, None]                   # a finished lane is frozen
        _table_insert(table, torch.where(valid, ids_f, -1), H)
        fd, fi = fresh_sorted(ids_f, ids32, valid)
        md, mi, me = _merge_sorted(cand_d, cand_ids, exp_n, fd, fi, fi < 0, ef)
        a = act[:, None]
        cand_d = torch.where(a, md, cand_d)
        cand_ids = torch.where(a, mi, cand_ids)
        expanded = torch.where(a, me, expanded)
        steps += act
        ndist += valid.sum(1)
    return cand_d, cand_ids, steps, ndist

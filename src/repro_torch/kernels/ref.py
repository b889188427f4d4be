"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, with the reference
kernel's contract: ``-1``/``+inf`` pads, ``n_valid``, ``live`` and the
128-aligned scan window.  The wrappers in ``repro_torch.kernels.ops`` run
these for tensors on the CPU (the tests hold them against the reference's
Pallas kernels); ``chip_smoke.py`` holds the CUDA kernels against them on
the card.

Top-k is a stable ascending sort of the distances, i.e. the lexicographic
key (dist, position), which is the tie order of ``lax.top_k`` and of the
reference kernels' first-occurrence select-min.

A corpus ``x`` may be f32 or a quantized copy (int8/bf16, see
``repro_torch.kernels.quantize``): rows are upcast to f32 and multiplied
by the optional (d,) f32 ``scale`` before scoring, as the kernels do.

The fused beam kernels (``csrc/beam.cu``) have the lockstep hop loops
``beam_single_ref`` / ``beam_batched_ref`` as their plain version; their
entry pool (``init_pool``) and visited-table size are shared with the
kernels' wrapper (``repro_torch.kernels.beam``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.quantize import sort_candidates
from repro_torch.kernels.range_scan import window_rows

INF = float("inf")


def _smallest(d: torch.Tensor, ids: torch.Tensor, k: int):
    """Per-row k smallest of ``d`` by (dist, position), with the ids that
    ride along; rows shorter than k are padded with (+inf, -1), and any
    non-finite survivor comes back as id -1."""
    short = k - d.shape[1]
    if short > 0:
        d = torch.nn.functional.pad(d, (0, short), value=INF)
        ids = torch.nn.functional.pad(ids, (0, short), value=-1)
    o = torch.argsort(d, dim=1, stable=True)[:, :k]
    dk = d.gather(1, o)
    ik = torch.where(torch.isfinite(dk), ids.gather(1, o), -1)
    return ik.to(torch.int32), dk


def l2dist_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q,d) × (N,d) -> (Q,N) squared L2, f32 accumulation: the expansion
    form ‖q‖² − 2 q·x + ‖x‖², clamped at 0 (IEEE f32: TF32 is off
    package-wide)."""
    qf, xf = q.float(), x.float()
    qn = torch.sum(qf * qf, dim=-1, keepdim=True)
    xn = torch.sum(xf * xf, dim=-1)
    return torch.clamp_min(qn - 2.0 * (qf @ xf.T) + xn[None, :], 0.0)


def dequantized_rows(x: torch.Tensor, idx: torch.Tensor,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """f32 rows ``x[idx]`` (any index shape), times ``scale`` when given."""
    rows = x[idx].float()
    return rows if scale is None else rows * scale


def gather_dist_ref(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor | None = None) -> torch.Tensor:
    """x:(N,d) f32/int8/bf16; ids:(Q,M) (clipped to [0, N-1]); q:(Q,d) ->
    (Q,M) Σ(x·scale−q)², the difference form of ``gather_dist_pallas``."""
    rows = dequantized_rows(x, ids.long().clamp(0, x.shape[0] - 1), scale)
    diff = rows - q[:, None, :]
    return torch.sum(diff * diff, dim=-1)


def gather_topk_ref(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, *,
                    k: int, scale: torch.Tensor | None = None):
    """(Q,M) ids, negative = masked -> per-query (ids:(Q,k) i32 ascending
    distance (-1 pad), dists:(Q,k) f32 (+inf pad)), ties toward the lower
    input position."""
    ids = ids.long()
    d = torch.where(ids >= 0, gather_dist_ref(x, ids, q, scale), INF)
    return _smallest(d, ids, k)


def gather_rerank_ref(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, *,
                      k: int):
    """The f32 rerank: x:(N,d) f32; ids:(Q,M) survivor ranks in any order
    (negative = masked); q:(Q,d) -> (ids:(Q,k), dists:(Q,k)), ties toward
    the lower id: the ids sorted ascending (``sort_candidates``), then the
    reference's batched ``gather_rerank_ref`` (ties toward the lower input
    index), for every k."""
    return gather_topk_ref(x, sort_candidates(ids), q, k=k)


def range_scan_ref(x: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                   q: torch.Tensor, *, bucket: int, k: int,
                   n_valid: int = 0, live: torch.Tensor | None = None,
                   scale: torch.Tensor | None = None):
    """x:(n_pad,d_pad) rank-ordered; starts/lens:(Q,); q:(Q,d_pad) ->
    (ids:(Q,k) i32 absolute ranks (-1 pad), dists:(Q,k) f32 (+inf pad)).

    Scores the ``window_rows(bucket)`` rows from the 128-aligned block at or
    below each start, masks ranks outside ``[start, start+len)``, at or past
    ``n_valid``, or with ``live[rank] == 0`` (``live``: (n_pad,)), and uses
    the Pallas kernel's **expansion form** max(‖q‖²−2q·x+‖x‖², 0) — not the
    difference form of the reference's ``range_scan_ref``.  A quantized
    ``x`` is dequantized (``scale``: (d_pad,) f32) before the expansion, as
    the Pallas body does."""
    n_pad = x.shape[0]
    n_valid = int(n_valid) or n_pad
    w = window_rows(bucket)
    starts = starts.long()
    lens = lens.long()
    base = torch.div(starts, 128, rounding_mode="floor") * 128
    rank = base[:, None] + torch.arange(w, device=x.device)[None, :]   # (Q,w)
    rc = rank.clamp(0, n_pad - 1)
    rows = dequantized_rows(x, rc, scale)                              # (Q,w,d)
    dot = torch.einsum("qwd,qd->qw", rows, q)
    qn = torch.sum(q * q, dim=1, keepdim=True)
    xn = torch.sum(rows * rows, dim=-1)
    d2 = torch.clamp_min(-2.0 * dot + qn + xn, 0.0)
    valid = ((rank >= starts[:, None]) & (rank < (starts + lens)[:, None])
             & (rank < n_valid))
    if live is not None:
        valid &= live.reshape(-1)[rc] != 0
    d2 = torch.where(valid, d2, INF)
    return _smallest(d2, rank, k)


# --- the beam's hop loop: the plain version of csrc/beam.cu -------------
#
# The reference vmaps a per-query ``while_loop``.  Here every query of the
# batch steps together: each iteration evaluates every lane's loop
# condition, runs the body on the whole batch, and a lane whose condition is
# false keeps its state unchanged (``torch.where``) and stops counting
# ``hops``/``ndist`` — exactly the per-lane results of the vmapped loop.
# The loop ends when no lane is left.
#
# * ``beam_width=1`` — single-node expansion: candidate pool = (Q, ef)
#   re-sorted each hop by a stable argsort, visited set = (Q, n+1) bitmask.
# * ``beam_width=B>1`` — batched expansion: each iteration pops the best B
#   unexpanded candidates, scores their B·m neighbors, keeps the best
#   min(B·m, ef) of them sorted, folds them into the sorted pool with a
#   bounded merge, and tracks visited nodes in a fixed-size lossy 2-probe
#   hash table.
#
# The parity points with the reference: stable argsorts everywhere, the
# first-occurrence ``argmin``, the uint32 hash emulated in int64, the
# merge's ``searchsorted(side="left")``, and the hash table's scatter
# resolving duplicate slots as XLA does (the last update wins).

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


def hash_slots(ids: torch.Tensor,
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
    h1, h2 = hash_slots(ids, size)
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
    h1, h2 = hash_slots(ids, size)
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


def _go(cand_d, expanded, steps, steps_cap: int, early_stop: bool = True):
    """Per-lane loop condition of the reference's ``while_loop``;
    ``early_stop`` also ends a lane with no finite unexpanded candidate."""
    best = torch.where(~expanded, cand_d, INF).amin(1)
    fin = torch.isfinite(cand_d)
    worst = torch.where(fin, cand_d, -INF).amax(1)
    worst = torch.where((~fin).any(1), INF, worst)
    go = (best <= worst) & (steps < steps_cap)
    return go & torch.isfinite(best) if early_stop else go


def init_pool(x, scale, qv, lo, hi, entry, ef: int):
    """Entry candidates of every lane: ids, distances (against x/scale, the
    corpus the traversal scores), expanded flags and the in-range entry
    mask."""
    n = x.shape[0]
    nq = qv.shape[0]
    e0 = entry.reshape(nq, -1)[:, :ef].long()                 # (Q,E) multi-entry
    ev = (e0 >= 0) & ~(lo > hi)[:, None]
    e0c = e0.clamp(0, n - 1)
    ne = e0.shape[1]
    nv0 = dequantized_rows(x, e0c, scale)
    d0 = torch.where(ev, torch.sum(torch.square(nv0 - qv[:, None, :]),
                                   dim=-1), INF)
    cand_ids = torch.full((nq, ef), -1, dtype=torch.long, device=qv.device)
    cand_d = torch.full((nq, ef), INF, dtype=torch.float32, device=qv.device)
    expanded = torch.zeros((nq, ef), dtype=torch.bool, device=qv.device)
    cand_ids[:, :ne] = e0c
    cand_d[:, :ne] = d0
    expanded[:, :ne] = ~ev
    return cand_d, cand_ids, expanded, e0c, ev


def beam_single_ref(x, scale, nbrs, qv, lo, hi, entry, *, ef: int,
                    steps_cap: int, early_stop: bool):
    """Single-node expansion; x/scale: the corpus the traversal scores.
    The plain version of ``ops.beam_single``."""
    n = nbrs.shape[0]
    nq = qv.shape[0]
    dev = x.device
    cand_d, cand_ids, expanded, e0c, ev = init_pool(x, scale, qv, lo, hi,
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
        nb = nbrs[node].long()                  # (Q,m)
        valid = (nb >= 0) & (nb >= lo[:, None]) & (nb <= hi[:, None])
        nbc = nb.clamp_min(0)
        valid &= ~visited.gather(1, nbc)
        valid &= act[:, None]                   # a finished lane is frozen
        visited.scatter_(1, torch.where(valid, nb, n), True)
        d_nb = torch.where(valid, gather_dist_ref(x, nbc, qv, scale), INF)
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


def beam_batched_ref(x, scale, nbrs, qv, lo, hi, entry, *, ef: int,
                     steps_cap: int, beam_width: int, early_stop: bool):
    """Batched expansion; x/scale: the corpus the traversal scores.  The
    plain version of ``ops.beam_batched``."""
    n, m = nbrs.shape
    nq = qv.shape[0]
    dev = x.device
    # the pool holds ef candidates, so at most ef can be unexpanded
    B = min(int(beam_width), ef)
    F = B * m                           # fresh neighbors per iteration
    H = visited_table_size(ef, m)
    # only the best min(F, ef) fresh candidates can survive the merge
    fm = min(F, ef)

    def fresh_sorted(ids_f, valid):
        """(Q,F) masked neighbor ids -> distance-sorted (Q,fm) fresh list
        (ids -1 / dist inf beyond the valid entries): the (dist, position)
        top-k of ``gather_topk``."""
        ids_m = torch.where(valid, ids_f, -1)
        d = torch.where(valid,
                        gather_dist_ref(x, ids_f.clamp_min(0), qv, scale),
                        INF)
        o = torch.argsort(d, dim=1, stable=True)[:, :fm]
        return d.gather(1, o), ids_m.gather(1, o)

    cand_d, cand_ids, expanded, e0c, ev = init_pool(x, scale, qv, lo, hi,
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
        ids_f = nbrs[node.clamp_min(0)].reshape(nq, F).long()
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
        fd, fi = fresh_sorted(ids_f, valid)
        md, mi, me = _merge_sorted(cand_d, cand_ids, exp_n, fd, fi, fi < 0, ef)
        a = act[:, None]
        cand_d = torch.where(a, md, cand_d)
        cand_ids = torch.where(a, mi, cand_ids)
        expanded = torch.where(a, me, expanded)
        steps += act
        ndist += valid.sum(1)
    return cand_d, cand_ids, steps, ndist

"""Baselines the paper compares against, on the same substrate:

* ``BruteForceIndex``   — pre-filtering (exact linear scan; also ground truth).
* ``MRNGIndex``         — spatial-only approximate-MRNG graph with
                          ``in-filter`` and ``post-filter`` query modes.
* ``SegmentTreeIndex``  — iRangeGraph-like: one elemental (MRNG-pruned) graph
                          per segment-tree node; queries decompose the rank
                          interval into maximal aligned blocks and search the
                          composed graph with one entry per canonical block.

All share ids = attribute ranks and squared-L2 distances.  Builds and
searches run on the index's device (default the card); the host keeps the
numpy arrays the reference keeps.  The segment tree's block-local KNN runs
through the ``l2dist`` kernel (``repro_torch.kernels.ops.l2dist``) in row
tiles, so no level needs an n × n matrix on the host.

Where the reference steps through every edge or node in Python
(``add_reverse_edges``, the per-block connectivity check, the component
labelling of ``connectivity_repair``, ``_canonical_entries``), the port
computes the same arrays with array operations; the tests hold each
against the reference.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core.beam import beam_search_batch
from repro_torch.core.entry import build_rmq, centroid_dists, rmq_query_np
from repro_torch.core.pruning import pack_kept, prune_side
from repro_torch.data.ann import ground_truth
from repro_torch.device import resolve_device
from repro_torch.index.knn import exact_knn, smallest_k, sq_dists
from repro_torch.kernels import ops
from repro_torch.search import rank_interval, remap_ids, select_entry

INF = float("inf")
#: rows of one ``l2dist`` call in the segment tree's block KNN: levels whose
#: blocks are no larger are computed KNN_TILE rows at a time with the
#: other blocks masked; larger blocks in KNN_TILE-row slices of the block
KNN_TILE = 4096


def _stats_np(st: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in st.items()}


def mrng_prune_graph(vecs, knn_ids: np.ndarray, m: int,
                     block: int = 8192) -> np.ndarray:
    """Plain MRNG/NSG pruning: scan candidates by ascending distance, keep v_i
    iff no kept v_j with d(x,v_j) < d(x,v_i) and d(v_j,v_i) < d(x,v_i).
    ``vecs`` (n, d) on the device to prune on (an array means the CPU);
    ``knn_ids`` (n, C) ascending distance, -1 pad.  Returns (n, m) int32,
    the kept candidates in candidate order, -1 pad.  Every row is
    independent, so ``block`` cannot change a row."""
    v = torch.as_tensor(vecs, dtype=torch.float32)
    n = v.shape[0]
    cand = torch.as_tensor(np.array(knn_ids, np.int32),
                           device=v.device).long()
    out = []
    for lo in range(0, n, block):
        ci = cand[lo:lo + block]
        kept = prune_side(v[lo:lo + block], ci, v[ci.clamp_min(0)], m)
        out.append(pack_kept(ci, kept, ci[:, :0], kept[:, :0], m)
                   .cpu().numpy())
    if not out:
        return np.full((0, m), -1, np.int32)
    return np.concatenate(out)


def add_reverse_edges(nbrs: np.ndarray, cap: int, device=None) -> np.ndarray:
    """NSG-style reverse-edge augmentation, degree-capped: the reference's
    sequential loop, as array operations on ``device`` (``None``: the card,
    raising without one).

    The loop visits sources u in ascending order and each row's ids up to
    its first -1; it appends u to row v when v has room (fewer than ``cap``
    filled slots) and u is not yet among v's first ``fill[v]`` slots, where
    ``fill`` starts at the row's count of ids >= 0.  Appended ids are the
    earlier sources, all different from u, so u is skipped exactly when it
    stands in the first ``fill[v]`` slots of the input row; the loop thus
    appends, in ascending order, the first cap − fill[v] such sources,
    from slot fill[v] on."""
    dev = resolve_device(device)
    nb = torch.as_tensor(np.asarray(nbrs, np.int32), device=dev).long()
    n, m = nb.shape
    ext = torch.full((n, cap), -1, dtype=torch.long, device=dev)
    ext[:, :m] = nb
    fill = (nb >= 0).sum(1)
    col = torch.arange(m, device=dev)
    neg = nb < 0
    first_neg = torch.where(neg.any(1), neg.int().argmax(1), m)
    src, slot = torch.nonzero(col[None, :] < first_neg[:, None], as_tuple=True)
    key = torch.unique(nb[src, slot] * n + src)        # (v, u) by v, then u
    pv, ps = torch.nonzero(col[None, :] < fill[:, None], as_tuple=True)
    w = nb[pv, ps]
    have = torch.unique(pv[w >= 0] * n + w[w >= 0])    # u already in row v
    key = key[~torch.isin(key, have)]
    v = torch.div(key, n, rounding_mode="floor")
    u = key - v * n
    rank = torch.arange(len(key), device=dev) - torch.searchsorted(v, v)
    take = rank < cap - fill[v]
    v, u, rank = v[take], u[take], rank[take]
    ext[v, fill[v] + rank] = u
    return ext.to(torch.int32).cpu().numpy()


def _reach(nbrs: np.ndarray, seen: np.ndarray,
           frontier: np.ndarray) -> np.ndarray:
    """Mark, in place, every node reachable from ``frontier`` (already
    marked) through edges ``nbrs`` (-1 = none) and unmarked nodes; returns
    the nodes marked, the frontier's included."""
    got = [frontier]
    while len(frontier):
        nxt = nbrs[frontier].ravel()
        nxt = nxt[nxt >= 0]
        nxt = np.unique(nxt[~seen[nxt]])
        seen[nxt] = True
        got.append(nxt)
        frontier = nxt
    return np.concatenate(got)


def _closest_pair(a: torch.Tensor, b: torch.Tensor, rows: int = 4096):
    """(i, j) of the smallest sq_dists(a, b) entry, the first in row-major
    order on ties (``np.argmin`` of the full matrix), computed in row
    slices."""
    best, at = INF, (0, 0)
    for lo in range(0, a.shape[0], rows):
        d = sq_dists(a[lo:lo + rows], b)
        mn = float(d.min())
        if mn < best or lo == 0:
            flat = int(torch.nonzero(d.reshape(-1) == mn)[0])
            best, at = mn, (lo + flat // b.shape[0], flat % b.shape[0])
    return at


def connectivity_repair(nbrs: np.ndarray, vecs: np.ndarray, entry: int,
                        device=None) -> np.ndarray:
    """NSG-style tree growing: label undirected components once, then link
    every stray component to the entry's component through its closest cross
    pair (bidirectional; may evict the worst slot).

    The labelling is the reference's: sources in ascending order, each
    unlabelled source labelling what it reaches through unlabelled nodes (a
    frontier walk here, a depth-first one there: the same set), then the
    same four sweeps of label merging across edges, which may leave a
    component split.  The cross-pair distances run on ``device``
    (``None``: the card, raising without one)."""
    n, m = nbrs.shape
    nbrs = nbrs.copy()
    comp = np.full(n, -1, np.int64)
    seen = np.zeros(n, bool)
    cid = 0
    for src in range(n):
        if seen[src]:
            continue
        seen[src] = True
        comp[_reach(nbrs, seen, np.asarray([src]))] = cid
        cid += 1
    # undirected closure: merge labels across reverse edges (a few sweeps)
    for _ in range(4):
        changed = False
        src = np.repeat(np.arange(n), m)
        dst = nbrs.reshape(-1)
        ok = dst >= 0
        a, b = comp[src[ok]], comp[dst[ok]]
        lo = np.minimum(a, b)
        if np.any(a != lo):
            remap = np.arange(cid)
            np.minimum.at(remap, np.maximum(a, b), lo)
            while np.any(remap[remap] != remap):
                remap = remap[remap]
            comp = remap[comp]
            changed = True
        if not changed:
            break
    main = comp[entry]
    vmain = np.flatnonzero(comp == main)
    dev = resolve_device(device)
    v_main = torch.as_tensor(vecs[vmain], device=dev)
    for c in np.unique(comp):
        if c == main:
            continue
        members = np.flatnonzero(comp == c)
        oi, ii = _closest_pair(torch.as_tensor(vecs[members], device=dev),
                               v_main)
        u, v = int(members[oi]), int(vmain[ii])
        for a, b in ((u, v), (v, u)):
            row = nbrs[a]
            slot = int(np.argmax(row < 0)) if (row < 0).any() else m - 1
            nbrs[a, slot] = b
    return nbrs


def _sorted_corpus(vectors, attrs):
    order = np.argsort(attrs, kind="stable")
    return (np.asarray(vectors, np.float32)[order],
            np.asarray(attrs, np.float32)[order], order.astype(np.int32))


# ----------------------------------------------------------------------
class BruteForceIndex:
    """Pre-filtering: exact scan over the in-range subset."""

    def __init__(self, vectors, attrs, *, device=None):
        self.vecs, self.attrs, self.order = _sorted_corpus(vectors, attrs)
        self.build_seconds = 0.0
        self._attach(device)

    def _attach(self, device):
        self.device = resolve_device(device)
        self._v = torch.as_tensor(self.vecs, device=self.device)
        self._a = torch.as_tensor(self.attrs, device=self.device)

    def search(self, queries, attr_ranges, *, k=10, **_):
        ids, d = ground_truth(self._v, self._a, queries, attr_ranges, k,
                              device=self.device)
        return remap_ids(self.order, ids), d, {}

    @property
    def index_bytes(self):
        return 0  # no graph structure


# ----------------------------------------------------------------------
class MRNGIndex:
    """Spatial-only graph (the paper's Fig.1 failure case under ranges)."""

    def __init__(self, vectors, attrs, *, m=32, ef_spatial=64,
                 mode: str = "infilter", oversample: int = 4, device=None):
        t0 = time.perf_counter()
        dev = resolve_device(device)
        self.vecs, self.attrs, self.order = _sorted_corpus(vectors, attrs)
        v = torch.as_tensor(self.vecs, device=dev)
        _, knn_ids = exact_knn(v, ef_spatial)
        self.nbrs = mrng_prune_graph(v, knn_ids.cpu().numpy(), m)
        self.nbrs = add_reverse_edges(self.nbrs, m, device=dev)
        self.centroid, self.dist_c = centroid_dists(self.vecs)
        self.rmq = build_rmq(self.dist_c)
        entry = int(np.argmin(self.dist_c))
        self.nbrs = connectivity_repair(self.nbrs, self.vecs, entry,
                                        device=dev)
        self.mode = mode
        self.oversample = oversample
        self.build_seconds = time.perf_counter() - t0
        self._attach(dev)

    def _attach(self, device):
        self.device = resolve_device(device)
        self._v = torch.as_tensor(self.vecs, device=self.device)
        self._nb = torch.as_tensor(self.nbrs, device=self.device)
        self._rmq = torch.as_tensor(self.rmq, device=self.device)
        self._dc = torch.as_tensor(self.dist_c, device=self.device)

    @property
    def index_bytes(self):
        return self.nbrs.nbytes + self.rmq.nbytes + self.dist_c.nbytes

    def search(self, queries, attr_ranges, *, k=10, ef=64, **_):
        n = len(self.attrs)
        dev = self.device
        lo, hi = rank_interval(self.attrs, attr_ranges)
        qv = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
        if self.mode == "infilter":
            lo_t = torch.as_tensor(lo, device=dev).long()
            hi_t = torch.as_tensor(hi, device=dev).long()
            entry = select_entry(self._rmq, self._dc, lo_t, hi_t, n)
            ids, d, st = beam_search_batch(self._v, self._nb, qv, lo_t, hi_t,
                                           entry, k=k, ef=max(ef, k))
            ids, d = ids.cpu().numpy(), d.cpu().numpy()
        else:  # postfilter: unfiltered search, oversampled, then range filter
            big = max(ef, k * self.oversample)
            zeros = torch.zeros(len(lo), dtype=torch.long, device=dev)
            full_hi = torch.full((len(hi),), n - 1, dtype=torch.long,
                                 device=dev)
            entry = select_entry(self._rmq, self._dc, zeros, full_hi, n)
            ids, d, st = beam_search_batch(self._v, self._nb, qv, zeros,
                                           full_hi, entry, k=big, ef=big)
            idn = ids.cpu().numpy()
            dn = d.cpu().numpy()
            in_range = (idn >= lo[:, None]) & (idn <= hi[:, None]) & (idn >= 0)
            dn = np.where(in_range, dn, np.inf)
            sel = np.argsort(dn, axis=1)[:, :k]
            ids = np.take_along_axis(idn, sel, axis=1)
            d = np.take_along_axis(dn, sel, axis=1)
            ids = np.where(np.isfinite(d), ids, -1)
        return remap_ids(self.order, ids), d, _stats_np(st)


# ----------------------------------------------------------------------
def _segtree_beam(vecs, nbrs_lvl, qv, lo, hi, entries, *, k: int, ef: int,
                  max_steps: int = 0):
    """Beam search over the composed segment-tree graph, every query of the
    batch in lockstep.  nbrs_lvl: (LEVELS, n, m); a node's adjacency row
    comes from the level of the maximal aligned block containing it inside
    [lo, hi].  The reference vmaps a per-query ``while_loop``; here a lane
    whose condition is false keeps its state.  Its condition has no early
    stop: a lane whose best unexpanded distance is +inf (all of its finite
    pool expanded, the pool not full) would re-expand its best node, whose
    neighbours are all visited, until ``steps_cap`` — so its step count is
    set to the cap at once, with the same state.  Returns (ids (Q,k) i32
    ranks, -1 pad; dists (Q,k); {"hops", "ndist"} (Q,) i32)."""
    levels, n, m = nbrs_lvl.shape
    steps_cap = max_steps or 8 * ef + 64
    dev = vecs.device
    nq = qv.shape[0]
    lo, hi = lo.long(), hi.long()
    e0 = entries[:, :ef].long()           # entry list never exceeds the pool
    ev = e0 >= 0
    e0c = e0.clamp(0, n - 1)
    ne = e0.shape[1]
    d0 = torch.where(ev, torch.sum(torch.square(vecs[e0c] - qv[:, None, :]),
                                   dim=-1), INF)
    cand_ids = torch.full((nq, ef), -1, dtype=torch.long, device=dev)
    cand_d = torch.full((nq, ef), INF, dtype=torch.float32, device=dev)
    expanded = torch.zeros((nq, ef), dtype=torch.bool, device=dev)
    cand_ids[:, :ne] = e0c
    cand_d[:, :ne] = d0
    expanded[:, :ne] = ~ev
    visited = torch.zeros((nq, n + 1), dtype=torch.bool, device=dev)
    visited.scatter_(1, torch.where(ev, e0c, n), True)
    steps = torch.zeros(nq, dtype=torch.long, device=dev)
    ndist = torch.zeros(nq, dtype=torch.long, device=dev)
    rows = torch.arange(nq, device=dev)
    lv = torch.arange(levels, device=dev)
    span = torch.bitwise_left_shift(torch.ones_like(lv), lv)     # 2^s

    while True:
        best = torch.where(~expanded, cand_d, INF).amin(1)
        fin = torch.isfinite(cand_d)
        worst = torch.where(fin, cand_d, -INF).amax(1)
        worst = torch.where((~fin).any(1), INF, worst)
        act = (best <= worst) & (steps < steps_cap)
        idle = act & torch.isinf(best)
        steps = torch.where(idle, steps_cap, steps)
        act &= ~idle
        if not bool(act.any()):
            break
        bi = torch.where(~expanded, cand_d, INF).argmin(1)   # first minimum
        exp_n = expanded.clone()
        exp_n[rows, bi] = True
        node = cand_ids[rows, bi].clamp_min(0)
        start = torch.bitwise_left_shift(
            torch.bitwise_right_shift(node[:, None], lv), lv)        # (Q,L)
        ok = (start >= lo[:, None]) & (start + span - 1 <= hi[:, None])
        lvl = torch.where(ok, lv, 0).amax(1)
        nb = nbrs_lvl[lvl, node].long()                               # (Q,m)
        valid = (nb >= 0) & (nb >= lo[:, None]) & (nb <= hi[:, None])
        valid &= ~visited.gather(1, nb.clamp_min(0))
        valid &= act[:, None]                   # a finished lane is frozen
        visited.scatter_(1, torch.where(valid, nb, n), True)
        nv = vecs[nb.clamp_min(0)]
        d_nb = torch.where(valid, torch.sum(torch.square(nv - qv[:, None, :]),
                                            dim=-1), INF)
        ids_all = torch.cat([cand_ids, nb], dim=1)
        d_all = torch.cat([cand_d, d_nb], dim=1)
        exp_all = torch.cat([exp_n, ~valid], dim=1)
        order = torch.argsort(d_all, dim=1, stable=True)[:, :ef]
        a = act[:, None]
        cand_d = torch.where(a, d_all.gather(1, order), cand_d)
        expanded = torch.where(a, exp_all.gather(1, order), expanded)
        cand_ids = torch.where(a, ids_all.gather(1, order), cand_ids)
        steps += act
        ndist += valid.sum(1)
    top_d = cand_d[:, :k]
    ids = torch.where(torch.isfinite(top_d), cand_ids[:, :k], -1)
    return (ids.to(torch.int32), top_d,
            {"hops": steps.to(torch.int32), "ndist": ndist.to(torch.int32)})


def segment_knn(v: torch.Tensor, size: int, k: int,
                tile: int | None = None) -> np.ndarray:
    """Exact KNN of every row within its aligned block of ``size`` ranks
    (self excluded), ``min(k, block rows - 1)`` ids per row by (distance,
    rank), -1 pad: (n, k) int32.  Distances come from ``ops.l2dist`` (the
    kernel on the card, its plain version on the CPU), ``tile`` rows per
    call: up to ``tile``-row blocks are computed ``tile`` rows at a time
    with the other blocks masked, larger blocks in ``tile``-row slices
    (default ``KNN_TILE``)."""
    tile = KNN_TILE if tile is None else tile
    n = v.shape[0]
    out = torch.full((n, k), -1, dtype=torch.int32, device=v.device)
    if size <= tile:
        for lo in range(0, n, tile):
            hi = min(lo + tile, n)
            d = ops.l2dist(v[lo:hi], v[lo:hi])
            blk = torch.arange(lo, hi, device=v.device) // size
            d.masked_fill_(blk[:, None] != blk[None, :], INF)
            d.fill_diagonal_(INF)
            dk, ik = smallest_k(d, min(k, hi - lo))
            out[lo:hi, :dk.shape[1]] = torch.where(
                torch.isfinite(dk), ik + lo, -1).to(torch.int32)
        return out.cpu().numpy()
    for start in range(0, n, size):
        end = min(start + size, n)
        if end - start <= 1:
            continue
        kk = min(k, end - start - 1)
        for lo in range(start, end, tile):
            hi = min(lo + tile, end)
            d = ops.l2dist(v[lo:hi], v[start:end])
            r = torch.arange(hi - lo, device=v.device)
            d[r, r + (lo - start)] = INF
            out[lo:hi, :kk] = (smallest_k(d, kk)[1] + start).to(torch.int32)
    return out.cpu().numpy()


class SegmentTreeIndex:
    """iRangeGraph-like: elemental MRNG graphs on every segment-tree node."""

    def __init__(self, vectors, attrs, *, m=16, ef_spatial=48, device=None):
        t0 = time.perf_counter()
        dev = resolve_device(device)
        self.vecs, self.attrs, self.order = _sorted_corpus(vectors, attrs)
        n = len(self.attrs)
        depth = max(1, int(np.ceil(np.log2(max(n, 2)))))
        self.levels = depth + 1
        self.m = m
        v = torch.as_tensor(self.vecs, device=dev)
        nbrs = np.full((self.levels, n, m), -1, np.int32)
        kmax = max(ef_spatial, m)
        for s in range(self.levels):
            size = 1 << s
            if size <= 1:
                continue
            # per-level batched block-local KNN (one vectorized pass per level)
            knn_lvl = segment_knn(v, size, min(kmax, size - 1))
            g = mrng_prune_graph(v, knn_lvl, m)
            g = add_reverse_edges(g, m, device=dev)
            nbrs[s] = self._repair_blocks(g, size, dev)
        self.nbrs = nbrs
        self.centroid, self.dist_c = centroid_dists(self.vecs)
        self.rmq = build_rmq(self.dist_c)
        self.build_seconds = time.perf_counter() - t0
        self._attach(dev)

    def _repair_blocks(self, g: np.ndarray, size: int, dev) -> np.ndarray:
        """Repair each block of one level only when it is disconnected
        (rare for blocks ≲ ef_spatial, where the candidate set is
        near-complete): a block is connected when its centroid-nearest node
        reaches all of it.  Edges stay inside their block, so one frontier
        walk from every block's entry answers for all blocks at once."""
        n = g.shape[0]
        seen = np.ones(n, bool)
        ents = {}
        for start in range(0, n, size):
            end = min(start + size, n)
            if end - start <= 2:
                continue
            blk = self.vecs[start:end]
            dl = np.sum((blk - blk.mean(0)) ** 2, axis=1)
            ents[start] = int(np.argmin(dl))
            seen[start:end] = False
        if not ents:
            return g
        roots = np.asarray([s + e for s, e in ents.items()])
        seen[roots] = True
        _reach(g, seen, roots)
        for start, ent in ents.items():
            end = min(start + size, n)
            if seen[start:end].all():
                continue
            sub = g[start:end]
            loc = np.where(sub >= 0, sub - start, -1)
            loc = connectivity_repair(loc, self.vecs[start:end], ent,
                                      device=dev)
            g[start:end] = np.where(loc >= 0, loc + start, -1)
        return g

    def _attach(self, device):
        self.device = resolve_device(device)
        self._v = torch.as_tensor(self.vecs, device=self.device)
        self._nb = torch.as_tensor(self.nbrs, device=self.device)
        self._dc = torch.as_tensor(self.dist_c, device=self.device)

    @property
    def index_bytes(self):
        return self.nbrs.nbytes + self.rmq.nbytes + self.dist_c.nbytes

    def _canonical_entries(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """One entry (centroid-nearest node) per maximal aligned block: the
        reference's greedy decomposition of [lo, hi], every query at once.
        From v, the block is the largest 2^s with v % 2^s == 0 that fits in
        [v, hi] (s < LEVELS); the entry is the block's RMQ argmin."""
        lo = np.asarray(lo, np.int64)
        hi = np.asarray(hi, np.int64)
        width = 2 * self.levels
        out = np.full((len(lo), width), -1, np.int32)
        top = self.levels - 1
        v = lo.copy()
        for j in range(width):
            act = v <= hi
            if not act.any():
                break
            va, ha = v[act], hi[act]
            low = (va & -va).astype(np.float64)     # lowest set bit (0: v=0)
            tz = np.where(va == 0, top, np.frexp(low)[1] - 1)
            fit = np.frexp((ha - va + 1).astype(np.float64))[1] - 1
            s = np.minimum(np.minimum(tz, top), fit)
            end = va + (np.int64(1) << s) - 1
            out[act, j] = rmq_query_np(self.rmq, self.dist_c, va, end)
            v[act] = end + 1
        return out

    def search(self, queries, attr_ranges, *, k=10, ef=64, **_):
        dev = self.device
        lo, hi = rank_interval(self.attrs, attr_ranges)
        entries = self._canonical_entries(lo, hi)
        ids, d, st = _segtree_beam(
            self._v, self._nb,
            torch.as_tensor(np.asarray(queries, np.float32), device=dev),
            torch.as_tensor(lo, device=dev), torch.as_tensor(hi, device=dev),
            torch.as_tensor(entries, device=dev), k=k, ef=max(ef, k))
        return (remap_ids(self.order, ids.cpu().numpy()), d.cpu().numpy(),
                _stats_np(st))


# ----------------------------------------------------------------------
def baseline_from_arrays(kind: str, arrays: dict, device):
    """The port's baseline index from the reference's built arrays as numpy
    (``vecs``, ``attrs``, ``order``; for ``"mrng"`` and ``"segtree"`` also
    ``nbrs``, ``centroid``, ``dist_c``, ``rmq``; ``"mrng"`` takes ``mode``
    and ``oversample``, ``"segtree"`` ``levels``) — the baselines'
    counterpart of ``graph_from_arrays``."""
    cls = {"brute": BruteForceIndex, "mrng": MRNGIndex,
           "segtree": SegmentTreeIndex}[kind]
    ix = cls.__new__(cls)
    ix.vecs = np.asarray(arrays["vecs"], np.float32)
    ix.attrs = np.asarray(arrays["attrs"], np.float32)
    ix.order = np.asarray(arrays["order"], np.int32)
    ix.build_seconds = float(arrays.get("build_seconds", 0.0))
    if kind != "brute":
        ix.nbrs = np.asarray(arrays["nbrs"], np.int32)
        ix.centroid = np.asarray(arrays["centroid"], np.float32)
        ix.dist_c = np.asarray(arrays["dist_c"], np.float32)
        ix.rmq = np.asarray(arrays["rmq"], np.int32)
    if kind == "mrng":
        ix.mode = str(arrays.get("mode", "infilter"))
        ix.oversample = int(arrays.get("oversample", 4))
    elif kind == "segtree":
        ix.levels = int(arrays.get("levels", ix.nbrs.shape[0]))
        ix.m = ix.nbrs.shape[2]
    ix._attach(device)
    return ix

"""Exact O(n³) oracles: MRNG (Def 2.1-style, edge-witness) and RRNG (Def 3.1).

Both use the paper's "basic approach" (§3.2): process all pairs in ascending
distance order; the longest edge of a triangle can only be pruned by already-
decided shorter *edges*.  Used by tests and tiny-scale demos only.

Convention: points are pre-sorted by attribute, so index order == attribute
order (ids are attribute ranks).

Host numpy, a copy of the reference's ``repro.core.exact``: the oracles
the port's build is held to (``tests/test_torch_exact.py``).
"""
from __future__ import annotations

import numpy as np


def pair_dists(vecs: np.ndarray) -> np.ndarray:
    n2 = np.sum(vecs * vecs, axis=1)
    d = n2[:, None] - 2.0 * vecs @ vecs.T + n2[None, :]
    np.fill_diagonal(d, np.inf)
    return np.maximum(d, 0.0)


def _pairs_ascending(d: np.ndarray):
    n = d.shape[0]
    iu, ju = np.triu_indices(n, 1)
    order = np.argsort(d[iu, ju], kind="stable")
    return iu[order], ju[order]


def exact_rrng(vecs: np.ndarray) -> np.ndarray:
    """Directed adjacency (n,n) bool: out[x,y].

    Formalization note (DESIGN.md §7): Definition 3.1 is stated on unordered
    pairs, but Theorem 3.3's proof needs the witness edge to hang off the
    *search* node and Algorithm 1 prunes per-node out-edges — the consistent
    reading is a directed graph where out-edge x→y is pruned iff some kept
    out-edge x→z has δ(x,z)<δ(x,y), δ(y,z)<δ(x,y) and z strictly attribute-
    between x and y.  Witnesses are both gap- and distance-smaller than the
    pruned edge, so distance-ascending (here) and gap-ascending (Algorithm 1)
    processing provably reach the same fixpoint (Thm 4.3)."""
    d = pair_dists(vecs)
    n = d.shape[0]
    adj = np.zeros((n, n), bool)
    for x, y in zip(*_pairs_ascending(d)):
        dxy = d[x, y]
        for s, t in ((x, y), (y, x)):
            zs = np.flatnonzero(adj[s])
            zs = zs[(zs > min(s, t)) & (zs < max(s, t))]
            pruned = np.any((d[s, zs] < dxy) & (d[t, zs] < dxy))
            if not pruned:
                adj[s, t] = True
    return adj


def exact_mrng(vecs: np.ndarray) -> np.ndarray:
    """Directed MRNG-style oracle: same scheme without attribute-betweenness
    (edge-witness lune pruning, pairs in ascending distance)."""
    d = pair_dists(vecs)
    n = d.shape[0]
    adj = np.zeros((n, n), bool)
    for x, y in zip(*_pairs_ascending(d)):
        dxy = d[x, y]
        for s, t in ((x, y), (y, x)):
            zs = np.flatnonzero(adj[s])
            pruned = np.any((d[s, zs] < dxy) & (d[t, zs] < dxy))
            if not pruned:
                adj[s, t] = True
    return adj


# ----------------------------------------------------------------------
def greedy_monotonic_reachable(vecs: np.ndarray, adj: np.ndarray,
                               src: int, dst: int) -> bool:
    """Greedy walk: move to any neighbor strictly closer to dst (Thm 3.3)."""
    d = pair_dists(vecs)
    np.fill_diagonal(d, 0.0)      # reaching dst must register as distance 0
    cur = src
    for _ in range(len(vecs) + 1):
        if cur == dst:
            return True
        nbrs = np.flatnonzero(adj[cur])
        if len(nbrs) == 0:
            return False
        best = nbrs[np.argmin(d[nbrs, dst])]
        if d[best, dst] < d[cur, dst] or best == dst:
            cur = best
        else:
            return False
    return False


def induced(adj: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Subgraph induced by rank interval [lo, hi] inclusive."""
    return adj[lo:hi + 1, lo:hi + 1]


def strongly_connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    if n == 0:
        return True
    seen = np.zeros(n, bool)
    stack = [0]
    seen[0] = True
    while stack:
        u = stack.pop()
        for v in np.flatnonzero(adj[u]):
            if not seen[v]:
                seen[v] = True
                stack.append(v)
    return bool(seen.all())

"""Sharded RNSG construction: Algorithm 2 slab by slab over a ``ShardMesh``.

The single-device pipeline (``build_rnsg``) is embarrassingly parallel in
the attribute-rank dimension: every per-node result — the exact-KNN row,
the ±ef_attribute rank window, the gap-sorted candidate arrays, and the
Algorithm-1 keep/prune recurrence — depends only on that node's own row
and the (read-only) corpus.  This module splits all four stages by
contiguous attribute-rank **slab**, one slab per shard, each processed on
its shard's device by ``build_rnsg``'s own code given the slab's row range:
``index.knn.exact_knn(..., row0, row1)`` then
``construction.adjacency_rows(..., row0)``.  Slabs start on
``exact_knn``'s 512-row block grid, and ``prune_all`` keeps its global
block grid, so every product has the single-device build's shape and the
result equals ``build_rnsg``'s bit for bit at any shard count
(``tests/test_torch_build_sharded.py``).

The corpus is copied once to each distinct device of the mesh, not once
per shard: S shards on one card all read one copy.  The entry structures
(centroid distances, RMQ table) are O(n·d) host work and stay global.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.construction import (RNSGGraph, adjacency_rows,
                                           build_rnsg, graph_from_arrays)
from repro_torch.core.entry import build_rmq, centroid_dists
from repro_torch.index.knn import BLOCK, exact_knn
from repro_torch.parallel.sharding import ShardMesh, make_mesh, shard_map


def build_rnsg_sharded(vectors: np.ndarray, attrs: np.ndarray, *,
                       n_shards: Optional[int] = None,
                       mesh: Optional[ShardMesh] = None, m: int = 32,
                       ef_spatial: int = 32, ef_attribute: int = 48,
                       reverse_edges: bool = False,
                       reverse_cap: Optional[int] = None,
                       device=None) -> RNSGGraph:
    """Sharded Algorithm 2 — bit-identical to ``build_rnsg`` (exact KNN).

    ``mesh`` places the slabs; without one, a mesh of ``n_shards`` shards
    over ``device`` (default every visible card, round-robin; raises
    without one) is made, and ``n_shards`` defaults to its device count.
    ``n_shards`` must equal the mesh's size.  The graph lands on the mesh's
    first device."""
    t0 = time.perf_counter()
    if mesh is None:
        devs = None if device is None else [device]
        if n_shards is None:
            n_shards = 1 if devs else max(torch.cuda.device_count(), 1)
        mesh = make_mesh(n_shards, devs)
    n_shards = mesh.size if n_shards is None else n_shards
    if n_shards != mesh.size:
        raise ValueError(f"build_rnsg_sharded: n_shards={n_shards} != "
                         f"mesh axis {mesh.axis!r} size {mesh.size}")
    dev0 = mesh.devices[0]
    vectors = np.asarray(vectors, np.float32)
    attrs = np.asarray(attrs, np.float32)
    n = len(attrs)
    k_eff = min(ef_spatial, n - 1)
    if k_eff < 1:               # degenerate corpus: nothing to shard
        g = build_rnsg(vectors, attrs, m=m, ef_spatial=ef_spatial,
                       ef_attribute=ef_attribute, reverse_edges=reverse_edges,
                       reverse_cap=reverse_cap, device=dev0)
        g.meta["shards"] = n_shards
        return g

    order = np.argsort(attrs, kind="stable")
    vs, as_ = vectors[order], attrs[order]
    # each slab is a whole number of exact_knn's 512-row blocks
    rows_per_shard = -(-n // (n_shards * BLOCK)) * BLOCK
    replicas = {dev: torch.as_tensor(vs, device=dev) for dev in mesh.distinct}

    def slab(s, dev):
        row0 = min(s * rows_per_shard, n)
        row1 = min(row0 + rows_per_shard, n)
        if row1 <= row0:                # a slab of padding only
            return np.zeros((0, m), np.int32)
        _, knn = exact_knn(replicas[dev], k_eff, row0, row1)
        return adjacency_rows(replicas[dev], knn, ef_attribute, m, row0)

    nbrs = np.concatenate(shard_map(slab, mesh))
    del replicas
    if reverse_edges:
        from repro_torch.index.baselines import add_reverse_edges
        nbrs = add_reverse_edges(nbrs, reverse_cap or int(m * 1.25),
                                 device=dev0)

    c, dist_c = centroid_dists(vs)
    rmq = build_rmq(dist_c)
    g = graph_from_arrays(dict(vecs=vs, attrs=as_, nbrs=nbrs, order=order,
                               centroid=c, dist_c=dist_c, rmq=rmq,
                               meta=dict(m=m, ef_spatial=ef_spatial,
                                         ef_attribute=ef_attribute,
                                         knn="exact", shards=n_shards)),
                          dev0)
    g.build_seconds = time.perf_counter() - t0
    return g

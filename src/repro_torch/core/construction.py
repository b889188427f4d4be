"""Algorithm 2 — RNSG construction.

Pipeline: (1) KNN graph (spatial proximity, on the device: exact, or
NNDescent); (2) ±ef_attribute rank window (attribute proximity, Alg. 2
line 7 — index-based on the attribute-sorted order); (3) per-side
gap-sorted candidate arrays (on the device); (4) the vectorized
Algorithm-1 pruning engine (on the device); optionally (5) NSG-style
reverse edges.  Ids are attribute ranks throughout.  Steps (1)-(4) take a
row range (``exact_knn``'s ``row0``/``row1``, ``adjacency_rows``'s
``row0``), so the sharded build runs this code slab by slab.

``RNSGGraph`` holds its arrays as torch tensors on one device and saves
them in the reference's npz layout, so an index written by either package
loads in the other."""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.entry import build_rmq, centroid_dists
from repro_torch.core.pruning import prune_all
from repro_torch.device import resolve_device
from repro_torch.index.io import fsync_dir
from repro_torch.index.knn import exact_knn, nndescent

#: npz field name -> dtype, in the reference's save order
ARRAY_FIELDS = {"vecs": np.float32, "attrs": np.float32, "nbrs": np.int32,
                "order": np.int32, "centroid": np.float32,
                "dist_c": np.float32, "rmq": np.int32}


@dataclass
class RNSGGraph:
    vecs: torch.Tensor        # (n,d) f32, attribute-sorted
    attrs: torch.Tensor       # (n,)  f32, ascending
    nbrs: torch.Tensor        # (n,m) int32, -1 padded (attribute-rank ids)
    order: torch.Tensor       # (n,)  original ids of each rank
    centroid: torch.Tensor    # (d,)
    dist_c: torch.Tensor      # (n,)  δ(v, centroid) (entry structure)
    rmq: torch.Tensor         # (LOG,n) int32 range-argmin table
    build_seconds: float = 0.0
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.vecs.device

    @property
    def n(self) -> int:
        return self.vecs.shape[0]

    @property
    def m(self) -> int:
        return self.nbrs.shape[1]

    @property
    def n_edges(self) -> int:
        return int((self.nbrs >= 0).sum())

    @property
    def index_bytes(self) -> int:
        """Graph-structure bytes (adjacency + entry structures), excluding the
        raw vector payload which every method must store."""
        return sum(t.numel() * t.element_size()
                   for t in (self.nbrs, self.rmq, self.dist_c))

    def arrays(self) -> Dict[str, np.ndarray]:
        """The npz fields as host numpy arrays, in the reference's dtypes."""
        return {name: getattr(self, name).cpu().numpy().astype(dt, copy=False)
                for name, dt in ARRAY_FIELDS.items()}

    def save(self, path: str) -> None:
        """Atomic single-file save in the reference's npz layout: written to
        a sibling temp file, fsynced, renamed over ``path``, and the parent
        directory fsynced.  ``meta`` and ``build_seconds`` ride along as the
        ``__meta__`` JSON entry."""
        if not path.endswith(".npz"):
            path += ".npz"          # match np.savez's implicit suffix
        info = json.dumps(dict(build_seconds=float(self.build_seconds),
                               meta=self.meta))
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.savez_compressed(
                    f, __meta__=np.frombuffer(info.encode(), np.uint8),
                    **self.arrays())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            fsync_dir(os.path.dirname(os.path.abspath(path)))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    @classmethod
    def load(cls, path: str, device=None) -> "RNSGGraph":
        """Load an npz written by either package onto ``device`` (default
        the card)."""
        dev = resolve_device(device)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"          # save() appends the suffix
        with np.load(path) as z:    # legacy files: a 0-d build_seconds
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            if "__meta__" in z.files:
                arrays.update(json.loads(bytes(z["__meta__"]).decode()))
        return graph_from_arrays(arrays, dev)


def graph_from_arrays(arrays: dict, device) -> RNSGGraph:
    """The port's graph from the reference ``RNSGGraph``'s fields as numpy
    (``vecs``, ``attrs``, ``nbrs``, ``order``, ``centroid``, ``dist_c``,
    ``rmq``, plus optional ``meta`` and ``build_seconds``) — the index's
    counterpart of carrying a model's weights across."""
    dev = resolve_device(device)
    tensors = {name: torch.as_tensor(np.asarray(arrays[name], dt), device=dev)
               for name, dt in ARRAY_FIELDS.items()}
    return RNSGGraph(**tensors,
                     build_seconds=float(arrays.get("build_seconds", 0.0)),
                     meta=dict(arrays.get("meta") or {}))


def _gap_sorted_side(n: int, knn_ids: torch.Tensor, ef_attribute: int,
                     side: str, row0: int = 0) -> torch.Tensor:
    """Per-node candidate ids of one side for nodes [row0, row0 +
    len(knn_ids)), ascending rank-gap, -1 padded, (rows, ef + k) int64 on
    ``knn_ids``' device.  Side candidates = attribute window ∪ same-side
    KNN neighbors.  Both sorts are stable, so the result is the
    reference's numpy version's bit for bit."""
    big = np.iinfo(np.int64).max // 2
    dev = knn_ids.device
    ids = torch.arange(row0, row0 + knn_ids.shape[0], device=dev)[:, None]
    win_off = torch.arange(1, ef_attribute + 1, device=dev)[None, :]
    win = ids - win_off if side == "l" else ids + win_off          # (B, ef)
    win_ok = (win >= 0) & (win < n)
    kn = knn_ids.long()
    # kn < n guards against out-of-range candidates (e.g. pad-row ids from a
    # k >= n exact_knn, or a caller-supplied approximate KNN graph)
    kn_ok = ((kn >= 0) & (kn < n)
             & ((kn < ids) if side == "l" else (kn > ids)))
    cand = torch.cat([torch.where(win_ok, win, -1),
                      torch.where(kn_ok, kn, -1)], dim=1)           # (B, ch)
    gap = torch.where(cand >= 0, (cand - ids).abs(), big)
    order = torch.argsort(gap, dim=1, stable=True)
    cand, gap = cand.gather(1, order), gap.gather(1, order)
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = (cand[:, 1:] == cand[:, :-1]) & (cand[:, 1:] >= 0)
    cand = torch.where(dup, -1, cand)
    gap = torch.where(dup, big, gap)
    order = torch.argsort(gap, dim=1, stable=True)
    return cand.gather(1, order)


def adjacency_rows(vecs: torch.Tensor, knn_ids: torch.Tensor,
                   ef_attribute: int, m: int, row0: int = 0) -> np.ndarray:
    """Steps (2)-(4) for nodes [row0, row0 + len(knn_ids)) of the
    attribute-sorted corpus ``vecs``: both sides' gap-sorted candidates,
    then Algorithm 1.  ``knn_ids``: those nodes' (rows, k) KNN rank ids, -1
    pad.  Returns (rows, m) int32 neighbor ids on the host."""
    n = vecs.shape[0]
    cand_l = _gap_sorted_side(n, knn_ids, ef_attribute, "l", row0)
    cand_r = _gap_sorted_side(n, knn_ids, ef_attribute, "r", row0)
    return prune_all(vecs, cand_l, cand_r, m, row0=row0)


def build_rnsg(vectors: np.ndarray, attrs: np.ndarray, *, m: int = 32,
               ef_spatial: int = 32, ef_attribute: int = 48,
               knn_method: str = "exact", knn_iters: int = 6,
               seed: int = 0, knn_ids: Optional[np.ndarray] = None,
               reverse_edges: bool = False,
               reverse_cap: Optional[int] = None, device=None) -> RNSGGraph:
    """Algorithm 2 on ``device`` (default the card), with the reference's
    parameters; ``knn_ids`` ((n, k) rank ids, -1 pad) skips the KNN step,
    ``knn_method`` other than ``"exact"`` runs ``nndescent`` (``knn_iters``
    rounds from ``seed``).  ``reverse_edges=True`` adds NSG-style reverse
    edges up to ``reverse_cap`` (default 1.25·m) slots per node, a knob
    beyond the paper that makes heredity approximate once the cap
    saturates."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    vectors = np.asarray(vectors, np.float32)
    attrs = np.asarray(attrs, np.float32)
    n = len(attrs)
    order = np.argsort(attrs, kind="stable")
    vs, as_ = vectors[order], attrs[order]
    v_dev = torch.as_tensor(vs, device=dev)

    if knn_ids is None:
        # a corpus has at most n-1 true neighbors per node
        k_eff = min(ef_spatial, n - 1)
        if k_eff < 1:
            knn = torch.full((n, 0), -1, dtype=torch.int64, device=dev)
        elif knn_method == "exact":
            _, knn = exact_knn(v_dev, k_eff)
        else:
            _, knn = nndescent(v_dev, k_eff, iters=knn_iters, seed=seed)
    else:
        knn = torch.as_tensor(np.array(knn_ids), device=dev)
    nbrs = adjacency_rows(v_dev, knn, ef_attribute, m)
    if reverse_edges:
        from repro_torch.index.baselines import add_reverse_edges
        nbrs = add_reverse_edges(nbrs, reverse_cap or int(m * 1.25),
                                 device=dev)

    c, dist_c = centroid_dists(vs)
    rmq = build_rmq(dist_c)
    g = graph_from_arrays(dict(vecs=vs, attrs=as_, nbrs=nbrs,
                               order=order, centroid=c, dist_c=dist_c,
                               rmq=rmq,
                               meta=dict(m=m, ef_spatial=ef_spatial,
                                         ef_attribute=ef_attribute,
                                         knn=knn_method)), dev)
    g.build_seconds = time.perf_counter() - t0
    return g

#!/usr/bin/env python3
"""Holds the PyTorch port's card-built RNSG against the JAX reference, at a
corpus size the unit tests do not reach (n = 100,000 × d = 128).

``chip_smoke.py``'s witness phase builds the index with the port on the
card and writes ``chiprun_out/witness_n100000.npz``: the card's exact KNN
ids, the graph built from them, and the port's ``plan="graph"`` ids, hops
and ndist (ef=64, beam width 1 and 4, gather kernels on).  This script
makes the same corpus, queries and ranges again from the stored seed with
the reference's ``repro.data.ann`` and, on the CPU:

1. KNN   — runs the reference ``exact_knn`` and counts rows whose id set
           differs from the card's other than by a near-tie (a neighbour
           swapped for one whose float64 distance is within 1e-6 of 2·‖x‖²
           of the true k-th, float32 rounding of the expansion form);
2. build — runs the reference ``build_rnsg`` with the card's KNN ids and
           compares ``order``, ``dist_c``, ``rmq`` (bit-equal expected),
           ``centroid`` (allclose) and ``nbrs``: a row may differ only where
           a prune comparison is a near-tie in float64, which the card's
           and XLA's float32 sums can round apart;
3. search — the reference's graph search over the card's graph: ids, hops
           and ndist equal per query, at beam width 1 and 4;
4. recall — recall@10 per selectivity level of the card's answers and of
           the reference's search over the reference's own graph.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 scale_witness.py \\
        chiprun_out/witness_n100000.npz

Prints one line per check and a JSON summary last; exits non-zero when a
check fails its bar (KNN, order/dist_c/rmq and nbrs exact up to near-ties,
search ids, hops and ndist equal on >= 99 % of queries).

Given ``chiprun_out/witness_segtree_n8192.npz`` (the benchmark's segment
tree, built and searched on the card past one l2dist tile of rows), it
builds the reference's ``SegmentTreeIndex`` on the stored corpus and
compares ``order``, ``dist_c``, ``rmq`` (bit-equal expected) and ``nbrs``
(rows equal on >= 99.9 % of (level, row) pairs: the block KNN is the
expansion form in float32, summed in another order on each side, so near
ties may flip a neighbour and the prune after it), then runs the
reference's search over the card's arrays (ids, hops and ndist equal on
>= 99 % of queries) and over its own (recall@10 of both against the
reference's ground truth, printed).
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def _knn_faults(vs, got, want, tol=1e-6):
    """Rows whose KNN id sets differ, and those among them where a set
    holds an id whose float64 distance exceeds the true k-th by more than
    ``tol`` of 2·‖x‖² — the scale of float32 rounding in the expansion form
    (about 8 ulps), which may swap the k-th and (k+1)-th neighbours.  Also
    counts the rows where each side matches the float64 truth."""
    diff = np.flatnonzero((np.sort(got, 1) != np.sort(want, 1)).any(1))
    v64 = vs.astype(np.float64)
    k = got.shape[1]
    bad, got_exact, want_exact = [], 0, 0
    for r in diff:
        d = ((v64 - v64[r]) ** 2).sum(1)
        d[r] = np.inf
        kth = np.partition(d, k - 1)[k - 1]
        worst = max(d[got[r]].max(), d[want[r]].max())
        if worst - kth > tol * 2 * float((v64[r] ** 2).sum()):
            bad.append(int(r))
        got_exact += int(d[got[r]].max() <= kth)
        want_exact += int(d[want[r]].max() <= kth)
    return diff, bad, got_exact, want_exact


def _prune_margin(v64, sq, x, side, half):
    """The float64 RRNG recurrence of one side of node ``x`` (candidates in
    gap order, -1 pad), as both packages run it; returns the smallest gap
    between the two sides of any comparison it makes before the side is
    full, relative to the squared norms involved.  A flip in float32 needs
    such a gap of a few ulps."""
    kept, best = [], np.inf
    for c in side[side >= 0]:
        if len(kept) >= half:
            break
        d_xi = ((v64[c] - v64[x]) ** 2).sum()
        if kept:
            kj = np.asarray(kept)
            d_xj = ((v64[kj] - v64[x]) ** 2).sum(1)
            d_ji = ((v64[kj] - v64[c]) ** 2).sum(1)
            scale = sq[x] + sq[c] + sq[kj]
            best = min(best, float(np.min(np.abs(d_xj - d_xi) / scale)),
                       float(np.min(np.abs(d_ji - d_xi) / scale)))
            if np.any((d_xj < d_xi) & (d_ji < d_xi)):
                continue
        kept.append(int(c))
    return best


def main_segtree(z: dict) -> int:
    from repro.data.ann import ground_truth, recall_at_k
    from repro.index.baselines import SegmentTreeIndex
    import jax.numpy as jnp

    vecs, attrs, qv, ranges = z["vecs"], z["attrs"], z["queries"], z["ranges"]
    k, ef = int(z["k"]), int(z["ef"])
    n, nq = len(vecs), len(qv)
    t0 = time.perf_counter()
    own = SegmentTreeIndex(vecs, attrs, m=int(z["m"]),
                           ef_spatial=int(z["ef_spatial"]))
    exact = {f: bool(np.array_equal(getattr(own, f), z[f]))
             for f in ("order", "dist_c", "rmq")}
    cen = bool(np.allclose(own.centroid, z["centroid"], rtol=1e-5,
                           atol=1e-6))
    rows_eq = (own.nbrs == z["nbrs"]).all(-1)
    summary = dict(kind="segtree", n=n, nq=nq, levels=int(own.levels))
    summary["build"] = dict(exact, centroid_allclose=cen,
                            nbrs_rows_equal=float(rows_eq.mean()),
                            nbrs_rows_differing=int((~rows_eq).sum()),
                            differing_by_level=(~rows_eq).sum(1).tolist())
    ok = all(exact.values()) and cen and rows_eq.mean() >= 0.999
    print(f"[build] reference SegmentTreeIndex n={n} ({own.levels} levels): "
          f"exact {exact}, centroid allclose {cen}, nbrs rows equal "
          f"{rows_eq.mean() * 100:.3f}% ({int((~rows_eq).sum())} of "
          f"{rows_eq.size} differ; by level "
          f"{summary['build']['differing_by_level']}) "
          f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    card = SegmentTreeIndex.__new__(SegmentTreeIndex)
    card.vecs, card.attrs = own.vecs, own.attrs
    card.order, card.levels, card.m = z["order"], own.levels, own.m
    card.nbrs, card.rmq, card.dist_c = z["nbrs"], z["rmq"], z["dist_c"]
    card._v, card._nb = jnp.asarray(card.vecs), jnp.asarray(card.nbrs)
    card._rmq, card._dc = jnp.asarray(card.rmq), jnp.asarray(card.dist_c)
    ids, _, st = card.search(qv, ranges, k=k, ef=ef)
    same = ((ids == z["ids"]).all(1) & (st["hops"] == z["hops"])
            & (st["ndist"] == z["ndist"]))
    mine = own.search(qv, ranges, k=k, ef=ef)[0]
    gt, _ = ground_truth(vecs, attrs, qv, ranges, k)
    summary["search"] = dict(equal=float(same.mean()),
                             differing=np.flatnonzero(~same)[:20].tolist(),
                             recall_card=recall_at_k(z["ids"], gt),
                             recall_reference_graph=recall_at_k(mine, gt))
    ok &= same.mean() >= 0.99
    print(f"[search] ef={ef}: the reference over the card's segment tree "
          f"equals the card's ids/hops/ndist on {same.mean() * 100:.2f}% of "
          f"{nq} queries (differing {np.flatnonzero(~same)[:20]}); "
          f"recall@{k} card {summary['search']['recall_card']:.4f}, "
          f"reference over its own tree "
          f"{summary['search']['recall_reference_graph']:.4f} "
          f"({time.perf_counter() - t0:.1f} s)")
    summary["ok"] = bool(ok)
    print(json.dumps(summary))
    return 0 if ok else 1


def main(path: str) -> int:
    z = dict(np.load(path))
    if str(z.get("kind", "")) == "segtree":
        return main_segtree(z)
    from repro.core.construction import (RNSGGraph, _gap_sorted_side,
                                         build_rnsg)
    from repro.core.rfann import RNSGIndex
    from repro.data.ann import (ground_truth, make_attrs, make_vectors,
                                mixed_workload, recall_at_k)
    from repro.index.knn import exact_knn

    seed, n, nq = int(z["seed"]), int(z["n"]), int(z["nq"])
    m, ef_attr = int(z["m"]), int(z["ef_attribute"])
    allv = make_vectors(n + nq, 128, seed=seed)
    base, qv = allv[:n], allv[n:]
    attrs = make_attrs(n, seed=seed)
    ranges, level = mixed_workload(attrs, nq, seed=seed)
    order = np.argsort(attrs, kind="stable")
    vs = base[order]
    summary = dict(n=n, nq=nq, seed=seed)
    ok = True

    t0 = time.perf_counter()
    _, ref_knn = exact_knn(vs, z["knn_ids"].shape[1])
    diff, bad, card_ok, ref_ok = _knn_faults(vs, z["knn_ids"], ref_knn)
    summary["knn"] = dict(rows_differing=len(diff), beyond_near_tie=len(bad),
                          card_equal_to_float64=card_ok,
                          reference_equal_to_float64=ref_ok)
    ok &= not bad
    print(f"[knn] n={n} k={ref_knn.shape[1]}: {len(diff)} rows differ from "
          f"the reference, {len(bad)} beyond a near-tie; of those rows the "
          f"float64 top-k is the card's on {card_ok} and the reference's on "
          f"{ref_ok} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    g = build_rnsg(base, attrs, m=m, ef_attribute=ef_attr,
                   knn_ids=z["knn_ids"])
    exact = {f: bool(np.array_equal(getattr(g, f), z[f]))
             for f in ("order", "dist_c", "rmq")}
    cen = bool(np.allclose(g.centroid, z["centroid"], rtol=1e-5, atol=1e-6))
    rows_eq = (g.nbrs == z["nbrs"]).all(1)
    # a differing row is a rounding flip only if its recurrence makes a
    # comparison that float64 puts within 1e-6 of a tie (about 8 float32
    # ulps of the squared norms)
    v64 = vs.astype(np.float64)
    sq = (v64 * v64).sum(1)
    cand = {sd: _gap_sorted_side(n, z["knn_ids"], ef_attr, sd)
            for sd in "lr"}
    margins = [min(_prune_margin(v64, sq, r, cand["l"][r], max(m // 2, 1)),
                   _prune_margin(v64, sq, r, cand["r"][r], max(m // 2, 1)))
               for r in np.flatnonzero(~rows_eq)]
    beyond = int(sum(mg > 1e-6 for mg in margins))
    summary["build"] = dict(exact, centroid_allclose=cen,
                            nbrs_rows_equal=float(rows_eq.mean()),
                            nbrs_rows_differing=int((~rows_eq).sum()),
                            nbrs_rows_beyond_near_tie=beyond,
                            max_margin_of_differing=max(margins, default=0.0),
                            edges_card=int((z["nbrs"] >= 0).sum()),
                            edges_reference=int((g.nbrs >= 0).sum()))
    ok &= all(exact.values()) and cen and beyond == 0
    print(f"[build] reference build_rnsg with the card's KNN ids: exact "
          f"{exact}, centroid allclose {cen}, nbrs rows equal "
          f"{rows_eq.mean() * 100:.3f}% ({int((~rows_eq).sum())} differ, "
          f"{beyond} beyond a near-tie; largest tie margin among them "
          f"{max(margins, default=0.0):.2e}), edges card "
          f"{summary['build']['edges_card']} reference "
          f"{summary['build']['edges_reference']} "
          f"({time.perf_counter() - t0:.1f} s)")

    card = RNSGIndex(RNSGGraph(
        vecs=vs, attrs=attrs[order], nbrs=z["nbrs"], order=z["order"],
        centroid=z["centroid"], dist_c=z["dist_c"], rmq=z["rmq"]))
    own = RNSGIndex(g)
    gt, _ = ground_truth(base, attrs, qv, ranges, 10)
    summary["search"] = {}
    for bw in (1, 4):
        t0 = time.perf_counter()
        r = card.search(qv, ranges, k=10, ef=64, plan="graph", beam_width=bw)
        same = ((r.ids == z[f"ids_bw{bw}"]).all(1)
                & (r.stats["hops"] == z[f"hops_bw{bw}"])
                & (r.stats["ndist"] == z[f"ndist_bw{bw}"]))
        mine = own.search(qv, ranges, k=10, ef=64, plan="graph",
                          beam_width=bw).ids
        lv = np.unique(level)
        rec_card = {int(v): recall_at_k(z[f"ids_bw{bw}"][level == v],
                                        gt[level == v]) for v in lv}
        rec_ref = {int(v): recall_at_k(mine[level == v], gt[level == v])
                   for v in lv}
        summary["search"][f"bw{bw}"] = dict(
            equal=float(same.mean()),
            differing=np.flatnonzero(~same)[:20].tolist(),
            recall_card=recall_at_k(z[f"ids_bw{bw}"], gt),
            recall_reference_graph=recall_at_k(mine, gt),
            recall_card_by_level=rec_card,
            recall_reference_graph_by_level=rec_ref)
        ok &= same.mean() >= 0.99
        print(f"[search] bw={bw} ef=64: the reference over the card's graph "
              f"equals the card's ids/hops/ndist on {same.mean() * 100:.2f}% "
              f"of {nq} queries (differing {np.flatnonzero(~same)[:20]}); "
              f"recall@10 card {summary['search'][f'bw{bw}']['recall_card']:.4f}"
              f", reference over its own graph "
              f"{summary['search'][f'bw{bw}']['recall_reference_graph']:.4f} "
              f"({time.perf_counter() - t0:.1f} s)")
        print("[recall] level card/reference: " + ", ".join(
            f"2^-{v}:{rec_card[v]:.3f}/{rec_ref[v]:.3f}" for v in rec_card))
    summary["ok"] = bool(ok)
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))

"""Algorithm 1 — Fast Range-Aware Pruning (RRNGPrune).

Two implementations:

* ``rrng_prune_np``: faithful per-node host oracle (numpy), matching the
  paper's pseudocode line by line (split at x.a — Lemma 4.1; scan each side
  by ascending attribute gap — Lemma 4.2; keep ≤ m/2 per side).
* ``prune_all``: the construction engine, vectorized in torch.  Per node
  the candidate side-arrays are pre-sorted by rank gap; the sequential
  keep/prune recurrence runs as a loop over candidates against precomputed
  distance tiles, on the device, in row blocks.  Every op is
  row-independent, so the block size cannot change any row's result.

Ids are attribute ranks (dataset pre-sorted by attribute)."""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def _sq(a, b):
    diff = a - b
    return float(np.dot(diff, diff))


def rrng_prune_np(x: int, cands: np.ndarray, vecs: np.ndarray, m: int) -> List[int]:
    """Faithful Algorithm 1. cands: candidate ids (any order, != x)."""
    cands = np.asarray([c for c in np.unique(cands) if c != x and c >= 0])
    c_l = sorted([c for c in cands if c < x], key=lambda c: x - c)   # asc gap
    c_r = sorted([c for c in cands if c > x], key=lambda c: c - x)
    half = max(m // 2, 1)

    def prune(side):
        kept: List[int] = []
        for vi in side:
            d_xi = _sq(vecs[x], vecs[vi])
            ok = True
            for vj in kept:
                if _sq(vecs[x], vecs[vj]) < d_xi and _sq(vecs[vj], vecs[vi]) < d_xi:
                    ok = False
                    break
            if ok and len(kept) < half:
                kept.append(vi)
        return kept

    return prune(c_l) + prune(c_r)


def prune_side(x_vecs: torch.Tensor, cand_ids: torch.Tensor,
               cand_vecs: torch.Tensor, m_half: int) -> torch.Tensor:
    """x_vecs: (B,d); cand_ids: (B,C) gap-sorted, -1 pad; cand_vecs: (B,C,d).
    Returns kept mask (B,C) honoring the sequential RRNG rule + cap.
    Candidate-candidate distances use the reference's expansion ``einsum``,
    clamped at 0; node-candidate distances the difference form."""
    d_xc = torch.sum(torch.square(cand_vecs - x_vecs[:, None, :]), dim=-1)
    cn = torch.sum(cand_vecs * cand_vecs, dim=-1)
    d_cc = (cn[:, :, None]
            - 2.0 * torch.einsum("bcd,bed->bce", cand_vecs, cand_vecs)
            + cn[:, None, :])
    d_cc = torch.clamp_min(d_cc, 0.0)
    valid = cand_ids >= 0
    kept = torch.zeros_like(valid)
    for i in range(cand_ids.shape[1]):
        d_xi = d_xc[:, i, None]
        # pruned iff ∃ kept j (earlier, smaller gap): d_xj < d_xi ∧ d_ji < d_xi
        pruned = torch.any(kept & (d_xc < d_xi) & (d_cc[:, i, :] < d_xi), dim=1)
        under = torch.sum(kept, dim=1) < m_half
        kept[:, i] = valid[:, i] & ~pruned & under
    return kept


def pack_kept(cand_l: torch.Tensor, kept_l: torch.Tensor,
              cand_r: torch.Tensor, kept_r: torch.Tensor,
              m: int) -> torch.Tensor:
    """Compact the kept candidates of both sides into (B, m) neighbor ids,
    -1 padded — left-side keeps first (in gap order), then right, truncated
    at m.  A stable argsort on the ~kept mask preserves the within-side
    candidate order and the left-before-right order."""
    cand = torch.cat([cand_l, cand_r], dim=1)
    kept = torch.cat([kept_l, kept_r], dim=1)
    order = torch.argsort((~kept).to(torch.uint8), dim=1, stable=True)
    cand = cand.gather(1, order)
    kept = kept.gather(1, order)
    c2 = cand.shape[1]
    if c2 < m:
        cand = torch.nn.functional.pad(cand, (0, m - c2), value=-1)
        kept = torch.nn.functional.pad(kept, (0, m - c2), value=False)
    return torch.where(kept[:, :m], cand[:, :m], -1).to(torch.int32)


def prune_all(vecs: torch.Tensor, cand_l, cand_r, m: int,
              block: int = 8192, row0: int = 0) -> np.ndarray:
    """Run Algorithm 1 for nodes [row0, row0 + len(cand_l)) against the
    corpus ``vecs`` on its device. cand_l/cand_r: (rows, Ch) rank-gap-sorted
    candidate ids per side (-1 padded; numpy or torch).  Blocks keep the
    whole corpus's grid (global multiples of ``block``), so a row range's
    batched products have the whole call's shapes.  Returns (rows, m)
    int32 neighbor ids (-1 pad)."""
    half = max(m // 2, 1)
    dev = vecs.device
    row1 = row0 + len(cand_l)
    out = []
    lo = row0
    while lo < row1:
        hi = min((lo // block + 1) * block, row1)
        ci_l = torch.as_tensor(cand_l[lo - row0:hi - row0], device=dev).long()
        ci_r = torch.as_tensor(cand_r[lo - row0:hi - row0], device=dev).long()
        xv = vecs[lo:hi]
        kept_l = prune_side(xv, ci_l, vecs[ci_l.clamp_min(0)], half)
        kept_r = prune_side(xv, ci_r, vecs[ci_r.clamp_min(0)], half)
        out.append(pack_kept(ci_l, kept_l, ci_r, kept_r, m).cpu().numpy())
        lo = hi
    if not out:
        return np.full((0, m), -1, np.int32)
    return np.concatenate(out)

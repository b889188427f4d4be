"""The corpus, its attribute and the query pool, made from the seed.

The distributions are those of the port's own generators
(``repro_torch.data.ann``: ``make_vectors``' Gaussian mixture,
``selectivity_ranges`` and ``mixed_workload``'s levels 2^-i), frozen here so
that a change to the program cannot move the yardstick.  The vectors are
drawn on the run's device by one ``torch.Generator`` in a few large calls;
the attribute is a random permutation of 0..n-1, uniform with distinct
values (the paper's tie-break assumption) and exact in float32.

The pool holds ``pool`` queries drawn from the corpus' mixture.  It is cut
into blocks of ``block`` queries (one search call), and every block holds
the same number of queries of each selectivity level in an order drawn from
the seed, so two seeds do the same amount of work in another order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Corpus:
    vectors: np.ndarray      # (n, d) float32, host
    attrs: np.ndarray        # (n,) float32, host, distinct
    queries: np.ndarray      # (pool, d) float32, host
    ranges: np.ndarray       # (pool, 2) float32 inclusive attribute ranges


def make_corpus(cfg: dict, pool: int, block: int, levels, seed: int,
                device) -> Corpus:
    """Vectors, attribute and query pool of one configuration and seed."""
    n, d = int(cfg["n"]), int(cfg["d"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    centers = torch.randn((int(cfg["n_clusters"]), d), generator=g,
                          device=device) * float(cfg["center_scale"])
    assign = torch.randint(0, int(cfg["n_clusters"]), (n + pool,),
                           generator=g, device=device)
    allv = centers[assign] + torch.randn((n + pool, d), generator=g,
                                         device=device)
    attrs = torch.randperm(n, generator=g, device=device).to(torch.float32)
    allv = allv.cpu().numpy()
    attrs = attrs.cpu().numpy()
    rng = np.random.default_rng([int(seed), 13])
    lv = pool_levels(pool, block, levels, rng)
    ranges = selectivity_ranges(attrs, lv, rng)
    return Corpus(allv[:n], attrs, np.ascontiguousarray(allv[n:]), ranges)


def pool_levels(pool: int, block: int, levels, rng) -> np.ndarray:
    """Selectivity level of each pool query: each block of ``block``
    queries holds every level equally often, shuffled within the block."""
    levels = np.asarray(levels, np.int64)
    if pool % block or block % len(levels):
        raise ValueError(f"pool {pool} must be a multiple of the block "
                         f"{block}, and the block of the {len(levels)} "
                         f"levels")
    out = np.resize(levels, pool)
    for b in range(0, pool, block):
        rng.shuffle(out[b:b + block])
    return out


def selectivity_ranges(attrs: np.ndarray, levels: np.ndarray,
                       rng) -> np.ndarray:
    """One random window of round(2^-level · n) consecutive attribute values
    per query, as inclusive [a_l, a_r] (``selectivity_ranges``)."""
    s = np.sort(attrs)
    n = len(s)
    w = np.maximum(1, np.rint(n * 2.0 ** -levels.astype(np.float64))
                   ).astype(np.int64)
    lo = (rng.random(len(levels)) * (n - w + 1)).astype(np.int64)
    return np.stack([s[lo], s[lo + w - 1]], axis=1).astype(np.float32)

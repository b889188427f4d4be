"""Deterministic, host-shardable synthetic token pipeline with background
prefetch — the training-data substrate (a plain copy of the reference's
``repro.data.tokens``: host numpy, so ``batch_at`` is bit-equal to the
reference's for every (seed, step, host_id)).

Design mirrors a production index-based loader: sample `i` of epoch `e` is a
pure function of (seed, e, i), so any host can compute exactly its shard
(host_id, n_hosts) without coordination, restarts are reproducible from the
step counter alone, and straggler re-balancing is just a different
(host_id → index-range) assignment.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    markov_order: bool = True     # structured (learnable) stream vs uniform


class SyntheticTokenStream:
    """Markov-chain token stream: learnable structure so smoke-training loss
    actually decreases; ~uniform fallback for pure-throughput tests."""

    def __init__(self, cfg: TokenStreamConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        k = min(v, 64)
        # sparse-ish transition structure shared by all hosts
        self._next = rng.integers(0, v, (v, k)).astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host) — restart == replay."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_id)
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        if not cfg.markov_order:
            toks = rng.integers(0, v, (b, s + 1)).astype(np.int32)
        else:
            toks = np.empty((b, s + 1), np.int32)
            toks[:, 0] = rng.integers(0, v, b)
            choice = rng.integers(0, self._next.shape[1], (b, s))
            for t in range(s):
                toks[:, t + 1] = self._next[toks[:, t], choice[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, step0: int) -> Iterator[Dict[str, np.ndarray]]:
        """Resume-aware iteration: restart-from-checkpoint must seek here."""
        step = step0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded queue) over any iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def run():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:
                self._err = e
            finally:
                self._q.put(None)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err:
                raise self._err
            raise StopIteration
        return item

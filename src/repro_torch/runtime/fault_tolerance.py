"""Fault-tolerance runtime (the reference's ``repro.runtime.fault_tolerance``):
straggler detection, preemption handling, heartbeat simulation, and
cross-pod gradient compression.

The monitors are host numpy, copied; the gradient compression works on
tensors, on their own device."""
from __future__ import annotations

import signal
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.training.tree import tree_map


# ----------------------------------------------------------------------
@dataclass
class StragglerMonitor:
    """EMA step-time outlier detection across (simulated) hosts.

    A host whose per-step EMA exceeds ``threshold`` × the fleet median is
    flagged; the launcher's mitigation is (1) exclude its data shard from the
    next epoch's assignment (work re-balancing) and (2) if it persists for
    ``evict_after`` flags, request checkpoint-and-restart without it
    (elastic downscale — checkpoints are mesh-agnostic)."""
    n_hosts: int
    alpha: float = 0.2
    threshold: float = 1.8
    evict_after: int = 5
    ema: np.ndarray = field(init=False)
    flags: np.ndarray = field(init=False)
    history: deque = field(init=False)

    def __post_init__(self):
        self.ema = np.zeros(self.n_hosts)
        self.flags = np.zeros(self.n_hosts, np.int64)
        self.history = deque(maxlen=512)

    def record(self, host_step_seconds: np.ndarray) -> Dict:
        t = np.asarray(host_step_seconds, float)
        self.ema = np.where(self.ema == 0, t,
                            self.alpha * t + (1 - self.alpha) * self.ema)
        med = float(np.median(self.ema))
        stragglers = np.flatnonzero(self.ema > self.threshold * med)
        self.flags[stragglers] += 1
        self.flags[np.setdiff1d(np.arange(self.n_hosts), stragglers)] = 0
        evict = np.flatnonzero(self.flags >= self.evict_after)
        self.history.append(dict(median=med, stragglers=stragglers.tolist()))
        return dict(median_s=med, stragglers=stragglers.tolist(),
                    evict=evict.tolist())


# ----------------------------------------------------------------------
class PreemptionHandler:
    """SIGTERM → finish the current step, checkpoint, exit cleanly."""

    def __init__(self):
        self.requested = threading.Event()
        self._prev = None

    def install(self):
        self._prev = signal.signal(signal.SIGTERM, self._on_signal)
        return self

    def _on_signal(self, signum, frame):
        self.requested.set()

    def should_stop(self) -> bool:
        return self.requested.is_set()


# ----------------------------------------------------------------------
class Heartbeat:
    """Simulated multi-host liveness: hosts post beats; the coordinator calls
    ``dead_hosts`` to find members silent for > timeout (triggers the elastic
    restart path in the launcher)."""

    def __init__(self, n_hosts: int, timeout: float = 30.0):
        self.last = {h: time.monotonic() for h in range(n_hosts)}
        self.timeout = timeout
        self._lock = threading.Lock()

    def beat(self, host: int, at: Optional[float] = None):
        with self._lock:
            self.last[host] = at if at is not None else time.monotonic()

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.monotonic()
        with self._lock:
            return [h for h, t in self.last.items() if now - t > self.timeout]


# ----------------------------------------------------------------------
def int8_compress_decompress(g: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 quantize→dequantize (the wire format of the
    cross-pod gradient all-reduce; 4×/2× volume reduction vs f32/bf16).
    ``torch.round`` rounds half to even, as ``jnp.round`` does; the scale
    divides as a tensor (on the card, a division by a Python scalar
    multiplies by its reciprocal)."""
    gf = g.float()
    scale = torch.clamp_min(gf.abs().max(), 1e-12) / torch.tensor(
        127.0, device=g.device)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return (q.float() * scale).to(g.dtype)


def make_compressed_grad_transform():
    def transform(grads):
        return tree_map(int8_compress_decompress, grads)
    return transform

"""Fault-tolerance runtime of the serve path: graceful preemption.

Only ``PreemptionHandler`` is here, the part of the reference's
``repro.runtime.fault_tolerance`` that the serve launcher installs; the
straggler, heartbeat and gradient-compression pieces belong to the
training side."""
from __future__ import annotations

import signal
import threading


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

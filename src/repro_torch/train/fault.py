"""Fault tolerance (``repro.train.fault``): the straggler watchdog and the
simulated worker crash.

The watchdog flags a step that takes longer than ``factor`` times the
trailing median of the last ``history`` steps, once at least 5 steps were
seen; the continuous batcher (``fleet/scheduler.py``) watches its decode
steps and waves with it.  ``run_supervised`` and ``FaultConfig`` restore
from checkpoints (``train/checkpoint.py``) and wait for the training item
of ROADMAP queue 1.
"""
from __future__ import annotations

import statistics

__all__ = ["StragglerWatchdog", "SimulatedFailure"]


class SimulatedFailure(RuntimeError):
    """Raised by tests / chaos hooks to simulate a worker crash."""


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, history: int = 32):
        self.factor = factor
        self.times = []
        self.history = history
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        """Record a step time; True if this step straggled."""
        slow = False
        if len(self.times) >= 5:
            med = statistics.median(self.times[-self.history:])
            slow = dt > self.factor * med
            if slow:
                self.flagged += 1
        self.times.append(dt)
        return slow

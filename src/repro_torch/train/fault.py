"""Fault tolerance (``repro.train.fault``): the supervised run loop, the
straggler watchdog and the simulated worker crash.

``run_supervised`` runs a train loop that checkpoints every
``ckpt_every`` steps (asynchronously, ``train/checkpoint.py``), survives a
worker failure (a :class:`SimulatedFailure` from a chaos hook), restores the
newest checkpoint (onto the state's device) and the data stream's state,
and resumes, so the data pipeline continues bit-identically.  A restore onto another device mesh (the
JAX package's elastic path) waits for the mesh, ROADMAP queue 1, item 8.
The watchdog flags a step that takes longer than ``factor`` times the
trailing median of the last ``history`` steps, once at least 5 steps were
seen; the continuous batcher (``fleet/scheduler.py``) watches its decode
steps and waves with it.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional

from . import checkpoint as ckpt_lib
from .optimizer import tree_leaves

__all__ = ["FaultConfig", "StragglerWatchdog", "SimulatedFailure", "run_supervised"]


class SimulatedFailure(RuntimeError):
    """Raised by tests / chaos hooks to simulate a worker crash."""


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str = "repro_ckpt"
    ckpt_every: int = 10
    max_restarts: int = 3
    step_deadline_factor: float = 3.0   # straggler threshold vs trailing median


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


def run_supervised(make_state: Callable[[], dict], step_fn: Callable, stream, n_steps: int,
                   fcfg: FaultConfig, chaos: Optional[Callable[[int], None]] = None,
                   on_step=None):
    """Run ``n_steps`` with periodic checkpoints; on a failure, restore the
    newest checkpoint and resume.  ``chaos(step)`` may raise
    :class:`SimulatedFailure` to exercise the recovery path.  Returns
    (state, log), the log counting restarts, stragglers and steps run."""
    log = {"restarts": 0, "stragglers": 0, "steps_run": 0}
    saver = ckpt_lib.AsyncCheckpointer()
    watchdog = StragglerWatchdog(fcfg.step_deadline_factor)

    state = None
    restarts = 0
    while True:
        try:
            if state is None:
                state = make_state()
                last = ckpt_lib.latest_step(fcfg.ckpt_dir)
                start = 0
                if last is not None:
                    device = tree_leaves(state)[0].device
                    state, extra = ckpt_lib.restore(fcfg.ckpt_dir, last, state, device=device)
                    stream.restore(extra["data"])
                    start = int(extra["train_step"])
            else:
                start = log["steps_run"]

            for i in range(start, n_steps):
                if chaos is not None:
                    chaos(i)
                t0 = time.monotonic()
                batch = stream.next()
                state, metrics = step_fn(state, batch)
                dt = time.monotonic() - t0
                if watchdog.observe(dt):
                    log["stragglers"] += 1
                log["steps_run"] = i + 1
                if on_step is not None:
                    on_step(i, metrics)
                if (i + 1) % fcfg.ckpt_every == 0:
                    saver.save_async(fcfg.ckpt_dir, i + 1, state,
                                     extra={"train_step": i + 1, "data": stream.state()})
            saver.wait()
            return state, log
        except SimulatedFailure:
            restarts += 1
            log["restarts"] = restarts
            if restarts > fcfg.max_restarts:
                raise
            saver.wait()
            state = None          # a full restart: rebuild, restore the newest checkpoint

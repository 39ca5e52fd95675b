"""Trace spans (``repro.obs.trace``): Chrome-trace-format timelines of the
serving and adaptation loop.

A :class:`TraceRecorder` collects events in the Chrome Trace Event format
(load the saved JSON in ``chrome://tracing`` or Perfetto): prefill, decode,
retune, canary and rollback render as one timeline.  Recording is opt-in
and host-side only: with no recorder installed every hook is a global read
and an early return, and nothing here runs inside a captured CUDA graph or
reads a device value, so instrumented paths give the same tokens and add
no host synchronise.

Surface:

* ``with span("prefill", rid=3):`` — a complete ("X") event timing the
  block; nested spans nest visually via the shared thread track.
* ``instant("canary", target="mlp")`` — a zero-duration marker ("i").
* ``async_begin("request", 7)`` / ``async_end("request", 7)`` — an async
  ("b"/"e") pair spanning a request's lifetime across steps.
* ``device_trace(logdir)`` — a ``torch.profiler`` trace around a block,
  exported as a Chrome trace into ``logdir``: CUDA activity on the card
  (the default), CPU activity with ``device="cpu"``.  The JAX package uses
  ``jax.profiler`` here.  Heavyweight, never on by default.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

__all__ = [
    "TraceRecorder",
    "install_recorder",
    "current_recorder",
    "span",
    "instant",
    "async_begin",
    "async_end",
    "device_trace",
]


class TraceRecorder:
    """In-memory Chrome-trace event buffer (microsecond timestamps relative
    to recorder creation; ``pid`` is the OS pid, ``tid`` the Python thread
    ident, so multi-threaded servers get one track per thread)."""

    def __init__(self):
        self._events = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    # -- clock ---------------------------------------------------------
    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _push(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def _base(self, name: str, ph: str, cat: str, args: dict) -> dict:
        return dict(name=name, ph=ph, cat=cat, pid=os.getpid(),
                    tid=threading.get_ident(), ts=self.now_us(),
                    args={k: _jsonable(v) for k, v in args.items()})

    # -- event kinds ---------------------------------------------------
    def complete(self, name: str, start_us: float, dur_us: float,
                 cat: str = "serve", **args) -> None:
        ev = self._base(name, "X", cat, args)
        ev["ts"] = start_us
        ev["dur"] = dur_us
        self._push(ev)

    def instant(self, name: str, cat: str = "serve", **args) -> None:
        ev = self._base(name, "i", cat, args)
        ev["s"] = "t"                      # thread-scoped instant
        self._push(ev)

    def async_begin(self, name: str, ident, cat: str = "request",
                    **args) -> None:
        ev = self._base(name, "b", cat, args)
        ev["id"] = str(ident)
        self._push(ev)

    def async_end(self, name: str, ident, cat: str = "request",
                  **args) -> None:
        ev = self._base(name, "e", cat, args)
        ev["id"] = str(ident)
        self._push(ev)

    # -- output --------------------------------------------------------
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def to_json(self) -> str:
        return json.dumps({"traceEvents": self.events(),
                           "displayTimeUnit": "ms"}, indent=None)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")
        return path


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return repr(v)


_CURRENT: Optional[TraceRecorder] = None


def install_recorder(rec: Optional[TraceRecorder]) -> Optional[TraceRecorder]:
    """Install (or, with ``None``, remove) the process trace recorder;
    returns the previous one so callers can restore it."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, rec
    return prev


def current_recorder() -> Optional[TraceRecorder]:
    return _CURRENT


@contextlib.contextmanager
def span(name: str, cat: str = "serve", **args):
    """Time a block as a complete trace event.  No-recorder case is a
    near-free early exit — safe to leave on hot host loops."""
    rec = _CURRENT
    if rec is None:
        yield
        return
    t0 = rec.now_us()
    try:
        yield
    finally:
        rec.complete(name, t0, rec.now_us() - t0, cat=cat, **args)


def instant(name: str, cat: str = "serve", **args) -> None:
    rec = _CURRENT
    if rec is not None:
        rec.instant(name, cat=cat, **args)


def async_begin(name: str, ident, cat: str = "request", **args) -> None:
    rec = _CURRENT
    if rec is not None:
        rec.async_begin(name, ident, cat=cat, **args)


def async_end(name: str, ident, cat: str = "request", **args) -> None:
    rec = _CURRENT
    if rec is not None:
        rec.async_end(name, ident, cat=cat, **args)


DEVICE_TRACE_FILENAME = "device_trace.json"


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """``torch.profiler`` trace around a block, exported as a Chrome trace
    to ``logdir/device_trace.json`` (the path is what the block receives).
    ``device="cuda"`` (the default) records the card's kernels beside the
    host's operators and raises when there is no card; ``device="cpu"``
    records the host only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace(device='cuda') needs a CUDA device")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, DEVICE_TRACE_FILENAME)
    with profile(activities=activities) as prof:
        yield path
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)

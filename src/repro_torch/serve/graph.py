"""The decode step as a CUDA graph: the port's counterpart of the JAX
package's fused ``lax.scan`` and of its program caches (``_fused_decode_fn``,
``_adaptive_decode_fn``, ``_TOKEN_FNS``).

A :class:`StepProgram` holds one decode program: the static buffers its
step reads and writes (token, position, done-flag inputs, seeds and token
counters, the adaptive runtime's swap triples, the output row) and one
``torch.cuda.CUDAGraph`` per observe gate.  Its first step of a gate runs
eagerly on those buffers, which builds every kernel library, uploads every
table, fills the weight cache (``quant.ax.weight_codes``) and advances the
state; the same step is then captured and every later step of that gate is
a replay.  New values (a policy update, a splice, a new request's seed)
reach a graph by ``copy_`` into its buffers: no re-capture and no host
read.  A graph reads the parameters and the KV cache by address, so a
program also holds them (and the cached codes of the weights) and is
rebuilt, and counted as a capture, when a call brings other tensors.

``CAPTURES`` counts captures per program key (its kind, config, batch,
cache length, observed or not, scalar or tile mode, EOS, sampling): the
port's witness that policy updates and splices re-capture nothing.  Each
capture also counts into ``repro_retraces_total{kind=}``
(``obs.count_retrace``), the kind being the key's first element:
``fused`` (the static decode step), ``fused_adaptive`` (the adaptive one)
or ``token_step``.  ``REPLAYS`` counts replays per key, and each
program keeps the kernel launches its captured step holds
(``kernels/ax_matmul.py::LAUNCHES`` counts a launch when the Python wrapper
runs, so at capture and not at replay): launches executed on a graph path
= eager launches - captured launches + launches per step x replays
(:func:`executed_launches`).

Replays run under ``torch.cuda.set_sync_debug_mode("error")``: a step that
would read from the card on the host raises instead of stalling.  On a CPU
tensor there are no graphs; the engine runs the same step eagerly.  On a
CUDA tensor a capture that fails raises: nothing falls back to eager.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, Optional

import torch

from repro_torch import obs
from repro_torch.kernels.ax_matmul import LAUNCHES
from repro_torch.quant.ax import weight_cache_payloads

__all__ = ["StepProgram", "program", "CAPTURES", "REPLAYS", "counts", "executed_launches",
           "captures_by_kind", "clear_programs", "leaves", "no_sync"]

CAPTURES: Dict[tuple, int] = collections.Counter()
REPLAYS: Dict[tuple, int] = collections.Counter()
_PROGRAMS: Dict[tuple, "StepProgram"] = {}


def leaves(tree):
    """The tensors of a nested dict/list tree, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def _identity(*trees) -> tuple:
    return tuple(t.data_ptr() for tree in trees for t in leaves(tree))


@contextlib.contextmanager
def no_sync():
    """Raise on any host synchronise inside the block."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class StepProgram:
    """One decode program (module note).  ``step(gate)`` runs one step on
    the static buffers in ``self.buf`` and returns its outputs (the step's
    telemetry records, or None).  :meth:`run` replays the graph of a gate
    once :meth:`warm_and_capture` has run the step eagerly and captured it."""

    def __init__(self, key: tuple, keep: list, step: Callable[[bool], Optional[dict]],
                 buf: dict):
        self.key, self.step, self.buf = key, step, buf
        self.identity: tuple = ()
        self.keep = list(keep)
        self.graphs: Dict[bool, torch.cuda.CUDAGraph] = {}
        self.outputs: Dict[bool, Optional[dict]] = {}
        self.launches: Dict[bool, Dict[str, int]] = {}

    def replay(self, gate: bool):
        """One replay of the graph of ``gate``; returns its output buffers."""
        self.graphs[gate].replay()
        REPLAYS[self.key + (gate,)] += 1
        return self.outputs[gate]

    def warm_and_capture(self, gate: bool):
        """The step of ``gate`` run eagerly (a real step, which also warms
        every lazy table and the weight cache), then captured."""
        out = self.step(gate)
        self.keep += weight_cache_payloads(leaves(self.keep))
        g = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        # captured on a side stream, as torch.cuda.graph does, but without
        # its gc.collect() and empty_cache(): emptying the allocator's cache
        # would make the next prefill allocate everything anew
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            g.capture_begin()
            try:
                self.outputs[gate] = self.step(gate)
            finally:
                g.capture_end()
        main.wait_stream(side)
        self.launches[gate] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        self.graphs[gate] = g
        CAPTURES[self.key + (gate,)] += 1
        obs.count_retrace(self.key[0])
        return out

    def run(self, gate: bool):
        """Replay under :func:`no_sync` when captured, else warm and capture."""
        if gate not in self.graphs:
            return self.warm_and_capture(gate)
        with no_sync():
            return self.replay(gate)


def program(key: tuple, identity_trees: tuple, build: Callable[[], StepProgram]
            ) -> StepProgram:
    """The program of ``key`` for these parameter and cache tensors: the
    cached one when it was built for the same tensors, else a new one
    from ``build()`` (which replaces it)."""
    ident = _identity(*identity_trees)
    prog = _PROGRAMS.get(key)
    if prog is None or prog.identity != ident:
        prog = _PROGRAMS[key] = build()
        prog.identity = ident
    return prog


def counts():
    """A snapshot of ``(CAPTURES, REPLAYS)`` for :func:`executed_launches`."""
    return dict(CAPTURES), dict(REPLAYS)


def executed_launches(before, launches: Dict[str, int]) -> Dict[str, int]:
    """The kernel launches a run executed, from the ``LAUNCHES`` delta of
    the run (``launches``) and a :func:`counts` snapshot taken before it:
    less the launches recorded into the graphs it captured, plus those its
    replays ran."""
    cap0, rep0 = before
    out = dict(launches)
    for prog in _PROGRAMS.values():
        for gate, per in prog.launches.items():
            k = prog.key + (gate,)
            n = (REPLAYS.get(k, 0) - rep0.get(k, 0)) - (CAPTURES.get(k, 0) - cap0.get(k, 0))
            for name, v in per.items():
                out[name] += v * n
    return out


def captures_by_kind() -> Dict[str, int]:
    """``CAPTURES`` summed by program kind (the key's first element), the
    counterpart of ``repro_retraces_total{kind=}``."""
    out: Dict[str, int] = collections.Counter()
    for key, n in CAPTURES.items():
        out[key[0]] += n
    return dict(out)


def clear_programs() -> None:
    """Drop every program (and the tensors it holds)."""
    _PROGRAMS.clear()

"""Dynamic-policy scope (``repro.runtime.scope``).

The adaptive runtime changes the SWAPPER configuration of a serving step
without rebuilding anything: the step runs inside an :class:`AxRuntimeScope`
that holds the per-target swap triples as int32 device tensors, and
``models.layers.dense`` looks the scope up and routes matching projections
through ``quant.ax.ax_dense_dyn``.  The JAX package consults its scope while
tracing a compiled step; the port runs eagerly, so the scope is live while
the step runs.

Config keys are hierarchical: a projection target ``"layer3/mlp"`` falls back
to ``"mlp"`` and then to the global key ``"*"`` (see ``runtime.policy``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

__all__ = ["AxRuntimeScope", "active_scope", "ax_scope", "fallback_chain"]

GLOBAL_KEY = "*"

_ACTIVE: Optional["AxRuntimeScope"] = None


def fallback_chain(key: str) -> List[str]:
    """Lookup order for a hierarchical config key: the exact key, then each
    suffix after stripping a leading path segment, then the global key."""
    chain = [key]
    while "/" in key:
        key = key.split("/", 1)[1]
        chain.append(key)
    chain.append(GLOBAL_KEY)
    return chain


class AxRuntimeScope:
    """Holds the step's (op_is_a, bit, value) triples (or per-row-tile
    grids) and collects the telemetry summaries emitted during the step.

    ``gate`` — telemetry decimation: ``False`` means this step is not
    observed, and ``ax_dense_dyn`` computes no summary at all (the JAX
    package takes a traced boolean and a ``lax.cond`` of zeros instead);
    ``None`` or ``True`` observe.

    ``tile_rows`` — per-tile granularity: when > 0 the dyn values are
    (tile_rows, 1, 3) grids and every matching projection also records a
    ``telemetry.tile_summary`` under ``tile_key(target)``.

    ``kernel_hist`` — kernel backend and tile mode only: take the tile bit
    statistic from the grid kernel's own histogram output instead of the
    sampled pass."""

    def __init__(self, dyn_tree: Optional[Dict[str, torch.Tensor]], collect: bool = False,
                 gate: Optional[bool] = None, tile_rows: int = 0,
                 kernel_hist: bool = False):
        self.dyn = dict(dyn_tree or {})
        self.collect = collect
        self.gate = gate
        self.tile_rows = int(tile_rows)
        self.kernel_hist = bool(kernel_hist)
        self._records: Dict[str, List[dict]] = {}

    @property
    def observing(self) -> bool:
        """True when projections in this step record telemetry."""
        return self.collect and self.gate is not False

    def triple_for(self, target: str) -> Optional[torch.Tensor]:
        for key in fallback_chain(target):
            if key in self.dyn:
                return self.dyn[key]
        return None

    def record(self, target: str, summary: dict) -> None:
        self._records.setdefault(target, []).append(summary)

    def collected(self) -> Dict[str, dict]:
        """The per-call summaries of each target stacked into tensors with a
        leading call axis (exact limb sums are recombined per call on the
        host)."""
        return {target: {k: torch.stack([r[k] for r in records]) for k in records[0]}
                for target, records in self._records.items()}


def active_scope() -> Optional[AxRuntimeScope]:
    return _ACTIVE


@contextlib.contextmanager
def ax_scope(dyn_tree: Optional[Dict[str, torch.Tensor]], collect: bool = False,
             gate: Optional[bool] = None, tile_rows: int = 0,
             kernel_hist: bool = False):
    """Open a dynamic-policy scope around one step; see
    :class:`AxRuntimeScope` for the arguments."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = AxRuntimeScope(dyn_tree, collect=collect, gate=gate,
                             tile_rows=tile_rows, kernel_hist=kernel_hist)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev

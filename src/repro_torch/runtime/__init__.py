"""Online adaptive SWAPPER runtime (``repro.runtime``): telemetry -> drift ->
re-tune, closing the loop for the paper's *online* error reduction.

  scope      — the step's dynamic policy: swap triples enter as int32 device
               tensors, telemetry summaries leave as tensors
  telemetry  — streaming, exponentially-decayed operand/error statistics on
               the limb-exact accumulators of ``core/metrics.py``
  policy     — granular, serializable SwapPolicy maps (global / per-target /
               per-layer / per-row-tile grids for the grid kernel)
  drift      — bit-occupancy distribution-shift scoring against the
               tuned-on reference
  controller — drift-triggered re-tune: NoSwap and all 4M configs scored in
               one batched call over buffered live operands; with a
               ``fleet.PolicyStore`` the guarded rollout (canary, SLO veto,
               auto-rollback) and the audit log
"""
from .controller import (
    AdaptiveConfig,
    AdaptiveController,
    RetuneEvent,
    TileRetuneEvent,
    all_triples,
    tile_triples,
)
from .drift import DriftConfig, DriftDetector, drift_score
from .policy import NO_SWAP_TRIPLE, SwapPolicy, triple_of, triple_short
from .scope import AxRuntimeScope, active_scope, ax_scope, fallback_chain
from .telemetry import (
    RETUNE_SAMPLE,
    TELEMETRY_SAMPLE,
    TILE_RETUNE_SAMPLE,
    TILE_TELEMETRY_SAMPLE,
    TargetTelemetry,
    TargetTileTelemetry,
    Telemetry,
    base_target,
    is_tile_key,
    operand_summary,
    tile_key,
    tile_summary,
)

__all__ = [
    "AdaptiveConfig",
    "AdaptiveController",
    "RetuneEvent",
    "TileRetuneEvent",
    "all_triples",
    "tile_triples",
    "DriftConfig",
    "DriftDetector",
    "drift_score",
    "NO_SWAP_TRIPLE",
    "SwapPolicy",
    "triple_of",
    "triple_short",
    "AxRuntimeScope",
    "active_scope",
    "ax_scope",
    "fallback_chain",
    "Telemetry",
    "TargetTelemetry",
    "TargetTileTelemetry",
    "operand_summary",
    "tile_summary",
    "tile_key",
    "is_tile_key",
    "base_target",
    "TELEMETRY_SAMPLE",
    "RETUNE_SAMPLE",
    "TILE_TELEMETRY_SAMPLE",
    "TILE_RETUNE_SAMPLE",
]

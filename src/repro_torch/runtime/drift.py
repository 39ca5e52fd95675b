"""Distribution-drift detection over streaming bit-occupancy telemetry
(``repro.runtime.drift``).

The drift signal is the per-bit occupancy probability vector of both
operands — the sufficient statistic of the single-bit decision family: if
no bit's occupancy moved, no single-bit config changed its mask
population.  Score: mean absolute difference between the current
exponentially-decayed bit-probability matrix and the reference captured
when the policy was last tuned.  (The JAX package also exports the score as
a metrics gauge; the port's observability layer is still to come, ROADMAP
queue 1.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["DriftConfig", "DriftDetector", "drift_score"]


def drift_score(ref: np.ndarray, cur: np.ndarray) -> float:
    """Mean |P_ref(bit=1) - P_cur(bit=1)| over both operands' bits."""
    return float(np.mean(np.abs(np.asarray(ref) - np.asarray(cur))))


@dataclasses.dataclass
class DriftConfig:
    threshold: float = 0.04    # mean bit-probability shift that triggers re-tune
    min_steps: int = 4         # observations required before scoring


class DriftDetector:
    """Per-target drift scoring against the tuned-on reference snapshot."""

    def __init__(self, cfg: Optional[DriftConfig] = None):
        self.cfg = cfg or DriftConfig()
        self.reference: Dict[str, np.ndarray] = {}
        self._steps_since_rebase: Dict[str, int] = {}

    def rebase(self, target: str, bit_probs: np.ndarray) -> None:
        """Capture the distribution the current policy is tuned for."""
        self.reference[target] = np.asarray(bit_probs).copy()
        self._steps_since_rebase[target] = 0

    def score(self, target: str, bit_probs: Optional[np.ndarray]) -> float:
        if bit_probs is None:
            return 0.0
        bit_probs = np.asarray(bit_probs)
        ref = self.reference.get(target)
        if ref is None or ref.shape != bit_probs.shape:
            # first sighting, or the statistic changed shape (a per-tile
            # target whose tile count follows the call's row count): adopt
            # the new snapshot and restart the warm-up
            self.rebase(target, bit_probs)
            return 0.0
        self._steps_since_rebase[target] = self._steps_since_rebase.get(target, 0) + 1
        return drift_score(ref, bit_probs)

    def check(self, snapshot: Dict[str, dict]) -> List[Tuple[str, float]]:
        """Score every target; returns [(target, score)] for those over the
        threshold and past the warm-up period."""
        drifted = []
        for target, snap in snapshot.items():
            s = self.score(target, snap.get("bit_probs"))
            if (s > self.cfg.threshold
                    and self._steps_since_rebase.get(target, 0) >= self.cfg.min_steps):
                drifted.append((target, s))
        return drifted

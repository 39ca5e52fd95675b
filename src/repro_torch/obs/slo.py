"""Declarative SLOs with multi-window burn-rate alerting (``repro.obs.slo``).

An :class:`SLOSpec` names a stream of good/bad events — request latency
against a target, or per-target QoR MAE against a guard band around the
drift reference — plus an **objective**: the fraction of events allowed to
be bad (the error budget).  :class:`SLOEngine` consumes events, tracks a
short and a long trailing window, and alerts only when *both* windows burn
budget faster than ``burn_alert`` times the sustainable rate — the
multi-window pattern (short window = still happening, long window = not a
blip) from the SRE burn-rate playbook, here over **event-count** windows
rather than wall-clock so evaluation is deterministic and testable.

Alert transitions are edge-triggered into the retune audit log
(``kind="slo_alert"`` / ``"slo_clear"``), and specs marked
``veto_promotion`` gate the controller's canary path: while such a spec is
alerting, :meth:`SLOEngine.vetoes_promotion` is true and the controller
refuses to ``promote()`` a candidate — a degraded QoR SLO means the
holdout score cannot be trusted to represent live traffic.

Like the rest of ``obs`` this is dependency-free host code: the engine is
handed plain floats (a serving front end feeds latencies, the controller
feeds per-target MAE and the drift reference).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from .metrics import default_registry

__all__ = [
    "SLOSpec",
    "SLOAlert",
    "SLOEngine",
    "default_serving_slos",
]

_REG = default_registry()
_BURN = _REG.gauge(
    "repro_slo_burn_rate",
    "trailing error-budget burn rate by SLO and window "
    "(1.0 = exactly consuming budget, >1 overspending)")
_BUDGET = _REG.gauge(
    "repro_slo_budget_remaining",
    "fraction of the long-window error budget still unspent, by SLO")
_ALERTS = _REG.counter(
    "repro_slo_alerts_total",
    "edge-triggered SLO alert activations, by SLO")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One service-level objective.

    ``kind="latency"``: an event is *bad* when the observed seconds exceed
    ``threshold``.  ``kind="qor"``: an event is bad when the per-target
    MAE exceeds ``threshold`` times the engine's reference for ``source``
    (the drift-reference guard band); with no reference installed,
    ``threshold`` is an absolute MAE bound.
    """
    name: str
    kind: str                      # "latency" | "qor"
    source: str                    # latency stream name / telemetry target
    threshold: float               # seconds, or guard-band multiplier
    objective: float = 0.05        # allowed bad-event fraction (budget)
    short_window: int = 16         # events; "is it still happening"
    long_window: int = 64          # events; "is it not a blip"
    burn_alert: float = 2.0        # alert when both windows burn >= this
    min_events: int = 8            # per window, before it can alert
    veto_promotion: bool = False   # alerting => controller.promote() veto

    def __post_init__(self):
        if self.kind not in ("latency", "qor"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be a fraction in (0, 1)")
        if self.short_window > self.long_window:
            raise ValueError("short_window must be <= long_window")


@dataclasses.dataclass(frozen=True)
class SLOAlert:
    """A snapshot of an alerting SLO at evaluation time."""
    slo: str
    kind: str
    source: str
    burn_short: float
    burn_long: float
    events: int
    veto_promotion: bool


class _SpecState:
    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.short: Deque[bool] = collections.deque(maxlen=spec.short_window)
        self.long: Deque[bool] = collections.deque(maxlen=spec.long_window)
        self.events = 0
        self.bad = 0
        self.alerting = False

    def push(self, is_bad: bool) -> None:
        self.short.append(is_bad)
        self.long.append(is_bad)
        self.events += 1
        self.bad += int(is_bad)

    def burn(self, window: Deque[bool]) -> float:
        if not window:
            return 0.0
        return (sum(window) / len(window)) / self.spec.objective

    def ready(self) -> bool:
        return (len(self.short) >= min(self.spec.min_events,
                                       self.spec.short_window)
                and len(self.long) >= min(self.spec.min_events,
                                          self.spec.long_window))


class SLOEngine:
    """Evaluates a set of :class:`SLOSpec` over observed events.

    ``audit`` is any object with an ``append(kind, **fields)`` method
    (:class:`~repro_torch.obs.audit.AuditLog`); alert transitions are
    recorded there so SLO history lands next to retune/canary/rollback
    history in the same ``audit.jsonl``.
    """

    def __init__(self, specs: Sequence[SLOSpec], audit=None):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names in {names}")
        self._states: Dict[str, _SpecState] = {
            s.name: _SpecState(s) for s in specs}
        self._audit = audit
        self._references: Dict[str, float] = {}

    # -- event ingestion ----------------------------------------------
    def observe_latency(self, source: str, seconds: float) -> None:
        """Feed one latency sample to every latency spec on ``source``."""
        for st in self._states.values():
            if st.spec.kind == "latency" and st.spec.source == source:
                st.push(float(seconds) > st.spec.threshold)
                self._evaluate(st)

    def set_reference(self, target: str, mae: float) -> None:
        """Install/refresh the drift-reference MAE a qor spec's guard
        band multiplies (the controller calls this at rebase)."""
        self._references[target] = float(mae)

    def observe_qor(self, target: str, mae: float) -> None:
        """Feed one per-target MAE sample to every qor spec on it."""
        for st in self._states.values():
            if st.spec.kind != "qor" or st.spec.source != target:
                continue
            ref = self._references.get(target)
            bound = (st.spec.threshold * ref if ref is not None
                     else st.spec.threshold)
            st.push(float(mae) > bound)
            self._evaluate(st)

    # -- evaluation ----------------------------------------------------
    def _evaluate(self, st: _SpecState) -> None:
        spec = st.spec
        bs, bl = st.burn(st.short), st.burn(st.long)
        _BURN.set(bs, slo=spec.name, window="short")
        _BURN.set(bl, slo=spec.name, window="long")
        allowed = max(len(st.long) * spec.objective, 1e-12)
        _BUDGET.set(max(0.0, 1.0 - sum(st.long) / allowed), slo=spec.name)
        now = (st.ready() and bs >= spec.burn_alert
               and bl >= spec.burn_alert)
        if now and not st.alerting:
            _ALERTS.inc(1, slo=spec.name)
            if self._audit is not None:
                self._audit.append(
                    "slo_alert", slo=spec.name, slo_kind=spec.kind,
                    source=spec.source, burn_short=round(bs, 4),
                    burn_long=round(bl, 4), events=st.events,
                    veto_promotion=spec.veto_promotion)
        elif st.alerting and not now:
            if self._audit is not None:
                self._audit.append(
                    "slo_clear", slo=spec.name, burn_short=round(bs, 4),
                    burn_long=round(bl, 4), events=st.events)
        st.alerting = now

    # -- queries -------------------------------------------------------
    def burn_rate(self, name: str) -> Tuple[float, float]:
        st = self._states[name]
        return st.burn(st.short), st.burn(st.long)

    def events(self, name: str) -> int:
        """Total events observed by SLO ``name`` (liveness probe)."""
        return self._states[name].events

    def alerting(self) -> List[SLOAlert]:
        out = []
        for st in self._states.values():
            if st.alerting:
                bs, bl = st.burn(st.short), st.burn(st.long)
                out.append(SLOAlert(
                    slo=st.spec.name, kind=st.spec.kind,
                    source=st.spec.source, burn_short=bs, burn_long=bl,
                    events=st.events,
                    veto_promotion=st.spec.veto_promotion))
        return out

    def vetoes_promotion(self) -> Optional[str]:
        """Name of an alerting veto-bearing SLO, or None — the canary path
        consults this before ``store.promote()``."""
        for st in self._states.values():
            if st.alerting and st.spec.veto_promotion:
                return st.spec.name
        return None

    def describe(self) -> str:
        parts = []
        for st in self._states.values():
            bs, bl = st.burn(st.short), st.burn(st.long)
            flag = "!" if st.alerting else ""
            parts.append(f"{flag}{st.spec.name}({bs:.1f}/{bl:.1f})")
        return "slo " + " ".join(parts)


def default_serving_slos(ttft_s: float = 8.0, e2e_s: float = 13.0,
                         mae_band: float = 1.5,
                         qor_targets: Sequence[str] = ("mlp",),
                         ) -> List[SLOSpec]:
    """The stock serving SLO set (the JAX package's): latency targets sized
    from the TTFT/e2e bucket families, plus a QoR guard band per telemetry
    target that vetoes canary promotion while alerting."""
    specs = [
        SLOSpec(name="ttft", kind="latency", source="ttft",
                threshold=ttft_s, objective=0.05),
        SLOSpec(name="e2e", kind="latency", source="e2e",
                threshold=e2e_s, objective=0.05),
    ]
    for t in qor_targets:
        specs.append(SLOSpec(
            name=f"qor_{t}", kind="qor", source=t, threshold=mae_band,
            objective=0.1, veto_promotion=True))
    return specs

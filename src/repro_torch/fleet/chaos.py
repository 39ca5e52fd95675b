"""Chaos / fault-injection harness for the serving-side adaptation loop
(``repro.fleet.chaos``, the same sites, kinds and plan JSON).

The adaptation loop is a production dependency: a retune fit on corrupted
telemetry or a torn ``PolicyStore`` publish is adopted fleet-wide and makes
error *worse* — so the recovery paths need to be exercised as
deterministically as the happy paths.  This module is the injection half:

* a :class:`FaultSpec` names one fault — an injection **site** (a named
  hook compiled into the production code path, e.g. ``store.publish``), a
  fault **kind** valid at that site, and the 0-based visit count ``at``
  which the fault fires on;
* a :class:`FaultPlan` is an ordered, JSON-serializable collection of
  specs.  :meth:`FaultPlan.seeded` derives a plan deterministically from an
  integer seed, so a chaos run replays the exact same fault sequence every
  time;
* a :class:`ChaosHarness` executes a plan: production call sites call
  :func:`fire` (a no-op returning ``[]`` unless a harness is installed —
  the **armed-but-idle** invariant: an installed harness whose plan never
  matches must leave behavior bit-identical), and the harness returns the
  specs due at this visit while counting what it injected.

Faults either *raise* :class:`InjectedFault` (simulated process kill),
*corrupt* on-disk state (torn ``CURRENT``, garbage policy JSON), *poison* telemetry records in flight (NaN/Inf/outlier), or
*stall* (sleep) a step/retune/poll.  The consuming code paths decide the
semantics; this module only decides *when* and records *what fired*.

Usage::

    from repro_torch.fleet import chaos

    plan = chaos.FaultPlan([
        chaos.FaultSpec("store.publish", "torn_current", at=1),
        chaos.FaultSpec("controller.observe", "poison_nan", at=3),
    ])
    with chaos.active(plan) as harness:
        ...   # serve; injected faults are counted in harness.fired
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs

__all__ = [
    "SITES",
    "FaultSpec",
    "FaultPlan",
    "ChaosHarness",
    "InjectedFault",
    "active",
    "install",
    "uninstall",
    "current",
    "fire",
    "stall_seconds",
    "poison_records",
]


class InjectedFault(RuntimeError):
    """An injected crash (simulated process kill at the fault site);
    supervisors catch it directly."""


# Injection sites compiled into the production paths, and the fault kinds
# each site honors.  ``at`` counts visits of the site per harness.
SITES: Dict[str, Tuple[str, ...]] = {
    # PolicyStore.publish: kill mid temp-file write (orphan .tmp, no version
    # committed), kill after the version+heartbeat but before the CURRENT
    # swap, or tear the CURRENT pointer itself (garbage bytes) then die.
    "store.publish": ("kill_mid_write", "kill_before_current", "torn_current"),
    # After a successful publish: overwrite the just-published policy JSON
    # with garbage (simulates partial replication / disk corruption).
    "store.after_publish": ("corrupt_policy",),
    # PolicyReader.poll: delayed poll (slow replica) or replica kill.
    "reader.poll": ("delay_poll", "crash_replica"),
    # AdaptiveController.observe: poison the incoming telemetry records.
    "controller.observe": ("poison_nan", "poison_inf", "poison_outlier"),
    # AdaptiveController.retune: stall the sweep (slow host).
    "controller.retune": ("stall_retune",),
    # the continuous batcher's decode step (ported with the scheduler): stall
    # one step or kill the replica.
    "sched.step": ("stall_step", "crash_replica"),
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: fire ``kind`` on the ``at``-th visit of ``site``.

    ``arg`` carries the kind's scalar parameter (stall seconds for
    ``stall_*``/``delay_poll``, outlier scale for ``poison_outlier``);
    ``None`` means the consumer's default."""

    site: str
    kind: str
    at: int = 0
    arg: Optional[float] = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown chaos site {self.site!r} "
                             f"(known: {sorted(SITES)})")
        if self.kind not in SITES[self.site]:
            raise ValueError(f"fault kind {self.kind!r} not valid at "
                             f"{self.site!r} (valid: {SITES[self.site]})")

    def to_dict(self) -> dict:
        return dict(site=self.site, kind=self.kind, at=self.at, arg=self.arg)


class FaultPlan:
    """An ordered, deterministic, JSON-round-trippable set of faults."""

    def __init__(self, faults: Sequence[FaultSpec] = (),
                 seed: Optional[int] = None):
        self.faults: List[FaultSpec] = list(faults)
        self.seed = seed

    @classmethod
    def seeded(cls, seed: int, n_faults: int = 6,
               sites: Optional[Sequence[str]] = None,
               max_at: int = 8) -> "FaultPlan":
        """Derive a plan deterministically from ``seed``: ``n_faults``
        (site, kind, at) choices sampled without replacement over the
        (site, kind) space — one seed replays the identical fault sequence
        in every run."""
        rng = np.random.default_rng(seed)
        space = [(s, k) for s in (sites or sorted(SITES)) for k in SITES[s]]
        picks = rng.choice(len(space), size=min(n_faults, len(space)),
                           replace=False)
        faults = [FaultSpec(space[i][0], space[i][1],
                            at=int(rng.integers(0, max_at)))
                  for i in sorted(int(p) for p in picks)]
        return cls(faults, seed=seed)

    # -- serialization -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dict(seed=self.seed,
                               faults=[f.to_dict() for f in self.faults]),
                          indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls([FaultSpec(**f) for f in d.get("faults", [])],
                   seed=d.get("seed"))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    def describe(self) -> str:
        parts = [f"{f.site}:{f.kind}@{f.at}" for f in self.faults]
        seed = "" if self.seed is None else f" seed={self.seed}"
        return f"faultplan[{len(self.faults)}{seed}] " + " ".join(parts)


_REG = obs.default_registry()
_INJECTED = _REG.counter(
    "repro_chaos_faults_injected_total",
    "faults the chaos harness fired, by site and kind")


class ChaosHarness:
    """Executes a :class:`FaultPlan`: counts visits per site, returns the
    due specs, and logs every injection (counter + fired list)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.visits: Dict[str, int] = {}
        self.fired: List[Tuple[str, FaultSpec]] = []

    def poke(self, site: str, **ctx) -> List[FaultSpec]:
        n = self.visits.get(site, 0)
        self.visits[site] = n + 1
        hits = [f for f in self.plan.faults if f.site == site and f.at == n]
        for f in hits:
            self.fired.append((site, f))
            _INJECTED.inc(1, site=site, kind=f.kind)
            obs.instant("chaos_fault", cat="chaos", site=site, kind=f.kind,
                        visit=n, **ctx)
        return hits

    def fired_count(self, kind: Optional[str] = None) -> int:
        return sum(1 for _, f in self.fired if kind is None or f.kind == kind)

    def describe(self) -> str:
        return (f"chaos[{self.plan.describe()}] visits={dict(self.visits)} "
                f"fired={[(s, f.kind) for s, f in self.fired]}")


# ---------------------------------------------------------------------------
# module-level harness installation (production sites call fire())
# ---------------------------------------------------------------------------

_ACTIVE: Optional[ChaosHarness] = None


def install(plan_or_harness) -> ChaosHarness:
    """Install a harness process-wide; returns it.  Production call sites
    start injecting on their next visit."""
    global _ACTIVE
    h = (plan_or_harness if isinstance(plan_or_harness, ChaosHarness)
         else ChaosHarness(plan_or_harness))
    _ACTIVE = h
    return h


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def current() -> Optional[ChaosHarness]:
    return _ACTIVE


@contextlib.contextmanager
def active(plan_or_harness):
    """``with chaos.active(plan) as harness: ...`` — scoped installation."""
    h = install(plan_or_harness)
    try:
        yield h
    finally:
        uninstall()


def fire(site: str, **ctx) -> List[FaultSpec]:
    """The production-side hook: returns the faults due at this visit of
    ``site`` ([] when no harness is installed — the common, free case)."""
    if _ACTIVE is None:
        return []
    return _ACTIVE.poke(site, **ctx)


# ---------------------------------------------------------------------------
# fault appliers shared by the consuming sites
# ---------------------------------------------------------------------------

def stall_seconds(faults: Sequence[FaultSpec], default: float = 0.05) -> float:
    """Total sleep the ``stall_*``/``delay_*`` faults in ``faults`` ask for
    (the caller sleeps; 0.0 when none are due)."""
    total = 0.0
    for f in faults:
        if f.kind.startswith(("stall_", "delay_")):
            total += default if f.arg is None else float(f.arg)
    return total


def maybe_stall(faults: Sequence[FaultSpec], default: float = 0.05) -> float:
    """Sleep for the stall faults in ``faults``; returns seconds slept."""
    s = stall_seconds(faults, default)
    if s > 0:
        time.sleep(s)
    return s


def poison_records(faults: Sequence[FaultSpec], records):
    """Apply the telemetry-poisoning faults in ``faults`` to a **copy** of a
    controller-bound record tree (``{target: {field: array}}``).

    * ``poison_nan``  — NaN the bit-occupancy counts (corrupt shard math);
    * ``poison_inf``  — +Inf the error limb sums;
    * ``poison_outlier`` — scale counts/limbs/samples by ``arg`` (default
      1000x): finite but absurd, the robust-z / bounds quarantine case.

    Non-poison faults are ignored, so sites can pass their full hit list."""
    kinds = [f for f in faults if f.kind.startswith("poison_")]
    if not kinds:
        return records
    out = {t: {k: np.array(v) for k, v in rec.items()}
           for t, rec in records.items()}
    for f in kinds:
        for target, rec in out.items():
            if f.kind == "poison_nan":
                for k in ("bits_a", "bits_b", "tile_bits_a"):
                    if k in rec:
                        rec[k] = np.full_like(
                            np.asarray(rec[k], np.float32), np.nan)
            elif f.kind == "poison_inf":
                for k in ("neg_a", "neg_b", "tile_neg_a"):
                    if k in rec:
                        rec[k] = np.full_like(
                            np.asarray(rec[k], np.float32), np.inf)
            elif f.kind == "poison_outlier":
                scale = 1000.0 if f.arg is None else float(f.arg)
                for k in ("bits_a", "bits_b", "err_lo", "err_hi",
                          "a_smp", "b_smp"):
                    if k in rec:
                        v = np.asarray(rec[k])
                        rec[k] = (v.astype(np.float64) * scale).astype(
                            np.float64 if np.issubdtype(v.dtype, np.floating)
                            else np.int64)
    return out

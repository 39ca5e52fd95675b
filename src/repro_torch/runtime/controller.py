"""The adaptive SWAPPER controller (``repro.runtime.controller``): closes the
loop between telemetry and policy.

Per observed step it (1) folds the step's telemetry records into the
streaming accumulators, (2) refreshes per-target operand ring buffers from
the exported samples, (3) scores distribution drift against the snapshot the
current policy was tuned on, and (4) on drift re-tunes the affected targets
by scoring NoSwap and all 4M single-bit configurations over the buffered
live operands in one batched call on the controller's device.  Policies
reach the serving step as int32 tensor values, so adaptation rebuilds
nothing.

**Guarded rollout** (``AdaptiveConfig(canary=True)``, with ``store=`` a
``fleet.PolicyStore``).  A re-tune's winner is published as a store
candidate, scored against the incumbent on the newest ``canary_holdout``
ring-buffer elements, and promoted to CURRENT only on a confirmed gain and
while no veto-bearing SLO alerts (:meth:`attach_slo`); otherwise the
candidate is rejected and the incumbent keeps serving.  Every promotion
arms a rollback guard: an ``ew_mae`` regression past the guard band within
the window re-points CURRENT to the last good version and restores the
pre-adoption policy bit for bit.  Every decision lands in the store's
audit log, and the re-tune, canary and rollback counters and spans go to
``obs``.

Scores are exact: integer error sums divided by the sample size at the end
(the JAX package takes an f32 mean, which can order a near-tie differently).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import multipliers as M
from repro_torch.core.metrics import abs_err
from repro_torch.core.swapper import SwapConfig, all_configs, apply_swapper_dyn

from .drift import DriftConfig, DriftDetector
from .policy import NO_SWAP_TRIPLE, SwapPolicy, triple_of, triple_short
from .telemetry import (Telemetry, TelemetryQuarantine, base_target, is_tile_key,
                        operand_summary, records_to_host, tile_key, tile_summary)


def _chaos():
    """The fleet chaos harness, imported lazily (``fleet.store`` imports
    ``runtime.policy``, so a module-level import would cycle)."""
    from repro_torch.fleet import chaos

    return chaos


__all__ = ["AdaptiveConfig", "RetuneEvent", "TileRetuneEvent",
           "AdaptiveController", "all_triples", "tile_triples"]

# the JAX package's series: re-tune counters, wall and predicted gain, and
# the guarded rollout's canaries and rollbacks
_REG = obs.default_registry()
_RETUNES = _REG.counter(
    "repro_retunes_total",
    "controller re-tunes by kind (scalar target vs per-row-tile grid)")
_RETUNE_WALL = _REG.histogram(
    "repro_retune_seconds",
    "host wall of one re-tune (vmapped sweep scoring + policy publish)")
_RETUNE_GAIN = _REG.gauge(
    "repro_retune_predicted_gain",
    "per-target predicted error reduction of the last re-tune "
    "(incumbent score - winner score, re-tune metric units)")
_CANARY = _REG.counter(
    "repro_canary_total",
    "candidate policies canaried against the ring-buffer holdout, by outcome "
    "(promoted / rejected)")
_ROLLBACKS = _REG.counter(
    "repro_rollbacks_total",
    "post-adoption guard-band trips: CURRENT re-pointed to last-good")


def all_triples(bits: int) -> np.ndarray:
    """(4M+1, 3) int32 sweep space: NoSwap first, then every single-bit
    config in ``all_configs`` order."""
    rows = [NO_SWAP_TRIPLE] + [triple_of(c) for c in all_configs(bits)]
    return np.asarray(rows, np.int32)


def tile_triples(bits: int) -> np.ndarray:
    """(2M+1, 3) int32 per-row-tile sweep space: NoSwap first, then every
    A-side single-bit config.  Row tiles partition the activation operand A,
    so the decision that can vary per row tile is A's (this also keeps the
    published grids expressible on the JAX package's ``mxu`` backend)."""
    rows = [NO_SWAP_TRIPLE] + [triple_of(c) for c in all_configs(bits)
                               if c.operand == "A"]
    return np.asarray(rows, np.int32)


def _score_configs(mult, a, b, triples, metric: str = "mae") -> np.ndarray:
    """Mean error of every (op_is_a, bit, value) triple over operand samples
    (..., n), the JAX package's ``jax.vmap`` written as a triple axis:
    ``(T,)`` scores for (n,) samples, ``(g, T)`` for (g, n) per-tile ones.
    ``mae`` and ``ep`` are exact integer sums divided at the end; ``mse``
    sums in float64."""
    a = a.to(torch.int64).unsqueeze(-2)
    b = b.to(torch.int64).unsqueeze(-2)
    t = triples.to(device=a.device, dtype=torch.int64)
    p = apply_swapper_dyn(mult, a, b, t[:, 0:1], t[:, 1:2], t[:, 2:3])
    e = abs_err(p, mult.exact_product(a, b), mult.signed)        # (..., T, n)
    if metric == "mae":
        s = e.sum(dim=-1)
    elif metric == "ep":
        s = (e != 0).sum(dim=-1)
    elif metric == "mse":
        s = (e.to(torch.float64) ** 2).sum(dim=-1)
    else:
        raise ValueError(f"unknown re-tune metric {metric!r}")
    return (s.to(torch.float64) / e.shape[-1]).cpu().numpy()


@dataclasses.dataclass
class AdaptiveConfig:
    decay: float = 0.2             # telemetry EW decay per observed step
    drift_threshold: float = 0.04  # mean bit-probability shift triggering re-tune
    min_observe_steps: int = 4     # warm-up before drift can fire
    cooldown_steps: int = 4        # steps between re-tunes (buffer refresh time)
    buffer_size: int = 2048        # per-target operand ring-buffer elements
    metric: str = "mae"            # re-tune objective
    # per-row-tile adaptation: 0 = off; N > 0 = collect tile telemetry and
    # serve per-row-tile config grids at N row tiles per projection (drift
    # confined to one tile reaches the detector diluted by ~1/N)
    tile_rows: int = 0
    tile_buffer_size: int = 512    # per-(target, tile) operand ring buffer
    # guarded rollout (canary + auto-rollback); off: a re-tune's winner is
    # adopted directly
    canary: bool = False           # publish winners as candidates, canary them
    canary_holdout: int = 256      # newest ring-buffer elements held out
    canary_margin: float = 0.0     # winner must beat incumbent by this frac
    rollback_guard: float = 0.5    # post-adoption ew_mae regression fraction
    rollback_min_steps: int = 2    # observed steps before the guard can fire
    rollback_window: int = 32      # guard watch window (steps) per adoption
    # telemetry admission control (`quarantine=False` disables even the
    # NaN/Inf and bounds checks)
    quarantine: bool = True
    quarantine_z: Optional[float] = None   # robust-z MAE outlier threshold


@dataclasses.dataclass
class RetuneEvent:
    step: int
    target: str
    drift: float
    old: Optional[SwapConfig]
    new: Optional[SwapConfig]
    old_score: float
    new_score: float
    promoted: bool = True                   # False: canary rejected the winner
    candidate_version: Optional[int] = None  # store version the attempt holds

    def describe(self) -> str:
        fmt = lambda c: "noswap" if c is None else c.short()
        verdict = "" if self.promoted else " [canary REJECTED, kept incumbent]"
        return (f"retune[{self.target}] step={self.step} drift={self.drift:.3f} "
                f"{fmt(self.old)} ({self.old_score:.2f}) -> "
                f"{fmt(self.new)} ({self.new_score:.2f}){verdict}")


@dataclasses.dataclass
class TileRetuneEvent:
    """One per-row-tile re-tune: every candidate of ``tile_triples`` scored
    per row tile, the winning grid published."""

    step: int
    target: str
    drift: float
    grid: np.ndarray               # (gm, 1, 3) published tile grid
    old_score: float               # mean over tiles, incumbent per-tile cfg
    new_score: float               # mean over tiles, winning per-tile cfg

    def describe(self) -> str:
        cfgs = ",".join(triple_short(t) for t in self.grid[:, 0, :])
        return (f"tile-retune[{self.target}] step={self.step} "
                f"drift={self.drift:.3f} -> ({cfgs}) "
                f"({self.old_score:.2f} -> {self.new_score:.2f})")


class _RingBuffer:
    """Host-side operand ring buffer (recency-biased re-tune sample)."""

    def __init__(self, size: int):
        self.a = np.zeros(size, np.int32)
        self.b = np.zeros(size, np.int32)
        self.pos = 0
        self.filled = 0

    def add(self, a: np.ndarray, b: np.ndarray) -> None:
        a = np.asarray(a, np.int32).reshape(-1)
        b = np.asarray(b, np.int32).reshape(-1)
        n = min(len(a), len(b), len(self.a))
        idx = (self.pos + np.arange(n)) % len(self.a)
        self.a[idx] = a[:n]
        self.b[idx] = b[:n]
        self.pos = int((self.pos + n) % len(self.a))
        self.filled = min(self.filled + n, len(self.a))

    def operands(self):
        """Fixed-shape views (partially-filled slots repeat the newest data
        so the scorer sees one shape)."""
        if self.filled >= len(self.a):
            return self.a, self.b
        n = max(self.filled, 1)
        reps = -(-len(self.a) // n)
        return (np.tile(self.a[:n], reps)[: len(self.a)],
                np.tile(self.b[:n], reps)[: len(self.a)])

    def recent(self, n: int):
        """The ``n`` most recently written elements as (n,) arrays
        (cyclically tiled when fewer were written): the canary holdout."""
        m = min(max(self.filled, 1), n)
        idx = (self.pos - m + np.arange(m)) % len(self.a)
        a, b = self.a[idx], self.b[idx]
        if m < n:
            reps = -(-n // m)
            a = np.tile(a, reps)[:n]
            b = np.tile(b, reps)[:n]
        return a, b


class AdaptiveController:
    """Owns the telemetry, drift detector, operand buffers and the policy.

    ``store`` — optional ``fleet.PolicyStore`` this controller writes: every
    re-tune is published as a new version (a candidate first under
    ``cfg.canary``) so serve replicas (``fleet.PolicyReader``) and restarts
    (:meth:`resume_from_store`) pick the adapted policy up; its audit log
    records every decision.

    ``device`` — where the policy's int32 tensors (:meth:`dyn_tree`) live
    and where the re-tune and canary scorers run: the card unless the
    caller asks for the CPU."""

    def __init__(self, policy: SwapPolicy, targets: Sequence[str],
                 cfg: Optional[AdaptiveConfig] = None,
                 log_fn: Optional[Callable[[str], None]] = None,
                 store=None, device="cuda"):
        self.cfg = cfg or AdaptiveConfig()
        self.policy = policy
        self.store = store
        self.targets = tuple(targets)
        self.device = torch.device(device)
        self.mult = M.get(policy.mult_name)
        self.telemetry = Telemetry(self.mult.bits, self.cfg.decay)
        self.detector = DriftDetector(DriftConfig(
            threshold=self.cfg.drift_threshold,
            min_steps=self.cfg.min_observe_steps,
        ))
        self.buffers: Dict[str, _RingBuffer] = {
            t: _RingBuffer(self.cfg.buffer_size) for t in self.targets
        }
        self._sweep = all_triples(self.mult.bits)
        self.triples = torch.as_tensor(self._sweep, device=self.device)
        # per-row-tile state: one ring buffer per (target, row tile), made
        # at the granularity the first tile record reports
        self._tile_sweep = tile_triples(self.mult.bits)
        self.tile_sweep = torch.as_tensor(self._tile_sweep, device=self.device)
        self.tile_buffers: Dict[str, List[_RingBuffer]] = {}
        self.tile_retunes: List[TileRetuneEvent] = []
        self.step = 0
        self._dyn_cache = None            # (policy.version, tree)
        self._last_retune_step = -(10 ** 9)
        self.retunes: List[RetuneEvent] = []
        self.log: List[str] = []
        self._log_fn = log_fn
        # the audit trail lives next to the store; store-less controllers
        # keep none
        self.audit = obs.audit_for_store(store) if store is not None else None
        self.quarantine = (TelemetryQuarantine(
            self.mult.bits, z_threshold=self.cfg.quarantine_z)
            if self.cfg.quarantine else None)
        # post-adoption rollback guards, one per promoted target:
        # {target: dict(baseline, version, last_good, last_good_policy,
        #               adopted_step, steps)}
        self._guards: Dict[str, dict] = {}
        self.rollbacks: List[dict] = []
        # the QoR SLO engine (attach_slo) and each target's last guarded
        # adoption, which a qor alert re-arms the guard on
        self.slo = None
        self._last_adoptions: Dict[str, dict] = {}

    @property
    def tile_rows(self) -> int:
        """Per-row-tile granularity the serving engine opens scopes with
        (0 = scalar mode); mirrored by ``fleet.PolicyReader``."""
        return self.cfg.tile_rows

    # -- plumbing ------------------------------------------------------
    def _emit(self, line: str) -> None:
        self.log.append(line)
        if self._log_fn is not None:
            self._log_fn(line)

    def dyn_tree(self) -> Dict[str, torch.Tensor]:
        """The policy's int32 triples (or (tile_rows, 1, 3) grids in tile
        mode) per target, on the controller's device; rebuilt only when the
        policy changes, so steps between re-tunes copy nothing.

        The controller drops the cache at each of its own policy changes:
        the version alone can repeat, since the store rewrites it to the
        version it allocates (after a rejected candidate, the next promotion
        can carry the number of the reverted policy)."""
        if self._dyn_cache is None or self._dyn_cache[0] != self.policy.version:
            self._dyn_cache = (self.policy.version,
                               self.policy.dyn_tree(self.targets, self.cfg.tile_rows,
                                                    device=self.device))
        return self._dyn_cache[1]

    def adopt(self, policy: SwapPolicy) -> None:
        """Replace the live policy (store restore / reader sync).  The tree
        of :meth:`dyn_tree` is keyed on ``self.targets``, so adoption
        changes int32 values only."""
        if policy.mult_name != self.policy.mult_name:
            raise ValueError(f"cannot adopt a {policy.mult_name} policy into a "
                             f"{self.policy.mult_name} controller")
        self.policy = policy
        self._dyn_cache = None

    def resume_from_store(self) -> bool:
        """Restart protocol: adopt the store's current policy when one exists
        (True), else publish the starting policy as version 1 so a crash
        before the first re-tune still restores deterministically."""
        if self.store is None:
            return False
        got = self.store.load_current()
        if got is not None:
            version, policy = got
            self.adopt(policy)
            self._emit(f"resumed policy v{version} from store")
            return True
        self.store.publish(self.policy)
        return False

    def rebase_reference(self, threshold: Optional[float] = None) -> None:
        """End-of-warm-up freeze: rebase every target's drift reference to
        the converged telemetry snapshot (and the SLO engine's QoR
        references), optionally arming the detector with its production
        ``threshold``."""
        for target, snap in self.telemetry.snapshot().items():
            if snap.get("bit_probs") is not None:
                self.detector.rebase(target, snap["bit_probs"])
            if (self.slo is not None and not is_tile_key(target)
                    and snap.get("ew_mae") is not None):
                self.slo.set_reference(target, float(snap["ew_mae"]))
        if threshold is not None:
            self.detector.cfg.threshold = threshold
            self.cfg.drift_threshold = threshold

    def attach_slo(self, engine) -> None:
        """Attach an :class:`~repro_torch.obs.slo.SLOEngine`: every observed
        step feeds the per-target ``ew_mae`` stream to its qor specs, the
        current drift-reference MAE seeds the guard bands, alerting
        veto-bearing specs block canary promotion, and qor alerts re-arm the
        rollback guard on that target's most recent promoted adoption."""
        self.slo = engine
        for target, snap in self.telemetry.snapshot().items():
            if not is_tile_key(target) and snap.get("ew_mae") is not None:
                engine.set_reference(target, float(snap["ew_mae"]))

    def warmup(self) -> None:
        """Run the re-tune scorers once at their shapes (and the canary's
        two-triple holdout shape), so the first re-tune pays no device
        set-up."""
        zeros = torch.zeros(self.cfg.buffer_size, dtype=torch.int32, device=self.device)
        _score_configs(self.mult, zeros, zeros, self.triples, self.cfg.metric)
        if self.cfg.tile_rows > 0:
            tz = torch.zeros((self.cfg.tile_rows, self.cfg.tile_buffer_size),
                             dtype=torch.int32, device=self.device)
            _score_configs(self.mult, tz, tz, self.tile_sweep, self.cfg.metric)
        if self.cfg.canary:
            hz = torch.zeros(self.cfg.canary_holdout, dtype=torch.int32, device=self.device)
            _score_configs(self.mult, hz, hz, self.triples[:2], self.cfg.metric)

    # -- observation ---------------------------------------------------
    def observe(self, records: Dict[str, Dict[str, np.ndarray]]) -> List[str]:
        """Fold one step's host records in (``telemetry.records_to_host``);
        re-tune on drift.  Records keyed ``<target>@tiles`` feed the
        per-row-tile loop.  Returns the log lines emitted for this step."""
        mark = len(self.log)
        faults = _chaos().fire("controller.observe", step=self.step)
        if faults:
            records = _chaos().poison_records(faults, records)
        if self.quarantine is not None:
            records, dropped = self.quarantine.filter(records)
            for target, reason in dropped:
                self._emit(f"quarantined {target} record ({reason})")
                if self.audit is not None:
                    self.audit.append("quarantine", step=self.step,
                                      target=target, reason=reason)
        self.telemetry.update(records)
        for target, rec in records.items():
            if is_tile_key(target):
                self._tile_buffer_add(base_target(target), rec)
                continue
            buf = self.buffers.get(target)
            if buf is not None:
                buf.add(rec["a_smp"], rec["b_smp"])
        self.step += 1
        if self.slo is not None:
            for target, snap in self.telemetry.snapshot().items():
                if not is_tile_key(target) and snap.get("ew_mae") is not None:
                    self.slo.observe_qor(target, float(snap["ew_mae"]))
            for al in self.slo.alerting():
                # a qor alert on a target whose guarded adoption already
                # disarmed re-arms the rollback guard on that adoption
                la = self._last_adoptions.get(al.source)
                if al.kind != "qor" or al.source in self._guards or la is None:
                    continue
                self._emit(f"slo alert [{al.slo}] re-arming rollback guard "
                           f"on {al.source}")
                self._arm_guard(al.source, la["version"], la["last_good"],
                                la["last_good_policy"], la["ev"])
        # the rollback guard before drift: a regressed adoption rolls back
        # within one sweep instead of racing a fresh re-tune for it
        self._check_guards()

        if self.step - self._last_retune_step > self.cfg.cooldown_steps:
            drifted = self.detector.check(self.telemetry.snapshot())
            for target, score in drifted:
                if is_tile_key(target):
                    if base_target(target) in self.tile_buffers:
                        self.retune_tiles(base_target(target), drift=score)
                elif target in self.buffers:
                    self.retune(target, drift=score)
        return self.log[mark:]

    def _tile_buffer_add(self, target: str, rec: Dict[str, np.ndarray]) -> None:
        """Refresh the per-(target, tile) ring buffers from a stacked tile
        record (samples are (ncalls, S, gm): tiles on the last axis)."""
        a = np.asarray(rec["tile_a_smp"])
        b = np.asarray(rec["tile_b_smp"])
        gm = a.shape[-1]
        bufs = self.tile_buffers.get(target)
        if bufs is None or len(bufs) != gm:
            bufs = self.tile_buffers[target] = [
                _RingBuffer(self.cfg.tile_buffer_size) for _ in range(gm)]
        for t in range(gm):
            bufs[t].add(a[..., t].reshape(-1), b[..., t].reshape(-1))

    def observe_operands(self, target: str, a, b) -> List[str]:
        """Feed a raw integer operand batch (no engine needed; synthetic
        drift streams).  In tile mode a 2-D ``a`` also produces the
        per-row-tile record (rows are the tiled dimension).  Operands are
        taken as int32, as the JAX package takes them."""
        dyn = torch.as_tensor(triple_of(self.policy.lookup(target)), dtype=torch.int32,
                              device=self.device)
        a = torch.as_tensor(np.asarray(a, np.int32), device=self.device)
        b = torch.as_tensor(np.asarray(b, np.int32), device=self.device)
        recs = {target: operand_summary(a, b, self.mult, dyn)}
        if self.cfg.tile_rows > 0 and a.dim() >= 2:
            recs[tile_key(target)] = tile_summary(a, b, self.mult, self.cfg.tile_rows,
                                                  dyn=dyn)
        host = records_to_host(recs)
        return self.observe({t: {k: v[None] for k, v in rec.items()}
                             for t, rec in host.items()})

    # -- re-tuning -----------------------------------------------------
    def _scores(self, a, b, triples) -> np.ndarray:
        return _score_configs(self.mult, torch.as_tensor(a, device=self.device),
                              torch.as_tensor(b, device=self.device), triples,
                              self.cfg.metric)

    def retune(self, target: str, drift: float = 0.0) -> RetuneEvent:
        """Re-tune one target over its live operand buffer: NoSwap and all
        4M configs scored in one batched call.

        With ``cfg.canary`` the winner is not adopted directly: it is
        published as a store candidate, scored against the incumbent on the
        holdout (:meth:`_canary`), and promoted to CURRENT only on a
        confirmed gain with no SLO veto; a rejected winner keeps the
        incumbent serving.  Every promotion arms the rollback guard."""
        t0 = time.perf_counter()
        _chaos().maybe_stall(_chaos().fire("controller.retune", target=target),
                             default=0.05)
        with obs.span("retune", cat="adapt", target=target, drift=drift):
            a, b = self.buffers[target].operands()
            scores = self._scores(a, b, self.triples)
            best = int(np.argmin(scores))
            old = self.policy.lookup(target)
            old_idx = int(np.nonzero((self._sweep == np.asarray(triple_of(old))).all(1))[0][0])
            new = None if best == 0 else all_configs(self.mult.bits)[best - 1]
            ev = RetuneEvent(self.step, target, drift, old, new,
                             float(scores[old_idx]), float(scores[best]))
            guarded = self.cfg.canary and best != old_idx
            last_good_policy = self._policy_copy() if guarded else None
            last_good = (self.store.current_version()
                         if guarded and self.store is not None else None)
            self.policy.set_config(target, new)
            self._dyn_cache = None
            veto = None
            canary_scores = None
            if guarded:
                if self.store is not None:
                    ev.candidate_version = self.store.publish_candidate(self.policy)
                ok, canary_scores = self._canary(target, old_idx, best)
                if ok and self.slo is not None:
                    # an alerting veto-bearing SLO pre-empts promotion: the
                    # holdout cannot be trusted to represent live traffic
                    veto = self.slo.vetoes_promotion()
                    if veto is not None:
                        ok = False
                        self._emit(f"canary[{target}] promotion VETOED by "
                                   f"alerting SLO [{veto}]")
                if not ok:
                    # keep the incumbent serving: revert, drop the candidate
                    self.policy.set_config(target, old)
                    if self.store is not None:
                        self.store.reject_candidate(ev.candidate_version)
                    ev.promoted = False
                    _CANARY.inc(1, outcome="slo_veto" if veto else "rejected")
                else:
                    _CANARY.inc(1, outcome="promoted")
            snap = self.telemetry.snapshot().get(target)
            if snap is not None and snap.get("bit_probs") is not None:
                self.detector.rebase(target, snap["bit_probs"])
            self._last_retune_step = self.step
            self.retunes.append(ev)
            self._emit(ev.describe())
            version = None
            if self.store is not None and ev.promoted:
                if guarded:
                    version = self.store.promote(ev.candidate_version)
                else:
                    version = self.store.publish(self.policy)
                self._emit(f"published policy v{version}")
            if guarded and ev.promoted:
                self._arm_guard(target, version, last_good, last_good_policy, ev)
        _RETUNES.inc(1, kind="scalar")
        _RETUNE_WALL.observe(time.perf_counter() - t0)
        _RETUNE_GAIN.set(ev.old_score - ev.new_score, target=target)
        if self.audit is not None:
            kind = ("retune" if ev.promoted
                    else "slo_veto" if veto is not None
                    else "canary_rejected")
            # the canary's holdout scores ride along on promoted guarded
            # events too: the realized gain beside the predicted one
            extra = {} if canary_scores is None else dict(canary=canary_scores)
            if veto is not None:
                extra["vetoed_by"] = veto
            self.audit.append(
                kind, step=self.step, target=target, drift=float(drift),
                old="noswap" if old is None else old.short(),
                new="noswap" if new is None else new.short(),
                old_score=ev.old_score, new_score=ev.new_score,
                predicted_gain=ev.old_score - ev.new_score,
                store_version=version,
                candidate_version=ev.candidate_version, **extra)
        return ev

    # -- guarded rollout (canary + auto-rollback) ----------------------
    def _policy_copy(self) -> SwapPolicy:
        """Bit-identical snapshot of the live policy through the JSON the
        store writes, so a rollback restores exactly what was served."""
        return SwapPolicy.from_json(self.policy.to_json())

    def _canary(self, target: str, old_idx: int, best: int):
        """Score incumbent vs winner on the canary holdout (the
        ``canary_holdout`` newest ring-buffer elements) in one call of the
        re-tune scorer on the controller's device.  Confirms when the
        winner's holdout score beats the incumbent's by at least
        ``canary_margin`` (fraction)."""
        with obs.span("canary", cat="adapt", target=target):
            a, b = self.buffers[target].recent(self.cfg.canary_holdout)
            s = self._scores(a, b, self.triples[[old_idx, best]])
            incumbent, winner = float(s[0]), float(s[1])
            ok = winner <= incumbent * (1.0 - self.cfg.canary_margin) + 1e-12
        self._emit(f"canary[{target}] incumbent={incumbent:.3f} "
                   f"winner={winner:.3f} -> "
                   f"{'CONFIRMED' if ok else 'REJECTED'}")
        obs.instant("canary", cat="adapt", target=target,
                    incumbent=incumbent, winner=winner, confirmed=ok)
        return ok, dict(incumbent=incumbent, winner=winner,
                        margin=self.cfg.canary_margin)

    def _arm_guard(self, target: str, version: Optional[int],
                   last_good: Optional[int],
                   last_good_policy: SwapPolicy, ev: RetuneEvent) -> None:
        """Watch a just-promoted adoption: if the target's live ``ew_mae``
        regresses past ``baseline * (1 + rollback_guard)`` within
        ``rollback_window`` observed steps, :meth:`_rollback` fires."""
        snap = self.telemetry.snapshot().get(target) or {}
        base = snap.get("ew_mae")
        self._guards[target] = dict(
            baseline=float(base) if base is not None else float(ev.new_score),
            version=version, last_good=last_good,
            last_good_policy=last_good_policy,
            adopted_step=self.step, steps=0)
        # kept after the guard disarms: an SLO alert on this target re-arms
        # the guard on this (most recent) adoption
        self._last_adoptions[target] = dict(
            version=version, last_good=last_good,
            last_good_policy=last_good_policy, ev=ev)

    def _check_guards(self) -> None:
        """Post-adoption rollback guard sweep (every observed step, before
        drift): disarm guards that survive their window, roll back targets
        whose telemetry MAE regressed past the guard band."""
        if not self._guards:
            return
        snaps = self.telemetry.snapshot()
        for target in list(self._guards):
            g = self._guards[target]
            g["steps"] += 1
            if g["steps"] > self.cfg.rollback_window:
                del self._guards[target]          # adoption survived
                continue
            snap = snaps.get(target)
            if (g["steps"] < self.cfg.rollback_min_steps or snap is None
                    or snap.get("ew_mae") is None):
                continue
            band = g["baseline"] * (1.0 + self.cfg.rollback_guard)
            observed = float(snap["ew_mae"])
            if observed > band:
                self._rollback(target, g, observed=observed, band=band)

    def _rollback(self, target: str, g: dict, observed: float,
                  band: float) -> None:
        """Re-point serving to last-good: restore the pre-adoption policy
        snapshot bit-identically, re-point the store's CURRENT at the
        last-good version (readers adopt on their next poll), rebase the
        drift reference and start a cooldown so the bad window's telemetry
        cannot re-trigger the same re-tune at once."""
        with obs.span("rollback", cat="adapt", target=target):
            self.policy = g["last_good_policy"]
            self._dyn_cache = None
            version = None
            if self.store is not None and g["last_good"] is not None:
                version = self.store.rollback(g["last_good"])
            snap = self.telemetry.snapshot().get(target)
            if snap is not None and snap.get("bit_probs") is not None:
                self.detector.rebase(target, snap["bit_probs"])
            self._last_retune_step = self.step
            del self._guards[target]
            info = dict(step=self.step, target=target,
                        from_version=g["version"],
                        to_version=(version if version is not None
                                    else g["last_good"]),
                        baseline=g["baseline"], observed=observed)
            self.rollbacks.append(info)
            _ROLLBACKS.inc(1)
            restored = ("" if info["to_version"] is None
                        else f" -> restored v{info['to_version']}")
            self._emit(f"ROLLBACK[{target}] step={self.step} ew_mae={observed:.3f} "
                       f"> band={band:.3f}{restored}")
        if self.audit is not None:
            self.audit.append(
                "rollback", trigger="rollback", step=self.step, target=target,
                observed_mae=observed, baseline_mae=g["baseline"],
                guard=self.cfg.rollback_guard, from_version=g["version"],
                store_version=version)

    def retune_tiles(self, target: str, drift: float = 0.0) -> TileRetuneEvent:
        """Per-row-tile re-tune of one target: one batched call scores NoSwap
        and every A-side config over every tile's operand buffer; the
        per-tile winners become the target's tile grid (published to the
        store directly: tile grids are not canaried, as in the JAX
        package)."""
        t0 = time.perf_counter()
        with obs.span("retune_tiles", cat="adapt", target=target, drift=drift):
            bufs = self.tile_buffers[target]
            gm = len(bufs)
            a_tiles = np.stack([b.operands()[0] for b in bufs])
            b_tiles = np.stack([b.operands()[1] for b in bufs])
            scores = self._scores(a_tiles, b_tiles, self.tile_sweep)    # (gm, 2M+1)
            best = np.argmin(scores, axis=1)
            sweep = self._tile_sweep
            grid = sweep[best][:, None, :]                              # (gm, 1, 3)

            # incumbent per-tile score: the published grid resampled to this
            # granularity, mapped into the sweep (B-side incumbents count as
            # NoSwap, their per-row-tile execution semantics)
            old_grid = self.policy.tile_grid(target, gm, 1)
            old_idx = np.zeros(gm, np.int64)
            for t in range(gm):
                hit = np.nonzero((sweep == old_grid[t, 0]).all(1))[0]
                old_idx[t] = hit[0] if len(hit) else 0
            old_score = float(np.mean(scores[np.arange(gm), old_idx]))
            new_score = float(np.mean(scores[np.arange(gm), best]))

            self.policy.set_tile_grid(target, grid)
            self._dyn_cache = None
            snap = self.telemetry.snapshot().get(tile_key(target))
            if snap is not None and snap.get("bit_probs") is not None:
                self.detector.rebase(tile_key(target), snap["bit_probs"])
            self._last_retune_step = self.step
            ev = TileRetuneEvent(self.step, target, drift, grid, old_score, new_score)
            self.tile_retunes.append(ev)
            self._emit(ev.describe())
            version = None
            if self.store is not None:
                version = self.store.publish(self.policy)
                self._emit(f"published policy v{version}")
        _RETUNES.inc(1, kind="tile")
        _RETUNE_WALL.observe(time.perf_counter() - t0)
        _RETUNE_GAIN.set(old_score - new_score, target=target)
        if self.audit is not None:
            self.audit.append(
                "tile_retune", step=self.step, target=target,
                drift=float(drift), tile_rows=gm,
                grid_digest=obs.grid_digest(grid),
                old_score=old_score, new_score=new_score,
                predicted_gain=old_score - new_score, store_version=version)
        return ev

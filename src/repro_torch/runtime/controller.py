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

Scores are exact: integer error sums divided by the sample size at the end
(the JAX package takes an f32 mean, which can order a near-tie differently).

Not ported yet: the guarded rollout (``canary``, rollback) and the policy
store (the policy store and rollout, ROADMAP queue 1), and the SLO engine
(observability, ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import multipliers as M
from repro_torch.core.metrics import abs_err
from repro_torch.core.swapper import SwapConfig, all_configs, apply_swapper_dyn

from .drift import DriftConfig, DriftDetector
from .policy import NO_SWAP_TRIPLE, SwapPolicy, triple_of, triple_short
from .telemetry import (Telemetry, TelemetryQuarantine, base_target, is_tile_key,
                        operand_summary, records_to_host, tile_key, tile_summary)

__all__ = ["AdaptiveConfig", "RetuneEvent", "TileRetuneEvent",
           "AdaptiveController", "all_triples", "tile_triples"]


def _deferred(what: str, work: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {work} (ROADMAP queue 1)")


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
    # guarded rollout (canary + auto-rollback; its holdout, margin and
    # rollback knobs come with it): the policy store and rollout, ROADMAP
    # queue 1
    canary: bool = False
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

    def describe(self) -> str:
        fmt = lambda c: "noswap" if c is None else c.short()
        return (f"retune[{self.target}] step={self.step} drift={self.drift:.3f} "
                f"{fmt(self.old)} ({self.old_score:.2f}) -> "
                f"{fmt(self.new)} ({self.new_score:.2f})")


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


class AdaptiveController:
    """Owns the telemetry, drift detector, operand buffers and the policy.

    ``device`` — where the policy's int32 tensors (:meth:`dyn_tree`) live
    and where the re-tune scorers run: the card unless the caller asks for
    the CPU."""

    def __init__(self, policy: SwapPolicy, targets: Sequence[str],
                 cfg: Optional[AdaptiveConfig] = None,
                 log_fn: Optional[Callable[[str], None]] = None,
                 store=None, device="cuda"):
        self.cfg = cfg or AdaptiveConfig()
        if store is not None:
            raise _deferred("the policy store (store=)",
                            "the policy store and rollout, fleet/store.py")
        if self.cfg.canary:
            raise _deferred("the guarded rollout (canary=True)",
                            "the policy store and rollout, with obs/slo.py")
        self.policy = policy
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
        self.triples = torch.as_tensor(all_triples(self.mult.bits), device=self.device)
        # per-row-tile state: one ring buffer per (target, row tile), made
        # at the granularity the first tile record reports
        self.tile_sweep = torch.as_tensor(tile_triples(self.mult.bits), device=self.device)
        self.tile_buffers: Dict[str, List[_RingBuffer]] = {}
        self.tile_retunes: List[TileRetuneEvent] = []
        self.step = 0
        self._dyn_cache = None            # (policy.version, tree)
        self._last_retune_step = -(10 ** 9)
        self.retunes: List[RetuneEvent] = []
        self.log: List[str] = []
        self._log_fn = log_fn
        self.quarantine = (TelemetryQuarantine(
            self.mult.bits, z_threshold=self.cfg.quarantine_z)
            if self.cfg.quarantine else None)

    @property
    def tile_rows(self) -> int:
        """Per-row-tile granularity the serving engine opens scopes with
        (0 = scalar mode)."""
        return self.cfg.tile_rows

    # -- plumbing ------------------------------------------------------
    def _emit(self, line: str) -> None:
        self.log.append(line)
        if self._log_fn is not None:
            self._log_fn(line)

    def dyn_tree(self) -> Dict[str, torch.Tensor]:
        """The policy's int32 triples (or (tile_rows, 1, 3) grids in tile
        mode) per target, on the controller's device; rebuilt only when the
        policy version changes, so steps between re-tunes copy nothing."""
        if self._dyn_cache is None or self._dyn_cache[0] != self.policy.version:
            self._dyn_cache = (self.policy.version,
                               self.policy.dyn_tree(self.targets, self.cfg.tile_rows,
                                                    device=self.device))
        return self._dyn_cache[1]

    def rebase_reference(self, threshold: Optional[float] = None) -> None:
        """End-of-warm-up freeze: rebase every target's drift reference to
        the converged telemetry snapshot, optionally arming the detector
        with its production ``threshold``."""
        for target, snap in self.telemetry.snapshot().items():
            if snap.get("bit_probs") is not None:
                self.detector.rebase(target, snap["bit_probs"])
        if threshold is not None:
            self.detector.cfg.threshold = threshold
            self.cfg.drift_threshold = threshold

    def attach_slo(self, engine) -> None:
        raise _deferred("the SLO engine (attach_slo)", "observability, obs/slo.py")

    def warmup(self) -> None:
        """Run the re-tune scorers once at their shapes, so the first
        re-tune pays no device set-up."""
        zeros = torch.zeros(self.cfg.buffer_size, dtype=torch.int32, device=self.device)
        _score_configs(self.mult, zeros, zeros, self.triples, self.cfg.metric)
        if self.cfg.tile_rows > 0:
            tz = torch.zeros((self.cfg.tile_rows, self.cfg.tile_buffer_size),
                             dtype=torch.int32, device=self.device)
            _score_configs(self.mult, tz, tz, self.tile_sweep, self.cfg.metric)

    # -- observation ---------------------------------------------------
    def observe(self, records: Dict[str, Dict[str, np.ndarray]]) -> List[str]:
        """Fold one step's host records in (``telemetry.records_to_host``);
        re-tune on drift.  Records keyed ``<target>@tiles`` feed the
        per-row-tile loop.  Returns the log lines emitted for this step."""
        mark = len(self.log)
        if self.quarantine is not None:
            records, dropped = self.quarantine.filter(records)
            for target, reason in dropped:
                self._emit(f"quarantined {target} record ({reason})")
        self.telemetry.update(records)
        for target, rec in records.items():
            if is_tile_key(target):
                self._tile_buffer_add(base_target(target), rec)
                continue
            buf = self.buffers.get(target)
            if buf is not None:
                buf.add(rec["a_smp"], rec["b_smp"])
        self.step += 1

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
    def retune(self, target: str, drift: float = 0.0) -> RetuneEvent:
        """Re-tune one target over its live operand buffer: NoSwap and all
        4M configs scored in one batched call."""
        a, b = self.buffers[target].operands()
        scores = _score_configs(self.mult, torch.as_tensor(a, device=self.device),
                                torch.as_tensor(b, device=self.device),
                                self.triples, self.cfg.metric)
        best = int(np.argmin(scores))
        old = self.policy.lookup(target)
        old_idx = int(np.nonzero((self.triples.cpu().numpy()
                                  == np.asarray(triple_of(old))).all(1))[0][0])
        new = None if best == 0 else all_configs(self.mult.bits)[best - 1]
        ev = RetuneEvent(self.step, target, drift, old, new,
                         float(scores[old_idx]), float(scores[best]))
        self.policy.set_config(target, new)
        snap = self.telemetry.snapshot().get(target)
        if snap is not None and snap.get("bit_probs") is not None:
            self.detector.rebase(target, snap["bit_probs"])
        self._last_retune_step = self.step
        self.retunes.append(ev)
        self._emit(ev.describe())
        return ev

    def retune_tiles(self, target: str, drift: float = 0.0) -> TileRetuneEvent:
        """Per-row-tile re-tune of one target: one batched call scores NoSwap
        and every A-side config over every tile's operand buffer; the
        per-tile winners become the target's tile grid."""
        bufs = self.tile_buffers[target]
        gm = len(bufs)
        a_tiles = np.stack([b.operands()[0] for b in bufs])
        b_tiles = np.stack([b.operands()[1] for b in bufs])
        scores = _score_configs(self.mult, torch.as_tensor(a_tiles, device=self.device),
                                torch.as_tensor(b_tiles, device=self.device),
                                self.tile_sweep, self.cfg.metric)     # (gm, 2M+1)
        best = np.argmin(scores, axis=1)
        sweep = self.tile_sweep.cpu().numpy()
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
        snap = self.telemetry.snapshot().get(tile_key(target))
        if snap is not None and snap.get("bit_probs") is not None:
            self.detector.rebase(tile_key(target), snap["bit_probs"])
        self._last_retune_step = self.step
        ev = TileRetuneEvent(self.step, target, drift, grid, old_score, new_score)
        self.tile_retunes.append(ev)
        self._emit(ev.describe())
        return ev

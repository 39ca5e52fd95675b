"""Per-request quality-of-result (QoR) attribution (``repro.obs.qor``).

SWAPPER's error telemetry leaves every observed decode step as limb-exact
per-target (and per-row-tile) absolute-error sums.  This module reduces
them on the host:

* :func:`step_error_summary` turns one step's record tree into per-target
  step MAE and per-tile MAE vectors;
* :class:`ErrorAttributor` charges each observed step's error profile to
  the correlation ids live in that step (a request's attribution is its
  step-weighted *exposure*) and, at retirement, summarises per-target mean
  step MAE, each target's share, and the top-k contributing targets with
  their worst tile.  A request with no observed decode step falls back to
  the fleet profile (``basis="fleet"``).  The continuous batcher
  (``fleet/scheduler.py``) calls it as each request retires.

Plain numpy over records already copied to the host; the field names mirror
``runtime.telemetry``'s record schema (``err_lo``/``err_hi``/``n``,
``tile_err_lo``/``tile_err_hi``/``tile_n``, the ``@tiles`` key suffix),
pinned by a test so ``obs`` imports nothing of the runtime.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .metrics import QOR_MAE_BUCKETS, default_registry

__all__ = [
    "TILE_KEY_SUFFIX",
    "step_error_summary",
    "ErrorAttributor",
]

# mirrors runtime.telemetry.TILE_KEY_SUFFIX (pinned by a test; obs imports
# nothing from the runtime so instrumentation can never perturb traces)
TILE_KEY_SUFFIX = "@tiles"

_REG = default_registry()
_REQ_MAE = _REG.histogram(
    "repro_qor_request_mae",
    "per-request mean step MAE by target at retirement (QoR attribution; "
    "product units of the approximate multiplier)",
    buckets=QOR_MAE_BUCKETS)
_REQS = _REG.counter(
    "repro_qor_requests_total",
    "requests retired with a QoR attribution summary, by basis "
    "(request = own decode exposure / fleet = zero-step fallback)")
_SHARE = _REG.gauge(
    "repro_qor_error_share",
    "fleet-level share of cumulative attributed error by target "
    "(refreshed at every retirement)")


def _limb_mae(lo, hi, n) -> Optional[float]:
    """Recombine 16-bit error-limb sums into a mean absolute error (the
    same arithmetic ``TargetTelemetry.update`` applies)."""
    n = float(np.sum(np.asarray(n, np.float64)))
    if n <= 0:
        return None
    lo = float(np.sum(np.asarray(lo, np.float64)))
    hi = float(np.sum(np.asarray(hi, np.float64)))
    return (lo + hi * 65536.0) / n


def step_error_summary(records: Dict[str, Dict[str, np.ndarray]]
                       ) -> Tuple[Dict[str, float], Dict[str, np.ndarray]]:
    """Reduce one step's record tree to ``(per-target step MAE,
    per-target per-tile MAE vectors)``.  Records without error limbs (or
    with ``n == 0`` — a gated-off zero record) are skipped."""
    scalars: Dict[str, float] = {}
    tiles: Dict[str, np.ndarray] = {}
    for key, rec in records.items():
        if key.endswith(TILE_KEY_SUFFIX):
            if "tile_err_lo" not in rec:
                continue                  # pre-QoR tile record: no limbs
            lo = np.asarray(rec["tile_err_lo"], np.float64)
            hi = np.asarray(rec["tile_err_hi"], np.float64)
            n = np.asarray(rec["tile_n"], np.float64)
            # stacked per-call arrays: sum the call axis, keep tiles
            lo = lo.reshape(-1, lo.shape[-1]).sum(axis=0)
            hi = hi.reshape(-1, hi.shape[-1]).sum(axis=0)
            n = np.maximum(n.reshape(-1, n.shape[-1]).sum(axis=0), 1.0)
            tiles[key[:-len(TILE_KEY_SUFFIX)]] = (lo + hi * 65536.0) / n
            continue
        if "err_lo" not in rec:
            continue
        mae = _limb_mae(rec["err_lo"], rec["err_hi"], rec["n"])
        if mae is not None:
            scalars[key] = mae
    return scalars, tiles


@dataclasses.dataclass
class _RequestExposure:
    corr: str
    rid: int
    steps: int = 0
    err: Dict[str, float] = dataclasses.field(default_factory=dict)
    err_steps: Dict[str, int] = dataclasses.field(default_factory=dict)
    tile_err: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    tile_steps: Dict[str, int] = dataclasses.field(default_factory=dict)


class ErrorAttributor:
    """Host-side per-request error attribution over step telemetry.

    Lifecycle (as a token-granular scheduler drives it):
    :meth:`begin` at the admission splice, :meth:`observe_step` with each
    gated step's host records plus the correlation ids live in that step,
    :meth:`finish` at retirement — returning the summary the scheduler
    attaches to the ``Completion``.
    """

    def __init__(self, top_k: int = 3):
        self.top_k = int(top_k)
        self._live: Dict[str, _RequestExposure] = {}
        # fleet-level accumulators: per-target cumulative step MAE — the
        # zero-exposure fallback profile and the _SHARE gauge source
        self._fleet_err: Dict[str, float] = {}
        self._fleet_tiles: Dict[str, np.ndarray] = {}
        self._fleet_steps = 0
        self.finished = 0

    # -- lifecycle -----------------------------------------------------
    def begin(self, corr: str, rid: int) -> None:
        self._live[corr] = _RequestExposure(corr=corr, rid=rid)

    def observe_step(self, records: Dict[str, Dict[str, np.ndarray]],
                     live: Sequence[str]) -> None:
        """Charge one gated step's error profile to the requests that were
        live in it.  Unknown correlation ids (already retired when a stale
        record lands) are dropped silently."""
        scalars, tiles = step_error_summary(records)
        if not scalars and not tiles:
            return
        self._fleet_steps += 1
        for t, mae in scalars.items():
            self._fleet_err[t] = self._fleet_err.get(t, 0.0) + mae
        for t, vec in tiles.items():
            acc = self._fleet_tiles.get(t)
            self._fleet_tiles[t] = (vec.copy() if acc is None
                                    or acc.shape != vec.shape else acc + vec)
        for corr in live:
            rq = self._live.get(corr)
            if rq is None:
                continue
            rq.steps += 1
            for t, mae in scalars.items():
                rq.err[t] = rq.err.get(t, 0.0) + mae
                rq.err_steps[t] = rq.err_steps.get(t, 0) + 1
            for t, vec in tiles.items():
                acc = rq.tile_err.get(t)
                rq.tile_err[t] = (vec.copy() if acc is None
                                  or acc.shape != vec.shape else acc + vec)
                rq.tile_steps[t] = rq.tile_steps.get(t, 0) + 1

    def finish(self, corr: str) -> Optional[dict]:
        """Close out a request: pop its exposure and build the summary
        (None only for a correlation id that was never begun)."""
        rq = self._live.pop(corr, None)
        if rq is None:
            return None
        basis = "request"
        err, err_steps = rq.err, rq.err_steps
        tile_err, tile_steps = rq.tile_err, rq.tile_steps
        if not err and self._fleet_steps > 0:
            # zero observed decode steps (1-token request): attribute the
            # fleet profile so the completion still carries the QoR signal
            basis = "fleet"
            err = dict(self._fleet_err)
            err_steps = {t: self._fleet_steps for t in err}
            tile_err = dict(self._fleet_tiles)
            tile_steps = {t: self._fleet_steps for t in tile_err}
        targets = {t: err[t] / max(err_steps.get(t, 1), 1) for t in err}
        total = sum(err.values())
        share = {t: (err[t] / total if total > 0 else 0.0) for t in err}
        tiles = {t: (tile_err[t] / max(tile_steps.get(t, 1), 1)).tolist()
                 for t in tile_err}
        top: List[dict] = []
        for t in sorted(share, key=share.get, reverse=True)[:self.top_k]:
            entry = dict(where=t, share=share[t], ew_mae=targets[t])
            tv = tile_err.get(t)
            if tv is not None and tv.size and tv.sum() > 0:
                entry["top_tile"] = int(np.argmax(tv))
                entry["tile_share"] = float(tv.max() / tv.sum())
            top.append(entry)
        self.finished += 1
        _REQS.inc(1, basis=basis)
        for t, mae in targets.items():
            _REQ_MAE.observe(mae, target=t)
        fleet_total = sum(self._fleet_err.values())
        if fleet_total > 0:
            for t, v in self._fleet_err.items():
                _SHARE.set(v / fleet_total, target=t)
        return dict(corr=rq.corr, rid=rq.rid, steps=rq.steps, basis=basis,
                    ew_mae=targets, share=share, tiles=tiles, top=top,
                    weighting="step-exposure")

    # -- introspection -------------------------------------------------
    def fleet_share(self) -> Dict[str, float]:
        total = sum(self._fleet_err.values())
        if total <= 0:
            return {}
        return {t: v / total for t, v in sorted(self._fleet_err.items())}

    def describe(self) -> str:
        share = ", ".join(f"{t}={s:.2f}" for t, s in self.fleet_share().items())
        return (f"qor finished={self.finished} live={len(self._live)} "
                f"steps={self._fleet_steps} share=[{share}]")

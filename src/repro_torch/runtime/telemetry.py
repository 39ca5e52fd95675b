"""Streaming operand/error telemetry for the adaptive SWAPPER runtime
(``repro.runtime.telemetry``).

* **Device summaries** (:func:`operand_summary`, :func:`tile_summary`) —
  small fixed-shape statistics of the quantized int8 operands of one
  projection call, computed on the operands' device: per-bit occupancy
  counts, exact absolute-error limb sums of the *live* policy (the 16-bit
  limb scheme of ``core/metrics.py``), and operand samples for the
  controller's re-tune buffers.  :func:`start_host_copy` /
  :func:`finish_host_copy` bring a step's records to numpy, with the JAX
  package's field types, without stalling the card.

* **Host accumulators** (:class:`Telemetry`) — exponentially-decayed bit
  occupancy probabilities (the drift signal) plus an exact cumulative
  :class:`~repro_torch.core.metrics.ErrorStats` window per target.

* **Admission control** (:class:`TelemetryQuarantine`) — NaN/Inf records,
  records that break the summaries' structural bounds and, optionally,
  robust-z MAE outliers are kept out of the accumulators and buffers.

The device summaries carry 32-bit unsigned lanes in int64 (``core/lanes``);
every limb sum stays below 2^32, so the sums equal JAX's uint32 ones.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.metrics import ErrorStats, abs_err
from repro_torch.core.multipliers import AxMult
from repro_torch.core.swapper import NO_SWAP_TRIPLE, apply_swapper_dyn
from repro_torch.core.tiling import rowtile_count, rowtile_span

__all__ = [
    "TELEMETRY_SAMPLE",
    "RETUNE_SAMPLE",
    "TILE_TELEMETRY_SAMPLE",
    "TILE_RETUNE_SAMPLE",
    "TILE_KEY_SUFFIX",
    "SUM_FIELDS",
    "MAX_FIELDS",
    "SAMPLE_FIELDS",
    "tile_key",
    "is_tile_key",
    "base_target",
    "operand_summary",
    "tile_summary",
    "records_to_host",
    "start_host_copy",
    "finish_host_copy",
    "combine_records",
    "TargetTelemetry",
    "TargetTileTelemetry",
    "Telemetry",
    "TelemetryQuarantine",
]

TELEMETRY_SAMPLE = 2048   # elements of each operand entering the bit/error stats
RETUNE_SAMPLE = 512       # operand sample exported per call for the re-tune buffer
TILE_TELEMETRY_SAMPLE = 512  # per-row-tile elements entering the tile bit stats
TILE_RETUNE_SAMPLE = 256     # per-row-tile operand sample for the tile buffers

# Tile records travel under ``<target>@tiles`` (no "/", so the scope's
# hierarchical fallback never strips it).
TILE_KEY_SUFFIX = "@tiles"

# Field classes for combining records: counts and limb sums add, the
# worst-case error is a max, operand samples concatenate along axis -2
# (tile samples are sample-major, (S, gm), so a concatenation extends each
# tile's column).
SUM_FIELDS = ("bits_a", "bits_b", "neg_a", "neg_b", "n",
              "err_lo", "err_hi", "err_cnt",
              "tile_bits_a", "tile_neg_a", "tile_n",
              "tile_err_lo", "tile_err_hi")
MAX_FIELDS = ("err_max",)
SAMPLE_FIELDS = ("a_smp", "b_smp", "tile_a_smp", "tile_b_smp")

# host types of the integer fields (the JAX package's record dtypes)
_UINT32_FIELDS = ("err_lo", "err_hi", "err_max", "tile_err_lo", "tile_err_hi")
_INT32_FIELDS = ("n", "err_cnt", "tile_n")


def tile_key(target: str) -> str:
    """Record key the per-tile summary of ``target`` is collected under."""
    return target + TILE_KEY_SUFFIX


def is_tile_key(key: str) -> bool:
    return key.endswith(TILE_KEY_SUFFIX)


def base_target(key: str) -> str:
    """Inverse of :func:`tile_key` (identity for non-tile keys)."""
    return key[:-len(TILE_KEY_SUFFIX)] if is_tile_key(key) else key


def _head(x: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` entries of the last axis, tiled cyclically when the
    axis is shorter (static shapes without zero-padding that would bias the
    statistics)."""
    if x.shape[-1] < n:
        x = x.repeat(*([1] * (x.dim() - 1)), -(-n // x.shape[-1]))
    return x[..., :n]


def _flat_sample(x: torch.Tensor, n: int) -> torch.Tensor:
    return _head(x.reshape(-1), n)


def _bit_counts(v: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., bits) float32 count of set **magnitude** bits per position over
    the last axis of ``v``.  Raw two's-complement bits hide a symmetric
    distribution shrinking toward zero; the sign is counted separately."""
    shifts = torch.arange(bits, device=v.device)
    return ((v.abs()[..., None] >> shifts) & 1).sum(dim=-2).to(torch.float32)


def _limbs(e: torch.Tensor):
    """Exact 16-bit limb sums of uint32 error lanes over the last axis."""
    return (e & 0xFFFF).sum(dim=-1), (e >> 16).sum(dim=-1)


def operand_summary(xq, wq, mult: AxMult, dyn) -> dict:
    """Fixed-shape telemetry record for one approximate projection call:
    ``xq``/``wq`` are the quantized operands, ``dyn`` the (3,) int32
    (op_is_a, bit, value) triple applied.  Tensors on the operands'
    device."""
    bits = mult.bits
    a = _flat_sample(xq, TELEMETRY_SAMPLE).to(torch.int64)
    b = _flat_sample(wq, TELEMETRY_SAMPLE).to(torch.int64)
    approx = apply_swapper_dyn(mult, a, b, dyn[0], dyn[1], dyn[2])
    e = abs_err(approx, mult.exact_product(a, b), mult.signed)
    lo, hi = _limbs(e)
    return dict(
        bits_a=_bit_counts(a, bits),
        bits_b=_bit_counts(b, bits),
        neg_a=(a < 0).sum().to(torch.float32),
        neg_b=(b < 0).sum().to(torch.float32),
        n=torch.full((), TELEMETRY_SAMPLE, dtype=torch.int32, device=a.device),
        err_lo=lo,
        err_hi=hi,
        err_max=e.max(),
        err_cnt=(e != 0).sum().to(torch.int32),
        a_smp=_flat_sample(xq, RETUNE_SAMPLE),
        b_smp=_flat_sample(wq, RETUNE_SAMPLE),
    )


def tile_summary(xq, wq, mult: AxMult, gm: int, dyn=None, bits_from=None) -> dict:
    """Per-row-tile telemetry record for one projection call.

    The flattened token rows of ``xq`` split into ``gm`` row tiles by the
    same partition the execution paths apply config tiles with
    (``core.tiling.rowtile_*``; ``min(gm, rows)`` tiles when the call is
    smaller, the last tile's absorbed remainder rows unsampled).  Per tile:
    magnitude-bit and sign counts of a ``TILE_TELEMETRY_SAMPLE`` sample, the
    exact error limbs of the triple configured for that tile (``dyn``: a
    (3,) triple, a (gm, 1, 3) row-tile grid, or None = NoSwap), and a
    ``TILE_RETUNE_SAMPLE`` operand sample.  ``wq`` is shared by every row
    tile, so its sample is taken once and broadcast.  Samples are laid out
    (sample, tile).

    ``bits_from`` — the grid kernel's own statistic, ``(tile_bits_a,
    tile_neg_a, tile_n)`` from ``quant.ax.ax_matmul_int_dyn_hist``: full
    per-tile counts replace the sampled bit pass."""
    bits = mult.bits
    x2d = xq.reshape(-1, xq.shape[-1])
    M = x2d.shape[0]
    g = rowtile_count(M, gm)
    rows_per = rowtile_span(M, gm)
    tiles = x2d[:g * rows_per].reshape(g, rows_per * x2d.shape[-1])
    a_t = _head(tiles, TILE_TELEMETRY_SAMPLE).to(torch.int64)       # (g, n)
    if bits_from is not None:
        kb, kn, kc = bits_from
        if tuple(kb.shape) != (g, bits) or tuple(kn.shape) != (g,) or tuple(kc.shape) != (g,):
            raise ValueError(f"bits_from shapes {tuple(kb.shape)}, {tuple(kn.shape)}, "
                             f"{tuple(kc.shape)} do not match {g} tiles of {bits} bits")
    smp = _head(tiles, TILE_RETUNE_SAMPLE)
    b_smp = _flat_sample(wq, TILE_RETUNE_SAMPLE)

    if dyn is None:
        trip = torch.tensor(NO_SWAP_TRIPLE, dtype=torch.int32, device=xq.device).expand(g, 3)
    elif dyn.dim() == 3:
        rows = torch.clamp(torch.arange(g, device=dyn.device), max=dyn.shape[0] - 1)
        trip = dyn[:, 0, :].index_select(0, rows)
    else:
        trip = dyn.reshape(1, 3).expand(g, 3)
    b = _flat_sample(wq, TILE_TELEMETRY_SAMPLE).to(torch.int64)[None, :]
    approx = apply_swapper_dyn(mult, a_t, b, trip[:, 0:1], trip[:, 1:2], trip[:, 2:3])
    e = abs_err(approx, mult.exact_product(a_t, b), mult.signed)
    tile_err_lo, tile_err_hi = _limbs(e)
    if bits_from is not None:
        tile_bits_a = kb.to(torch.float32)
        tile_neg_a = kn.to(torch.float32)
        tile_n = kc.to(torch.int32)
    else:
        tile_bits_a = _bit_counts(a_t, bits)
        tile_neg_a = (a_t < 0).sum(dim=1).to(torch.float32)
        tile_n = torch.full((g,), TILE_TELEMETRY_SAMPLE, dtype=torch.int32, device=xq.device)
    return dict(
        tile_bits_a=tile_bits_a,                                     # (g, bits)
        tile_neg_a=tile_neg_a,                                       # (g,)
        tile_n=tile_n,
        tile_err_lo=tile_err_lo,                                     # (g,)
        tile_err_hi=tile_err_hi,                                     # (g,)
        tile_a_smp=smp.T,                                            # (S, g)
        tile_b_smp=b_smp[:, None].expand(TILE_RETUNE_SAMPLE, g),     # (S, g)
    )


def start_host_copy(records: Dict[str, Dict[str, torch.Tensor]]):
    """Enqueue the device-to-host copy of a step's records without waiting
    for it (into pinned memory on the card); returns a handle for
    :func:`finish_host_copy`.  The stepwise engine observes step i-1 this
    way while step i runs."""
    host = {t: {k: v.to("cpu", non_blocking=True) for k, v in rec.items()}
            for t, rec in records.items()}
    event = None
    dev = next((v.device for rec in records.values() for v in rec.values()), None)
    if dev is not None and dev.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    return host, event


def finish_host_copy(handle) -> Dict[str, Dict[str, np.ndarray]]:
    """Wait for a :func:`start_host_copy` and return the host records."""
    host, event = handle
    if event is not None:
        event.synchronize()
    return records_to_host(host)


def records_to_host(records: Dict[str, Dict[str, torch.Tensor]]
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """A step's record tree as numpy arrays with the JAX package's field
    types (uint32 limb sums, int32 counts, float32 bit counts)."""
    out = {}
    for target, rec in records.items():
        host = {}
        for k, v in rec.items():
            v = v.cpu().numpy()
            if k in _UINT32_FIELDS:
                v = v.astype(np.uint32)
            elif k in _INT32_FIELDS:
                v = v.astype(np.int32)
            host[k] = v
        out[target] = host
    return out


def combine_records(shard_records) -> Dict[str, Dict[str, np.ndarray]]:
    """Fold per-shard host record trees into one record (sum / max / concat
    per the field classes above), as the JAX package's host combiner does."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for records in shard_records:
        for target, rec in records.items():
            acc = out.get(target)
            if acc is None:
                out[target] = {k: np.asarray(v).copy() for k, v in rec.items()}
                continue
            for k, v in rec.items():
                v = np.asarray(v)
                if k in MAX_FIELDS:
                    acc[k] = np.maximum(acc[k], v)
                elif k in SAMPLE_FIELDS:
                    acc[k] = np.concatenate([acc[k], v], axis=-2)
                else:
                    acc[k] = acc[k] + v
    return out



# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TargetTelemetry:
    """Decayed + exact accumulators for one projection target."""

    bits: int
    decay: float
    n_steps: int = 0
    # (2, bits+1) EW occupancy: per-operand magnitude-bit P(bit==1) columns
    # plus a trailing sign-frequency column (the drift statistic)
    bit_probs: Optional[np.ndarray] = None
    ew_mae: Optional[float] = None             # EW-decayed per-step MAE
    stats: ErrorStats = dataclasses.field(default_factory=ErrorStats)

    def update(self, rec: Dict[str, np.ndarray]) -> None:
        """``rec`` holds stacked per-call arrays for one step (leading axis =
        calls of this target inside the step)."""
        n = float(np.sum(rec["n"]))
        probs = np.stack([
            np.concatenate([np.sum(rec["bits_a"], axis=0),
                            np.sum(np.atleast_1d(rec["neg_a"]), keepdims=True)]),
            np.concatenate([np.sum(rec["bits_b"], axis=0),
                            np.sum(np.atleast_1d(rec["neg_b"]), keepdims=True)]),
        ]) / max(n, 1.0)

        step = ErrorStats()
        for lo, hi, mx, cnt, cn in zip(
            np.atleast_1d(rec["err_lo"]), np.atleast_1d(rec["err_hi"]),
            np.atleast_1d(rec["err_max"]), np.atleast_1d(rec["err_cnt"]),
            np.atleast_1d(rec["n"]),
        ):
            step.add_limbs(int(cn), int(lo), int(hi), int(mx), int(cnt), 0.0, 0.0)
        self.stats.n += step.n
        self.stats.sum_abs += step.sum_abs
        self.stats.max_abs = max(self.stats.max_abs, step.max_abs)
        self.stats.count_neq += step.count_neq

        d = self.decay
        if self.bit_probs is None:
            self.bit_probs = probs
            self.ew_mae = step.mae
        else:
            self.bit_probs = (1.0 - d) * self.bit_probs + d * probs
            self.ew_mae = (1.0 - d) * self.ew_mae + d * step.mae
        self.n_steps += 1

    def snapshot(self) -> dict:
        return dict(
            bit_probs=None if self.bit_probs is None else self.bit_probs.copy(),
            ew_mae=self.ew_mae,
            mae=self.stats.mae,
            wce=self.stats.wce,
            ep=self.stats.ep,
            n=self.stats.n,
            n_steps=self.n_steps,
        )


@dataclasses.dataclass
class TargetTileTelemetry:
    """Decayed per-row-tile accumulators for one projection target's
    ``tile_summary`` records (collected under ``tile_key(target)``).

    ``bit_probs`` is a (gm, bits+1) matrix — per row tile, the EW-decayed
    magnitude-bit P(bit==1) columns plus the trailing sign frequency; the
    same sufficient statistic the scalar drift detector uses, one row per
    tile.  The generic :class:`~repro.runtime.drift.DriftDetector` scores it
    unchanged (mean |delta| over the matrix), so a shift confined to one of
    ``gm`` tiles reaches the threshold diluted by ~1/gm — size tile drift
    thresholds accordingly (mirrors the fleet's 1/N shard dilution)."""

    bits: int
    decay: float
    n_steps: int = 0
    bit_probs: Optional[np.ndarray] = None      # (gm, bits+1)
    ew_mae: Optional[np.ndarray] = None         # (gm,) EW per-tile step MAE

    def update(self, rec: Dict[str, np.ndarray]) -> None:
        """``rec`` holds stacked per-call arrays (leading axis = calls of
        this target inside the observed step)."""
        bits_a = np.sum(np.asarray(rec["tile_bits_a"]), axis=0)    # (gm, bits)
        neg_a = np.sum(np.asarray(rec["tile_neg_a"]), axis=0)      # (gm,)
        n = np.maximum(np.sum(np.asarray(rec["tile_n"]), axis=0), 1.0)
        probs = np.concatenate([bits_a, neg_a[:, None]], axis=-1) / n[:, None]
        if self.bit_probs is None or self.bit_probs.shape != probs.shape:
            self.bit_probs = probs
            self.ew_mae = None
        else:
            d = self.decay
            self.bit_probs = (1.0 - d) * self.bit_probs + d * probs
        if "tile_err_lo" in rec:
            lo = np.sum(np.asarray(rec["tile_err_lo"], np.float64), axis=0)
            hi = np.sum(np.asarray(rec["tile_err_hi"], np.float64), axis=0)
            mae = (lo + hi * 65536.0) / n
            if self.ew_mae is None or self.ew_mae.shape != mae.shape:
                self.ew_mae = mae
            else:
                self.ew_mae = (1.0 - self.decay) * self.ew_mae \
                    + self.decay * mae
        self.n_steps += 1

    def snapshot(self) -> dict:
        return dict(
            bit_probs=None if self.bit_probs is None else self.bit_probs.copy(),
            ew_mae=None if self.ew_mae is None else self.ew_mae.copy(),
            n_steps=self.n_steps,
        )


class Telemetry:
    """Per-target streaming telemetry over the records a scope collected.
    Records keyed ``<target>@tiles`` route to per-row-tile accumulators
    (:class:`TargetTileTelemetry`); everything else to the scalar
    :class:`TargetTelemetry`."""

    def __init__(self, bits: int, decay: float = 0.2):
        self.bits = bits
        self.decay = decay
        self.targets: Dict[str, TargetTelemetry] = {}
        self.tile_targets: Dict[str, TargetTileTelemetry] = {}

    def update(self, records: Dict[str, Dict[str, np.ndarray]]) -> None:
        for target, rec in records.items():
            if is_tile_key(target):
                tt = self.tile_targets.get(target)
                if tt is None:
                    tt = self.tile_targets[target] = TargetTileTelemetry(
                        self.bits, self.decay)
                tt.update(rec)
                continue
            tt = self.targets.get(target)
            if tt is None:
                tt = self.targets[target] = TargetTelemetry(self.bits, self.decay)
            tt.update(rec)

    def snapshot(self) -> Dict[str, dict]:
        out = {t: tt.snapshot() for t, tt in self.targets.items()}
        out.update({t: tt.snapshot() for t, tt in self.tile_targets.items()})
        return out

    def describe(self) -> str:
        parts = []
        for t, tt in sorted(self.targets.items()):
            parts.append(f"{t}: ew_mae={tt.ew_mae:.2f} mae={tt.stats.mae:.2f} "
                         f"n={tt.stats.n}")
        for t, tt in sorted(self.tile_targets.items()):
            gm = 0 if tt.bit_probs is None else tt.bit_probs.shape[0]
            parts.append(f"{t}: tiles={gm} steps={tt.n_steps}")
        return "telemetry " + " | ".join(parts) if parts else "telemetry <empty>"


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

_QUARANTINED = obs.default_registry().counter(
    "repro_telemetry_quarantined_total",
    "telemetry records quarantined before the accumulators, by target and "
    "reason (nonfinite / bounds / outlier)")


class TelemetryQuarantine:
    """Record sanitization in front of the accumulators and ring buffers.

    Three independent checks, cheapest first:

    1. **nonfinite** — any NaN/Inf in a float field (corrupt shard math,
       torn transfers);
    2. **bounds** — structural invariants every honest ``operand_summary``
       / ``tile_summary`` record satisfies by construction: per-bit
       occupancy counts cannot exceed the total sample count, error-limb
       sums are bounded by ``n * 0xFFFF``, the nonzero-error count by
       ``n``, and exported operand codes by the multiplier's ``2**bits``
       magnitude range;
    3. **outlier** (``z_threshold`` set) — robust z-score of the record's
       step MAE against the trailing per-target history (median/MAD):
       finite, in-bounds, but absurd records — the "one shard went insane"
       case.  Quarantined records are NOT appended to the history, so a
       poison burst cannot drag the baseline toward itself.

    Records with ``n == 0`` pass untouched: the fused decode's gated-off
    slots legitimately emit all-zero records, and vetoing them would change
    accumulator trajectories for honest traffic.
    """

    REASONS = ("nonfinite", "bounds", "outlier")

    def __init__(self, bits: int, z_threshold: Optional[float] = None,
                 history: int = 64, min_history: int = 8):
        self.bits = int(bits)
        self.z_threshold = z_threshold
        self.history = int(history)
        self.min_history = int(min_history)
        self._mae_hist: Dict[str, collections.deque] = {}
        self.quarantined = 0
        self.by_reason: Dict[str, int] = {}

    # -- checks --------------------------------------------------------
    def check(self, target: str, rec: Dict[str, np.ndarray]) -> Optional[str]:
        """The quarantine reason for this record, or None when admissible."""
        for v in rec.values():
            v = np.asarray(v)
            if np.issubdtype(v.dtype, np.floating) and not bool(
                    np.all(np.isfinite(v))):
                return "nonfinite"
        tile = is_tile_key(target)
        n = float(np.sum(np.asarray(rec["tile_n" if tile else "n"],
                                    np.float64)))
        if n <= 0:
            return None                      # gated-off zero record: vacuous
        lim = float(2 ** self.bits)
        for k in ("bits_a", "bits_b") if not tile else ("tile_bits_a",):
            if k in rec:
                counts = np.asarray(rec[k], np.float64)
                counts = counts.reshape(-1, counts.shape[-1]).sum(axis=0)
                if float(counts.max(initial=0.0)) > n + 0.5:
                    return "bounds"
        for k in ("a_smp", "b_smp", "tile_a_smp", "tile_b_smp"):
            if k in rec and np.abs(
                    np.asarray(rec[k], np.float64)).max(initial=0.0) > lim:
                return "bounds"
        if tile and "tile_err_lo" in rec:
            tn = np.asarray(rec["tile_n"], np.float64)
            tn = tn.reshape(-1, tn.shape[-1]).sum(axis=0)
            for k in ("tile_err_lo", "tile_err_hi"):
                limb = np.asarray(rec[k], np.float64)
                limb = limb.reshape(-1, limb.shape[-1]).sum(axis=0)
                if np.any(limb > tn * 0xFFFF + 0.5):
                    return "bounds"
        if not tile:
            lo = float(np.sum(np.asarray(rec["err_lo"], np.float64)))
            hi = float(np.sum(np.asarray(rec["err_hi"], np.float64)))
            cnt = float(np.sum(np.asarray(rec["err_cnt"], np.float64)))
            if lo > n * 0xFFFF or hi > n * 0xFFFF or cnt > n + 0.5:
                return "bounds"
            if self.z_threshold is not None:
                mae = (lo + hi * 65536.0) / n
                hist = self._mae_hist.setdefault(
                    target, collections.deque(maxlen=self.history))
                if len(hist) >= self.min_history:
                    arr = np.asarray(hist, np.float64)
                    med = float(np.median(arr))
                    mad = float(np.median(np.abs(arr - med)))
                    # the 0.05*med floor keeps a near-zero-MAD history from
                    # flagging ordinary drift as an outlier (scale-relative)
                    z = abs(mae - med) / (1.4826 * mad + 0.05 * med + 1e-9)
                    if z > self.z_threshold:
                        return "outlier"     # and keep it OUT of the history
                hist.append(mae)
        return None

    def filter(self, records: Dict[str, Dict[str, np.ndarray]]
               ) -> Tuple[Dict[str, Dict[str, np.ndarray]],
                          List[Tuple[str, str]]]:
        """(admitted records, [(target, reason) dropped]) — the controller
        feeds only the admitted half to accumulators/buffers/drift."""
        admitted, dropped = {}, []
        for target, rec in records.items():
            reason = self.check(target, rec)
            if reason is None:
                admitted[target] = rec
            else:
                dropped.append((target, reason))
                self.quarantined += 1
                self.by_reason[reason] = self.by_reason.get(reason, 0) + 1
                _QUARANTINED.inc(1, target=target, reason=reason)
        return admitted, dropped

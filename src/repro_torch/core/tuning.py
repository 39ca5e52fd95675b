"""The SWAPPER tuning framework (``repro.core.tuning``): the paper's
exploration phase.

Component level: the swap mask of configuration (A, i, v) depends only on
operand A, so every one of the 4M configurations is scored from per-a row
statistics of the two error surfaces E0(a,b) = |m(a,b) - ab| and
E1(a,b) = |m(b,a) - ab| (and of the oracle min(E0, E1)); B-side
configurations read the transposed surface, whose row stats are the other
surface's.  One O(2^(2M)) pass instead of the paper's 4M * 2^(2M).  On a
CUDA device the pass is the hand-written sweep kernel
(``kernels/tuning_sweep.py``); on the CPU it is the kernel's plain version,
built on :func:`tile_stats`.
Integer sums are exact: limb sums in uint32 lanes, recombined in numpy
int64.

Application level: :func:`tune_application` scores every configuration by
running the application with the swap triple as 0-d int32 tensors on the
device, so nothing is built per configuration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .metrics import ErrorStats, abs_err
from .multipliers import AxMult
from .swapper import SwapConfig, all_configs

__all__ = [
    "tile_stats",
    "ComponentResult",
    "component_sweep",
    "result_from_accs",
    "accs_from_row_stats",
    "operand_values",
    "tune_application",
    "TwoBitConfig",
    "two_bit_sweep",
    "swap_mask_two_bit",
    "apply_swapper_two_bit",
]

MINIMIZE = {"mae": True, "wce": True, "are": True, "mse": True, "ep": True}
STAT_NAMES = ("lo", "hi", "mx", "cnt", "sq", "rel")
SURF_NAMES = ("r0", "r1", "orc")


# ---------------------------------------------------------------------------
# component level
# ---------------------------------------------------------------------------

def operand_values(bits: int, signed: bool, sample_bits: Optional[int] = None,
                   seed: int = 0) -> np.ndarray:
    """The operand population: exhaustive for small widths, a fixed-seed
    random subset of 2^sample_bits distinct values otherwise (the JAX
    package's numpy code: the same values)."""
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed else (0, 1 << bits)
    vals = np.arange(lo, hi, dtype=np.int64)
    if sample_bits is not None and sample_bits < bits:
        rng = np.random.default_rng(seed)
        vals = rng.choice(vals, size=1 << sample_bits, replace=False)
        vals.sort()
    return vals.astype(np.int32)


def _row_stats(e: torch.Tensor, exact_abs_f: torch.Tensor) -> dict:
    """Row statistics of one error surface: exact limb sums, max and
    nonzero count as integers; the float32 terms ``e^2`` and
    ``e / max(|exact|, 1)`` (each rounded as XLA rounds it) summed in
    float64 and rounded to float32 once."""
    ef = e.to(torch.float32)
    rel = ef / torch.clamp(exact_abs_f, min=1.0)
    return dict(
        lo=(e & 0xFFFF).sum(dim=1),
        hi=(e >> 16).sum(dim=1),
        mx=e.amax(dim=1),
        cnt=(e != 0).sum(dim=1, dtype=torch.int32),
        sq=(ef * ef).to(torch.float64).sum(dim=1).to(torch.float32),
        rel=rel.to(torch.float64).sum(dim=1).to(torch.float32),
    )


def tile_stats(mult: AxMult, a_vals: torch.Tensor, b_vals: torch.Tensor) -> dict:
    """Plain counterpart of ``tile_stats_jnp``: row (per-a) stats of the E0,
    E1 and oracle surfaces over the ``a_vals x b_vals`` tile, as
    ``{surf: {stat: tensor}}``; ``lo``/``hi``/``mx`` are uint32 lanes
    (int64 tensors), ``cnt`` int32, ``sq``/``rel`` float32."""
    A = a_vals.to(torch.int64)[:, None]
    B = b_vals.to(torch.int64)[None, :]
    exact = mult.exact_product(A, B)
    e0 = abs_err(mult.fn(A, B), exact, mult.signed)
    e1 = abs_err(mult.fn(B, A), exact, mult.signed)
    exact_f = exact.to(torch.float32)
    exact_abs = exact_f.abs() if mult.signed else exact_f
    return dict(r0=_row_stats(e0, exact_abs), r1=_row_stats(e1, exact_abs),
                orc=_row_stats(torch.minimum(e0, e1), exact_abs))


class _Acc:
    """Host-side exact accumulator for one stats family over tiles."""

    def __init__(self, n_vals):
        self.sum = np.zeros(n_vals, np.int64)
        self.mx = np.zeros(n_vals, np.int64)
        self.cnt = np.zeros(n_vals, np.int64)
        self.sq = np.zeros(n_vals, np.float64)
        self.rel = np.zeros(n_vals, np.float64)

    def add(self, sl, st):
        st = {k: _host(v) for k, v in st.items()}
        self.sum[sl] += np.asarray(st["lo"], np.int64) + (np.asarray(st["hi"], np.int64) << 16)
        self.mx[sl] = np.maximum(self.mx[sl], np.asarray(st["mx"], np.int64))
        self.cnt[sl] += np.asarray(st["cnt"], np.int64)
        self.sq[sl] += np.asarray(st["sq"], np.float64)
        self.rel[sl] += np.asarray(st["rel"], np.float64)

    def stats_where(self, mask, n_each) -> ErrorStats:
        s = ErrorStats()
        s.n = int(mask.sum()) * n_each
        s.sum_abs = int(self.sum[mask].sum())
        s.max_abs = int(self.mx[mask].max()) if mask.any() else 0
        s.count_neq = int(self.cnt[mask].sum())
        s.sum_sq = float(self.sq[mask].sum())
        s.sum_rel = float(self.rel[mask].sum())
        return s


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v


def _merge(s1: ErrorStats, s2: ErrorStats) -> ErrorStats:
    out = ErrorStats()
    out.n = s1.n + s2.n
    out.sum_abs = s1.sum_abs + s2.sum_abs
    out.max_abs = max(s1.max_abs, s2.max_abs)
    out.count_neq = s1.count_neq + s2.count_neq
    out.sum_sq = s1.sum_sq + s2.sum_sq
    out.sum_rel = s1.sum_rel + s2.sum_rel
    return out


@dataclasses.dataclass
class ComponentResult:
    """Full component-level tuning output: NoSwap / every config / oracle."""

    mult_name: str
    bits: int
    noswap: ErrorStats
    oracle: ErrorStats
    per_config: Dict[SwapConfig, ErrorStats]

    def best(self, metric: str = "mae") -> SwapConfig:
        return min(self.per_config, key=lambda c: self.per_config[c].metric(metric))

    def reduction(self, metric: str = "mae", cfg: Optional[SwapConfig] = None) -> float:
        """Relative reduction vs NoSwap (the paper's 'SWAPPER' rows)."""
        cfg = cfg or self.best(metric)
        base = self.noswap.metric(metric)
        if base == 0:
            return 0.0
        return (base - self.per_config[cfg].metric(metric)) / base

    def theoretical_reduction(self, metric: str = "mae") -> float:
        """Oracle bound (the paper's 'Theoretical' rows)."""
        base = self.noswap.metric(metric)
        if base == 0:
            return 0.0
        return (base - self.oracle.metric(metric)) / base


def component_sweep(mult: AxMult, tile: Optional[int] = None,
                    sample_bits: Optional[int] = None, seed: int = 0,
                    device="cuda") -> ComponentResult:
    """Exhaustive (or fixed-seed sampled) component-level SWAPPER tuning:
    one ``tuning_sweep`` over the whole grid, the kernel on a CUDA device
    and its plain version on the CPU.  ``tile`` is accepted for the JAX
    driver's signature and not used: no pass here is tiled."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"component_sweep runs on cuda or cpu, not {device}")
    from repro_torch.kernels.ops import component_sweep_kernel  # kernels imports core

    return component_sweep_kernel(mult, sample_bits=sample_bits, seed=seed, device=device)


def result_from_accs(mult: AxMult, vals: np.ndarray, r0: _Acc, r1: _Acc,
                     orc: _Acc) -> ComponentResult:
    """Score NoSwap, all 4M configurations, and the oracle from accumulated
    row statistics."""
    n = len(vals)
    all_true = np.ones(n, bool)
    noswap = r0.stats_where(all_true, n)
    oracle = orc.stats_where(all_true, n)

    per_config: Dict[SwapConfig, ErrorStats] = {}
    bitvals = vals.astype(np.int64) & ((1 << mult.bits) - 1)
    for cfg in all_configs(mult.bits):
        sel = ((bitvals >> cfg.bit) & 1) == cfg.value
        if cfg.operand == "A":
            # rows with the bit match use the swapped surface E1
            stats = _merge(r1.stats_where(sel, n), r0.stats_where(~sel, n))
        else:
            # transpose identity: col sums of E1/E0 == row sums of E0/E1
            stats = _merge(r0.stats_where(sel, n), r1.stats_where(~sel, n))
        per_config[cfg] = stats
    return ComponentResult(mult.name, mult.bits, noswap, oracle, per_config)


def accs_from_row_stats(vals: np.ndarray, stats: dict):
    """(_Acc r0, r1, orc) from full-length row-stat vectors as returned by
    ``kernels.tuning_sweep.tuning_sweep``."""
    n = len(vals)
    accs = []
    for surf in SURF_NAMES:
        acc = _Acc(n)
        acc.add(slice(None), stats[surf])
        accs.append(acc)
    return tuple(accs)


# ---------------------------------------------------------------------------
# two-bit decisions (beyond the paper: its stated future work)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TwoBitConfig:
    """Swap decided by a boolean function of two operand bits:
    swap <=> table[(bit_p << 1) | bit_q] for p = (op_p, bit_p),
    q = (op_q, bit_q); ``table`` is a 4-bit truth table."""

    op_p: str
    bit_p: int
    op_q: str
    bit_q: int
    table: int

    def short(self):
        return (f"f({self.op_p}[{self.bit_p}],{self.op_q}[{self.bit_q}])"
                f"=t{self.table:04b}")


def swap_mask_two_bit(a, b, cfg: TwoBitConfig):
    pa = a if cfg.op_p == "A" else b
    qa = a if cfg.op_q == "A" else b
    vp = (pa.to(torch.int64) >> cfg.bit_p) & 1
    vq = (qa.to(torch.int64) >> cfg.bit_q) & 1
    idx = (vp << 1) | vq
    tbl = torch.tensor([(cfg.table >> i) & 1 for i in range(4)], device=idx.device)
    return tbl[idx] == 1


def apply_swapper_two_bit(mult: AxMult, a, b, cfg: TwoBitConfig):
    m = swap_mask_two_bit(a, b, cfg)
    return mult.fn(torch.where(m, b, a), torch.where(m, a, b))


def two_bit_sweep(mult: AxMult, metric: str = "mae", sample_bits: Optional[int] = None,
                  seed: int = 0, device="cuda"):
    """Exhaustive two-bit tuning for the sum metrics (mae/mse/ep/are): the
    block sums M_s = U^T E_s U over bit-value quadrants (float32 matrix
    products) score every bit pair and truth table in closed form.
    Returns (best TwoBitConfig, best value, stats)."""
    if metric not in ("mae", "mse", "ep", "are"):
        raise ValueError(f"two_bit_sweep scores sum metrics, not {metric}")
    vals = operand_values(mult.bits, mult.signed, sample_bits, seed)
    n = len(vals)
    M = mult.bits
    dvals = torch.from_numpy(vals).to(device)

    A = dvals.to(torch.int64)[:, None]
    B = dvals.to(torch.int64)[None, :]
    exact = mult.exact_product(A, B)
    e0 = abs_err(mult.fn(A, B), exact, mult.signed).to(torch.float32)
    e1 = abs_err(mult.fn(B, A), exact, mult.signed).to(torch.float32)
    if metric == "mse":
        e0, e1 = e0 * e0, e1 * e1
    elif metric == "ep":
        e0, e1 = (e0 != 0).to(torch.float32), (e1 != 0).to(torch.float32)
    elif metric == "are":
        den = torch.clamp(exact.to(torch.float32).abs(), min=1.0)
        e0, e1 = e0 / den, e1 / den

    # indicator matrix over values: U[v, 2*i + bitval]
    bits = ((vals.astype(np.int64)[:, None] & ((1 << M) - 1)) >> np.arange(M)) & 1
    U = np.zeros((n, 2 * M), np.float32)
    U[np.arange(n)[:, None], 2 * np.arange(M) + bits] = 1.0
    Ut = torch.from_numpy(U).to(device)

    M0 = (Ut.T @ e0 @ Ut).cpu().numpy().astype(np.float64)
    M1 = (Ut.T @ e1 @ Ut).cpu().numpy().astype(np.float64)
    total0 = float(e0.sum(dtype=torch.float32))

    best = None
    best_val = np.inf
    for pi in range(M):
        for qi in range(M):
            for table in range(1, 15):  # skip never/always-swap
                s = 0.0
                for vp in (0, 1):
                    for vq in (0, 1):
                        use1 = (table >> ((vp << 1) | vq)) & 1
                        Msel = M1 if use1 else M0
                        s += Msel[2 * pi + vp, 2 * qi + vq]
                if s < best_val:
                    best_val = s
                    best = TwoBitConfig("A", pi, "B", qi, table)
    stats = {
        "noswap": total0 / (n * n),
        "two_bit": best_val / (n * n),
        "reduction": (total0 - best_val) / total0 if total0 else 0.0,
    }
    return best, best_val / (n * n), stats


# ---------------------------------------------------------------------------
# application level
# ---------------------------------------------------------------------------

def tune_application(run_app: Callable, bits: int, minimize: bool = True,
                     configs: Optional[Sequence[Optional[SwapConfig]]] = None,
                     include_noswap: bool = True, device="cuda"):
    """Application-level tuning (paper §II / §III.B).

    ``run_app(op_is_a, bit, value)`` -> scalar application metric, with the
    swap configuration passed as 0-d int32 tensors on ``device`` (value 2 is
    the NoSwap reference), so one code path scores the whole sweep.  NoSwap
    itself is a candidate.  Returns (best_cfg_or_None, best_metric, table).
    """
    if configs is None:
        configs = all_configs(bits)
        if include_noswap:
            configs = [None] + configs
    else:
        configs = list(configs)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    table: Dict[Optional[SwapConfig], float] = {}
    for cfg in configs:
        if cfg is None:
            v = run_app(i32(1), i32(0), i32(2))
        else:
            v = run_app(i32(1 if cfg.operand == "A" else 0), i32(cfg.bit), i32(cfg.value))
        table[cfg] = float(v)
    key = min if minimize else max
    best = key(configs, key=lambda c: table[c])
    return best, table[best], table

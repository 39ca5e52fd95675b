"""Error metrics of the paper, Eqs. 1-5 (``repro.core.metrics``): the exact
absolute error of an approximate product, the array metrics ``mae``,
``wce``, ``are``, ``mse`` and ``ep`` (float64, as the JAX package's numpy
forms), and :class:`ErrorStats`, the exact streaming accumulator that the
component tuner and the adaptive runtime's telemetry fold limb sums into."""
from __future__ import annotations

import dataclasses

import torch

from .lanes import M32, s32, u32

__all__ = ["abs_err", "mae", "wce", "are", "mse", "ep", "METRICS", "ErrorStats"]


def abs_err(approx: torch.Tensor, precise: torch.Tensor, signed: bool) -> torch.Tensor:
    """Exact |approx - precise| as uint32 lanes (int64 tensor in [0, 2^32))."""
    au = u32(approx)
    pu = u32(precise)
    big = (s32(approx) >= s32(precise)) if signed else (au >= pu)
    return torch.where(big, (au - pu) & M32, (pu - au) & M32)


def _err_f64(approx, precise, signed):
    return abs_err(approx, precise, signed).to(torch.float64)


def mae(approx, precise, signed: bool) -> float:
    return float(_err_f64(approx, precise, signed).mean())


def wce(approx, precise, signed: bool) -> float:
    return float(_err_f64(approx, precise, signed).max())


def are(approx, precise, signed: bool) -> float:
    """Average relative error; a zero reference counts with denominator 1
    (the AxBench qos convention)."""
    e = _err_f64(approx, precise, signed)
    p = torch.as_tensor(precise).to(torch.float64).abs()
    return float((e / p.clamp(min=1.0)).mean())


def mse(approx, precise, signed: bool) -> float:
    e = _err_f64(approx, precise, signed)
    return float((e * e).mean())


def ep(approx, precise, signed: bool) -> float:
    return float((_err_f64(approx, precise, signed) != 0).to(torch.float64).mean())


METRICS = {"mae": mae, "wce": wce, "are": are, "mse": mse, "ep": ep}


@dataclasses.dataclass
class ErrorStats:
    """Exact streaming accumulator for one error population.

    Partial sums arrive as 16-bit limb sums (exact in uint32 per summary)
    and are recombined here in Python integers and floats."""

    n: int = 0
    sum_abs: int = 0            # exact
    max_abs: int = 0
    count_neq: int = 0
    sum_sq: float = 0.0
    sum_rel: float = 0.0

    def add_limbs(self, n, lo_sum, hi_sum, max_abs, count_neq, sum_sq, sum_rel):
        self.n += int(n)
        self.sum_abs += int(lo_sum) + (int(hi_sum) << 16)
        self.max_abs = max(self.max_abs, int(max_abs))
        self.count_neq += int(count_neq)
        self.sum_sq += float(sum_sq)
        self.sum_rel += float(sum_rel)

    # -- metric views -------------------------------------------------
    @property
    def mae(self) -> float:
        return self.sum_abs / max(self.n, 1)

    @property
    def wce(self) -> float:
        return float(self.max_abs)

    @property
    def mse(self) -> float:
        return self.sum_sq / max(self.n, 1)

    @property
    def ep(self) -> float:
        return self.count_neq / max(self.n, 1)

    @property
    def are(self) -> float:
        return self.sum_rel / max(self.n, 1)

    def metric(self, name: str) -> float:
        return getattr(self, name)

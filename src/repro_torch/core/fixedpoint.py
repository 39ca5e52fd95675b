"""Q16.16 fixed-point math with an injectable (approximable) multiply
(``repro.core.fixedpoint``): the libfixmath analog of the paper's AxBench
protocol.  Every derived operation (div, sqrt, exp, log, sin, cos, atan,
atan2, acos) is built on one Q16.16 ``mul``, so installing an approximate
multiply approximates the whole library.

Values are int32 tensors, which wrap like JAX's int32.  float32 serves only
for initial guesses and range reduction, with IEEE operations that give the
same bits on the CPU and the card: a division by a constant divides by a
tensor, since PyTorch's CUDA kernels multiply by the reciprocal of a Python
scalar divisor.  ``lax.clz`` becomes the exact :func:`~.lanes.msb`.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .lanes import msb
from .modular import AxMul32Config, ax_fxp_mul, ax_fxp_mul_dyn

__all__ = ["FX_ONE", "FxpMath", "to_fxp", "from_fxp", "make_mul"]

FX_ONE = 1 << 16
_LN2 = int(round(np.log(2) * FX_ONE))
_PI = int(round(np.pi * FX_ONE))
_HALF_PI = int(round(np.pi / 2 * FX_ONE))
_QUARTER_PI = int(round(np.pi / 4 * FX_ONE))
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def to_fxp(x) -> torch.Tensor:
    """float -> Q16.16 int32 (round half to even), saturating to the int32
    range."""
    v = torch.round(torch.as_tensor(x).to(torch.float32) * FX_ONE)
    return torch.clamp(v.to(torch.int64), _I32_MIN, _I32_MAX).to(torch.int32)


def from_fxp(x) -> torch.Tensor:
    return x.to(torch.float32) / FX_ONE


def _div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """float32 ``x / c`` as an IEEE division on every device."""
    return x / torch.full_like(x, c)


def _shift(x, e):
    """``x >> e`` where e >= 0, else ``x << -e`` (int32, |e| < 32)."""
    return torch.where(e >= 0, x >> torch.clamp(e, min=0), x << torch.clamp(-e, min=0))


def _msb32(x) -> torch.Tensor:
    """``31 - clz(x)`` of positive int32 values, as int32."""
    return msb(x.to(torch.int64)).to(torch.int32)


def make_mul(cfg: Optional[AxMul32Config] = None, dyn=None) -> Callable:
    """A Q16.16 multiply closure: precise (cfg=None), statically configured
    approximate, or approximate with the run-time swap triple ``dyn``."""
    if cfg is None:
        return lambda a, b: ax_fxp_mul(a, b, None)
    if dyn is None:
        return lambda a, b: ax_fxp_mul(a, b, cfg)
    return lambda a, b: ax_fxp_mul_dyn(a, b, cfg, *dyn)


class FxpMath:
    """Q16.16 math built exclusively on ``self.mul`` (plus exact add/shift)."""

    def __init__(self, mul: Callable):
        self.mul = mul

    @staticmethod
    def const(x: float) -> int:
        return int(round(x * FX_ONE))

    def _poly(self, x, coeffs):
        """Horner evaluation; coeffs are floats, highest degree first."""
        acc = torch.full_like(x, self.const(coeffs[0]))
        for c in coeffs[1:]:
            acc = self.mul(acc, x) + self.const(c)
        return acc

    def div(self, a, b):
        """q = a/b: the divisor normalized to m in [1, 2) by exact shifts, a
        float32 reciprocal seed, two Newton steps through ``self.mul``."""
        neg = (a < 0) ^ (b < 0)
        aa = torch.abs(a)
        bb = torch.clamp(torch.abs(b), min=1)
        e = _msb32(bb) - 16
        m = _shift(bb, e)
        r = to_fxp(1.0 / torch.clamp(from_fxp(m), min=0.5))  # seed, m in [1,2)
        two = 2 * FX_ONE
        for _ in range(2):                                   # r <- r*(2 - m*r)
            r = self.mul(r, two - self.mul(m, r))
        q = _shift(self.mul(aa, r), e)
        q = torch.where(neg, -q, q)
        return torch.where(b == 0, torch.zeros_like(q), q)

    def sqrt(self, x):
        """x = m * 4^(e/2) with m in [1, 4) by exact shifts; sqrt(m) by
        reciprocal-square-root Newton steps in Q16.16."""
        xs = torch.clamp(x, min=1)
        e = (_msb32(xs) - 16) & ~1
        m = _shift(xs, e)
        r = to_fxp(1.0 / torch.sqrt(torch.clamp(from_fxp(m), min=0.25)))  # seed
        half = self.const(0.5)
        three = 3 * FX_ONE
        for _ in range(2):                           # r <- r*(3 - m r^2)/2
            r = self.mul(r, self.mul(torch.full_like(r, half),
                                     three - self.mul(m, self.mul(r, r))))
        s = self.mul(m, r)                           # sqrt(m) in [1, 2)
        s = _shift(s, -(e >> 1))
        return torch.where(x <= 0, torch.zeros_like(s), s)

    def exp(self, x):
        """x = k ln2 + t, e^x = 2^k e^t, e^t by a 6-term Taylor series."""
        k = torch.round(_div_const(from_fxp(x), float(np.log(2)))).to(torch.int32)
        k = torch.clamp(k, -17, 13)
        t = x - k * _LN2
        e = self._poly(t, [1 / 720, 1 / 120, 1 / 24, 1 / 6, 1 / 2, 1.0, 1.0])
        return _shift(e, -k)

    def log(self, x):
        """x = 2^k m, ln x = k ln2 + 2 atanh((m-1)/(m+1))."""
        xs = torch.clamp(x, min=1)
        k = _msb32(xs) - 16
        m = _shift(xs, k)
        t = self.div(m - FX_ONE, m + FX_ONE)
        t2 = self.mul(t, t)
        s = self._poly(t2, [2 / 7, 2 / 5, 2 / 3, 2.0])
        out = k * _LN2 + self.mul(t, s)
        return torch.where(x <= 0, torch.full_like(out, _I32_MIN), out)

    def _sin_core(self, r):
        r2 = self.mul(r, r)
        s = self._poly(r2, [-1 / 5040, 1 / 120, -1 / 6, 1.0])
        return self.mul(r, s)

    def _cos_core(self, r):
        r2 = self.mul(r, r)
        return self._poly(r2, [-1 / 720, 1 / 24, -1 / 2, 1.0])

    def _fold(self, x):
        k = torch.round(_div_const(from_fxp(x), float(np.pi / 2))).to(torch.int32)
        return k & 3, x - k * _HALF_PI

    def sin(self, x):
        q, r = self._fold(x)
        s, c = self._sin_core(r), self._cos_core(r)
        return torch.where(q == 0, s, torch.where(q == 1, c, torch.where(q == 2, -s, -c)))

    def cos(self, x):
        q, r = self._fold(x)
        s, c = self._sin_core(r), self._cos_core(r)
        return torch.where(q == 0, c, torch.where(q == 1, -s, torch.where(q == 2, -c, s)))

    def _atan_small(self, z):
        """atan on |z| <= 0.5 via a 7-term odd series."""
        z2 = self.mul(z, z)
        s = self._poly(z2, [-1 / 15, 1 / 13, -1 / 11, 1 / 9, -1 / 7, 1 / 5, -1 / 3, 1.0])
        return self.mul(z, s)

    def atan(self, z):
        neg = z < 0
        za = torch.where(neg, -z, z)
        inv = za > FX_ONE
        zb = torch.where(inv, self.div(torch.full_like(za, FX_ONE), torch.clamp(za, min=1)), za)
        mid = zb > (FX_ONE // 2)
        zc = torch.where(mid, self.div(zb - FX_ONE, zb + FX_ONE), zb)
        a = self._atan_small(zc)
        a = torch.where(mid, _QUARTER_PI + a, a)
        a = torch.where(inv, _HALF_PI - a, a)
        return torch.where(neg, -a, a)

    def atan2(self, y, x):
        base = self.atan(self.div(y, torch.where(x == 0, torch.ones_like(x), x)))
        zero = torch.where(y > 0, torch.full_like(y, _HALF_PI),
                           torch.where(y < 0, torch.full_like(y, -_HALF_PI), torch.zeros_like(y)))
        neg_x = torch.where(y >= 0, base + _PI, base - _PI)
        return torch.where(x > 0, base, torch.where(x < 0, neg_x, zero))

    def acos(self, x):
        xc = torch.clamp(x, -FX_ONE, FX_ONE)
        one_minus = FX_ONE - self.mul(xc, xc)
        return self.atan2(self.sqrt(one_minus), xc)

"""AxBench `blackscholes`: European option pricing, Q16.16, ARE metric."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fixedpoint import FxpMath, from_fxp, to_fxp

from .common import AxApp

# Abramowitz & Stegun 26.2.17 CND polynomial constants
_A = (0.319381530, -0.356563782, 1.781477937, -1.821255978, 1.330274429)
_GAMMA = 0.2316419
_INV_SQRT_2PI = 0.3989422804014327
_ONE = 1 << 16


def gen_inputs(n, seed):
    rng = np.random.default_rng(seed)
    n = max(64, int(n))
    return {
        "S": rng.uniform(10.0, 60.0, n),       # spot
        "K": rng.uniform(10.0, 60.0, n),       # strike
        "T": rng.uniform(0.2, 2.0, n),         # expiry (years)
        "r": rng.uniform(0.01, 0.08, n),       # rate
        "v": rng.uniform(0.15, 0.6, n),        # volatility
    }


def _cnd_fxp(F, x):
    """Cumulative normal via the A&S polynomial, all arithmetic through F."""
    neg = x < 0
    xa = torch.where(neg, -x, x)
    c = lambda v: torch.full_like(x, F.const(v))                 # noqa: E731
    k = F.div(torch.full_like(x, _ONE), _ONE + F.mul(c(_GAMMA), xa))
    poly = torch.zeros_like(x)
    for a in reversed(_A):
        poly = F.mul(poly + F.const(a), k)
    # pdf = inv_sqrt_2pi * exp(-x^2/2)
    pdf = F.mul(c(_INV_SQRT_2PI), F.exp(-(F.mul(xa, xa) >> 1)))
    cnd = _ONE - F.mul(pdf, poly)
    return torch.where(neg, _ONE - cnd, cnd)


def run_fxp(inputs, mul):
    F = FxpMath(mul)
    S = to_fxp(inputs["S"])
    Kk = to_fxp(inputs["K"])
    T = to_fxp(inputs["T"])
    r = to_fxp(inputs["r"])
    v = to_fxp(inputs["v"])

    sqrtT = F.sqrt(T)
    vsqrtT = F.mul(v, sqrtT)
    d1 = F.div(F.log(F.div(S, Kk)) + F.mul(r + (F.mul(v, v) >> 1), T), vsqrtT)
    d2 = d1 - vsqrtT
    disc = F.exp(-F.mul(r, T))
    call = F.mul(S, _cnd_fxp(F, d1)) - F.mul(Kk, F.mul(disc, _cnd_fxp(F, d2)))
    return from_fxp(call)


def _cnd_np(x):
    neg = x < 0
    xa = np.abs(x)
    k = 1.0 / (1.0 + _GAMMA * xa)
    poly = np.zeros_like(x)
    for a in reversed(_A):
        poly = (poly + a) * k
    pdf = _INV_SQRT_2PI * np.exp(-0.5 * xa * xa)
    cnd = 1.0 - pdf * poly
    return np.where(neg, 1.0 - cnd, cnd)


def reference(inputs):
    """float64 oracle."""
    S, K, T = inputs["S"], inputs["K"], inputs["T"]
    r, v = inputs["r"], inputs["v"]
    d1 = (np.log(S / K) + (r + 0.5 * v * v) * T) / (v * np.sqrt(T))
    d2 = d1 - v * np.sqrt(T)
    call = S * _cnd_np(d1) - K * np.exp(-r * T) * _cnd_np(d2)
    return call.astype(np.float32)


def metric(out, ref):
    err = torch.abs(out - ref)
    den = torch.clamp(torch.abs(ref), min=1.0)  # AxBench qos zero-guard
    return torch.mean(err / den)


APP = AxApp(name="blackscholes", metric_name="are", minimize=True, kind="fxp32",
            gen_inputs=gen_inputs, reference=reference, run_fxp=run_fxp, metric=metric)

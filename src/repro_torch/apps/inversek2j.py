"""AxBench `inversek2j`: 2-joint arm inverse kinematics, Q16.16, ARE metric."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fixedpoint import FxpMath, from_fxp, to_fxp

from .common import AxApp

L1 = 0.5
L2 = 0.5


def gen_inputs(n, seed):
    rng = np.random.default_rng(seed)
    n = max(64, int(n))
    # reachable targets: radius in (0.15, 0.95), angle in (-pi, pi)
    rad = rng.uniform(0.15, 0.95, n)
    ang = rng.uniform(-np.pi, np.pi, n)
    return {"x": rad * np.cos(ang), "y": rad * np.sin(ang)}


def run_fxp(inputs, mul):
    F = FxpMath(mul)
    x = to_fxp(inputs["x"])
    y = to_fxp(inputs["y"])
    l1 = torch.full_like(x, F.const(L1))
    l2 = torch.full_like(x, F.const(L2))
    one = int(to_fxp(1.0))

    r2 = F.mul(x, x) + F.mul(y, y)
    num = r2 - F.mul(l1, l1) - F.mul(l2, l2)
    den = F.mul(torch.full_like(x, int(to_fxp(2.0))), F.mul(l1, l2))
    c2 = torch.clamp(F.div(num, den), -one, one)
    th2 = F.acos(c2)
    s2 = F.sin(th2)
    th1 = F.atan2(y, x) - F.atan2(F.mul(l2, s2), l1 + F.mul(l2, c2))
    return torch.stack([from_fxp(th1), from_fxp(th2)])


def reference(inputs):
    x, y = np.asarray(inputs["x"]), np.asarray(inputs["y"])
    r2 = x * x + y * y
    c2 = np.clip((r2 - L1 * L1 - L2 * L2) / (2 * L1 * L2), -1.0, 1.0)
    th2 = np.arccos(c2)
    th1 = np.arctan2(y, x) - np.arctan2(L2 * np.sin(th2), L1 + L2 * c2)
    return np.stack([th1, th2]).astype(np.float32)


def metric(out, ref):
    err = torch.abs(out - ref)
    den = torch.clamp(torch.abs(ref), min=0.1)  # qos zero-guard on angles
    return torch.mean(err / den)


APP = AxApp(name="inversek2j", metric_name="are", minimize=True, kind="fxp32",
            gen_inputs=gen_inputs, reference=reference, run_fxp=run_fxp, metric=metric)

"""AxBench `jmeint`: 3-D triangle-triangle intersection (separating-axis
test), Q16.16 dot and cross products, miss-rate metric."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fixedpoint import FxpMath, to_fxp

from .common import AxApp


def gen_inputs(n, seed):
    rng = np.random.default_rng(seed)
    n = max(64, int(n))
    # pairs with nearby centers => a healthy mix of hits and misses
    c1 = rng.uniform(-0.5, 0.5, (n, 1, 3))
    c2 = c1 + rng.normal(0, 0.18, (n, 1, 3))
    t1 = c1 + rng.uniform(-0.55, 0.55, (n, 3, 3))
    t2 = c2 + rng.uniform(-0.55, 0.55, (n, 3, 3))
    return {"t1": t1, "t2": t2}


def _sat_intersect(tri1, tri2, dot, cross, zero):
    """Branchless separating-axis test.  tri (N, 3, 3).  Returns bool (N,)."""
    e1 = torch.stack([tri1[:, 1] - tri1[:, 0], tri1[:, 2] - tri1[:, 1],
                      tri1[:, 0] - tri1[:, 2]], dim=1)          # (N, 3, 3)
    e2 = torch.stack([tri2[:, 1] - tri2[:, 0], tri2[:, 2] - tri2[:, 1],
                      tri2[:, 0] - tri2[:, 2]], dim=1)
    n1 = cross(e1[:, 0], e1[:, 1])[:, None, :]                  # (N, 1, 3)
    n2 = cross(e2[:, 0], e2[:, 1])[:, None, :]
    # 9 edge-pair axes
    ee = cross(torch.repeat_interleave(e1, 3, dim=1).reshape(-1, 3),
               e2.repeat(1, 3, 1).reshape(-1, 3)).reshape(tri1.shape[0], 9, 3)
    axes = torch.cat([n1, n2, ee], dim=1)                       # (N, 11, 3)

    def project(tri):
        # (N, 11, 3 verts)
        return dot(axes[:, :, None, :], tri[:, None, :, :])

    p1 = project(tri1)
    p2 = project(tri2)
    min1, max1 = p1.amin(-1), p1.amax(-1)
    min2, max2 = p2.amin(-1), p2.amax(-1)
    sep = (max1 < min2) | (max2 < min1)                         # (N, 11)
    degenerate = torch.all(torch.abs(axes) <= zero, dim=-1)     # ignore null axes
    return ~torch.any(sep & ~degenerate, dim=1)


def run_fxp(inputs, mul):
    F = FxpMath(mul)
    t1 = to_fxp(inputs["t1"])
    t2 = to_fxp(inputs["t2"])

    def dot(a, b):
        return F.mul(a, b).sum(dim=-1, dtype=torch.int32)       # int32 wrap, as JAX

    def cross(a, b):
        ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
        bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
        return torch.stack([F.mul(ay, bz) - F.mul(az, by),
                            F.mul(az, bx) - F.mul(ax, bz),
                            F.mul(ax, by) - F.mul(ay, bx)], dim=-1)

    return _sat_intersect(t1, t2, dot, cross, zero=2)


def reference(inputs):
    """The float32 test (the JAX package's runs in jnp float32)."""
    t1 = torch.as_tensor(inputs["t1"]).to(torch.float32)
    t2 = torch.as_tensor(inputs["t2"]).to(torch.float32)

    def dot(a, b):
        return (a * b).sum(dim=-1)

    def cross(a, b):
        return torch.linalg.cross(a, b, dim=-1)

    return _sat_intersect(t1, t2, dot, cross, zero=1e-12).numpy()


def metric(out, ref):
    return torch.mean((out != ref).to(torch.float32))  # miss rate


APP = AxApp(name="jmeint", metric_name="miss_rate", minimize=True, kind="fxp32",
            gen_inputs=gen_inputs, reference=reference, run_fxp=run_fxp, metric=metric)

"""AxBench `kmeans`: RGB image segmentation (k=6, fixed Lloyd iterations),
Q16.16 distance arithmetic, SSIM metric on the clustered image."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fixedpoint import FxpMath, from_fxp, to_fxp

from .common import AxApp
from .ssim import ssim

K = 6
ITERS = 4


def gen_inputs(n, seed):
    """Segmentation-friendly image: Voronoi regions of distinct base colors
    plus mild noise, and deterministic spread-out initial centroids."""
    side = max(32, int(n))
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0.1, 0.9, (8, 3))
    sites = rng.uniform(0, side, (8, 2))
    y, x = np.mgrid[0:side, 0:side]
    d = (x[..., None] - sites[:, 0]) ** 2 + (y[..., None] - sites[:, 1]) ** 2
    img = colors[d.argmin(-1)]
    img += rng.normal(0, 0.015, img.shape)  # sensor-ish noise
    img = np.clip(img, 0.0, 1.0)
    init = np.linspace(0.08, 0.92, K)[:, None] * np.ones((K, 3))
    return {"img": img, "init": init}


def _assign_fxp(F, px, cents):
    """px (P, 3) fxp; cents (K, 3) fxp -> (P,) argmin distance^2."""
    d = px[:, None, :] - cents[None, :, :]                      # (P, K, 3)
    d2 = F.mul(d, d).sum(dim=-1, dtype=torch.int32)             # int32 wrap, as JAX
    return torch.argmin(d2, dim=1)


def run_fxp(inputs, mul):
    F = FxpMath(mul)
    img = inputs["img"].to(torch.float32)
    h, w, _ = img.shape
    px = to_fxp(img.reshape(-1, 3))
    cents = to_fxp(inputs["init"])
    ks = torch.arange(K, device=px.device)
    for _ in range(ITERS):                                      # lax.scan in JAX
        idx = _assign_fxp(F, px, cents)
        onehot = (idx[:, None] == ks[None, :]).to(torch.int32)
        counts = onehot.sum(dim=0, dtype=torch.int32)           # (K,)
        sums = (px[:, None, :] * onehot[:, :, None]).sum(dim=0, dtype=torch.int32)
        new = F.div(sums, torch.clamp(counts, min=1)[:, None].expand(K, 3) << 16)
        cents = torch.where((counts > 0)[:, None], new, cents)
    idx = _assign_fxp(F, px, cents)
    out = cents[idx].reshape(h, w, 3)
    return from_fxp(out) * 255.0


def reference(inputs):
    img = np.asarray(inputs["img"], np.float64)
    h, w, _ = img.shape
    px = img.reshape(-1, 3)
    cents = np.asarray(inputs["init"], np.float64)
    for _ in range(ITERS):
        d2 = ((px[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
        idx = d2.argmin(1)
        for k in range(K):
            sel = idx == k
            if sel.any():
                cents[k] = px[sel].mean(0)
    d2 = ((px[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
    idx = d2.argmin(1)
    return (cents[idx].reshape(h, w, 3) * 255.0).astype(np.float32)


def metric(out, ref):
    return ssim(out, ref)


APP = AxApp(name="kmeans", metric_name="ssim", minimize=False, kind="fxp32",
            gen_inputs=gen_inputs, reference=reference, run_fxp=run_fxp, metric=metric)

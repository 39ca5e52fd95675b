"""AxBench `sobel`: 3x3 Sobel edge detection, Q16.16, SSIM metric."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fixedpoint import FxpMath, from_fxp, to_fxp

from .common import AxApp, smooth_image
from .ssim import ssim

_GX = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64)
_GY = _GX.T


def gen_inputs(n, seed):
    """n is interpreted as image side length (min 32)."""
    side = max(32, int(n))
    return {"img": smooth_image(side, side, seed) / 255.0}  # [0,1]


def _conv3(img, kernel, mul_const):
    h, w = img.shape
    out = torch.zeros((h - 2, w - 2), dtype=img.dtype, device=img.device)
    for di in range(3):
        for dj in range(3):
            c = float(kernel[di, dj])
            if c == 0.0:
                continue
            out = out + mul_const(img[di : h - 2 + di, dj : w - 2 + dj], c)
    return out


def run_fxp(inputs, mul):
    F = FxpMath(mul)
    img = to_fxp(inputs["img"])

    def mul_const(x, c):
        return F.mul(x, torch.full_like(x, F.const(c)))

    gx = _conv3(img, _GX, mul_const)
    gy = _conv3(img, _GY, mul_const)
    mag = F.sqrt(F.mul(gx, gx) + F.mul(gy, gy))
    mag = torch.clamp(mag, 0, int(to_fxp(1.0)))
    return from_fxp(mag) * 255.0


def reference(inputs):
    img = np.asarray(inputs["img"], np.float64)
    h, w = img.shape
    gx = np.zeros((h - 2, w - 2))
    gy = np.zeros((h - 2, w - 2))
    for di in range(3):
        for dj in range(3):
            sl = img[di : h - 2 + di, dj : w - 2 + dj]
            gx += _GX[di, dj] * sl
            gy += _GY[di, dj] * sl
    mag = np.minimum(np.sqrt(gx * gx + gy * gy), 1.0)
    return (mag * 255.0).astype(np.float32)


def metric(out, ref):
    return ssim(out, ref)


APP = AxApp(name="sobel", metric_name="ssim", minimize=False, kind="fxp32",
            gen_inputs=gen_inputs, reference=reference, run_fxp=run_fxp, metric=metric)

"""Common harness for the AxBench-style applications (``repro.apps.common``).

Each application provides:
  gen_inputs(n, seed)   deterministic synthetic inputs as numpy arrays
                        (train/test split = different seeds)
  reference(inputs)     the float 'Original' pipeline (numpy)
  run_fxp(inputs, mul)  the Q16.16 pipeline on tensors, every multiply via
                        ``mul`` (jpeg: a direct 16-bit integer pipeline)
  metric(out, ref)      ARE / miss rate / SSIM as a 0-d tensor

:func:`evaluate` runs one configuration: ``'fp'`` (Table II 'Original'),
``'fxp'`` (precise fixed point), ``None`` (NoSwap), a ``SwapConfig`` or
``'oracle'`` (Table III).  :func:`tune_app` scores all 4M configurations
with the swap triple as 0-d int32 device tensors (nothing is built per
configuration).  Both run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.fixedpoint import make_mul
from repro_torch.core.lanes import s32
from repro_torch.core.modular import PART_MD_LO, AxMul32Config
from repro_torch.core.multipliers import AxMult
from repro_torch.core.swapper import SwapConfig, apply_swapper, apply_swapper_dyn, oracle_mult
from repro_torch.core.tuning import tune_application

__all__ = ["AxApp", "evaluate", "tune_app", "smooth_image", "Mode", "to_device"]

Mode = Union[str, None, SwapConfig]  # 'fp' | 'fxp' | None (NoSwap) | cfg | 'oracle'


@dataclasses.dataclass
class AxApp:
    name: str
    metric_name: str            # 'are' | 'miss_rate' | 'ssim'
    minimize: bool
    kind: str                   # 'fxp32' (Eq. 6 modular) | 'int16' (direct mul16s)
    gen_inputs: Callable        # (n, seed) -> dict of numpy arrays
    reference: Callable         # inputs -> np.ndarray (float pipeline)
    run_fxp: Callable           # (tensor inputs, mul) -> output tensor
    metric: Callable            # (out, ref) -> 0-d tensor


def _mul16_closure(mult: Optional[AxMult], swap, dyn):
    """Direct 16-bit multiply injection for 'int16' apps (jpeg)."""
    if mult is None:
        return lambda a, b: a.to(torch.int32) * b.to(torch.int32)
    if dyn is not None:
        return lambda a, b: s32(apply_swapper_dyn(mult, a, b, *dyn)).to(torch.int32)
    return lambda a, b: s32(apply_swapper(mult, a, b, swap)).to(torch.int32)


def _build_mul(app: AxApp, mult: Optional[AxMult], parts, swap, dyn):
    if app.kind == "int16":
        return _mul16_closure(mult, swap, dyn)
    if mult is None:
        return make_mul(None)
    return make_mul(AxMul32Config(mult, parts=parts, swap=swap), dyn)


def to_device(inputs: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in inputs.items()}


def evaluate(app: AxApp, mode: Mode = "fxp", mult: Optional[AxMult] = None,
             parts: tuple = PART_MD_LO, n: int = 256, seed: int = 1234, inputs=None,
             device="cuda"):
    """Run one configuration end to end; returns (metric value, output)."""
    if inputs is None:
        inputs = app.gen_inputs(n, seed)
    ref = app.reference(inputs)
    ref_t = torch.as_tensor(ref, device=device)
    if mode == "fp":
        return float(app.metric(ref_t, ref_t)), ref
    if mode == "fxp":
        mul = _build_mul(app, None, parts, None, None)
    elif mode == "oracle":
        if mult is None:
            raise ValueError("mode 'oracle' needs a multiplier")
        mul = _build_mul(app, oracle_mult(mult), parts, None, None)
    else:  # None (NoSwap) or a SwapConfig
        if mult is None:
            raise ValueError(f"mode {mode!r} needs a multiplier")
        mul = _build_mul(app, mult, parts, mode, None)
    out = app.run_fxp(to_device(inputs, device), mul)
    return float(app.metric(out, ref_t)), out


def tune_app(app: AxApp, mult: AxMult, parts: tuple = PART_MD_LO, n: int = 256,
             seed: int = 42, inputs=None, device="cuda"):
    """Application-level SWAPPER tuning (paper §III.B): score all 4M configs
    on representative (train) inputs with the app's own metric.  Returns
    (best config or None, its metric, table)."""
    if inputs is None:
        inputs = app.gen_inputs(n, seed)
    ref_t = torch.as_tensor(app.reference(inputs), device=device)
    dev_inputs = to_device(inputs, device)

    def run_cfg(op_is_a, bit, value):
        mul = _build_mul(app, mult, parts, None, (op_is_a, bit, value))
        return app.metric(app.run_fxp(dev_inputs, mul), ref_t)

    return tune_application(run_cfg, bits=mult.bits, minimize=app.minimize, device=device)


# ---------------------------------------------------------------------------
# shared synthetic-input helpers
# ---------------------------------------------------------------------------

def smooth_image(h, w, seed, channels: Optional[int] = None) -> np.ndarray:
    """Structured synthetic image in [0, 255]: random smooth cosine field +
    rectangles + gradient (SSIM needs structure, not noise)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    c = channels or 1
    img = np.zeros((h, w, c))
    for ch in range(c):
        f = np.zeros((h, w))
        for _ in range(6):
            fx, fy = rng.uniform(0.2, 4.0, 2)
            ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
            f += rng.uniform(0.3, 1.0) * np.cos(2 * np.pi * fx * x / w + ph1) * np.cos(
                2 * np.pi * fy * y / h + ph2
            )
        f += (x / w) * rng.uniform(0.5, 2.0)
        for _ in range(4):  # hard edges
            x0, y0 = rng.integers(0, w - 8), rng.integers(0, h - 8)
            dw, dh = rng.integers(4, max(5, w // 3)), rng.integers(4, max(5, h // 3))
            f[y0 : y0 + dh, x0 : x0 + dw] += rng.uniform(-1.5, 1.5)
        f = (f - f.min()) / max(f.max() - f.min(), 1e-9)
        img[..., ch] = f * 255.0
    return img if channels else img[..., 0]

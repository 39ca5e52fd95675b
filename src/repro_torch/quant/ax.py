"""SWAPPER approximate matmul as an LM projection (``repro.quant.ax``).

``ax_dense`` quantizes the activation rows and the weight columns to int8,
runs the approximate int8 matmul, and dequantizes; its backward is the
straight-through exact-matmul gradient.  Backends of ``ax_matmul_int``:

* ``kernel`` — ``kernels.ops.ax_matmul`` (the CUDA kernel on the card, its
  plain version on the CPU), with the JAX package's block padding;
* ``emul``   — the plain reference ``kernels.ref.ax_matmul_ref``;
* ``mxu``    — the separable-family int8 GEMM: not ported yet (ROADMAP
  queue 1, item 3).

The dynamic-config path (``ax_dense_dyn`` and the ``_dyn`` matmuls) waits
for the adaptive runtime's slice.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import AxPolicy
from repro_torch.core import multipliers as M
from repro_torch.kernels.ops import ax_matmul
from repro_torch.kernels.ref import ax_matmul_ref
from repro_torch.kernels.schedule import KernelSchedule

__all__ = ["ax_dense", "quantize_rows", "separable_transforms", "ax_matmul_int"]


# ---------------------------------------------------------------------------
# separable closed forms
# ---------------------------------------------------------------------------

def _sign_mag_mask(mask: int):
    def f(x):  # sign-magnitude low-bit masking (matches multipliers.trunc)
        neg = x < 0
        mag = torch.where(neg, -x, x) & mask
        return torch.where(neg, -mag, mag)

    return f


def separable_transforms(mult_name: str) -> Optional[Tuple[Callable, Callable]]:
    """(f, g) with m(a, b) = f(a) * g(b) on int32-valued tensors, or None if
    the family is inseparable."""
    base = mult_name.split("_", 1)[1] if "_" in mult_name else mult_name
    if base.startswith("trunc"):
        ka, kb = (int(v) for v in base[len("trunc"):].split("_"))
        return _sign_mag_mask(~((1 << ka) - 1)), _sign_mag_mask(~((1 << kb) - 1))
    if base.startswith("perf"):
        rowmask = 0
        for r in base[len("perf"):].split("_"):
            rowmask |= 1 << int(r)
        return (lambda x: x), _sign_mag_mask(~rowmask)
    return None


# ---------------------------------------------------------------------------
# int8 quantization
# ---------------------------------------------------------------------------

# XLA compiles ``amax / 127.0`` as a multiply by the f32 reciprocal of 127
# wherever the JAX package runs it under jit (every model and serving
# path), so the port multiplies by that same constant.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_rows(x: torch.Tensor, axis: int = -1):
    """Symmetric per-row int8 quantization along ``axis`` (round half to
    even, as ``jnp.round``), bit-identical to the jit-compiled
    ``repro.quant.ax.quantize_rows``."""
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) * _INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


# ---------------------------------------------------------------------------
# the int matmul
# ---------------------------------------------------------------------------

def _pad_to_multiple(v: torch.Tensor, mult_: int, axis: int) -> torch.Tensor:
    """Zero-pad ``v`` along ``axis`` up to the next multiple of ``mult_``."""
    pad = (-v.shape[axis]) % mult_
    if pad == 0:
        return v
    widths = [0, 0] * v.dim()
    widths[2 * (v.dim() - 1 - (axis % v.dim())) + 1] = pad
    return F.pad(v, widths)


def _pad_for_kernel(a_i8, b_i8, sched: KernelSchedule):
    """Flatten leading dims and zero-pad both operands to block multiples
    (blocks = the schedule's caps clamped to the logical dims).  Returns
    (a2d, b, lead_shape, m0, n0, (bm, bn, bk)); callers crop
    ``out[:m0, :n0]``."""
    lead = a_i8.shape[:-1]
    a2d = a_i8.reshape(-1, a_i8.shape[-1])
    m0, k0 = a2d.shape
    n0 = b_i8.shape[-1]
    bm, bn, bk = min(sched.bm, m0), min(sched.bn, n0), min(sched.bk, k0)
    a2d = _pad_to_multiple(_pad_to_multiple(a2d, bm, 0), bk, 1)
    bp = _pad_to_multiple(_pad_to_multiple(b_i8, bk, 0), bn, 1)
    return a2d.contiguous(), bp.contiguous(), lead, m0, n0, (bm, bn, bk)


def ax_matmul_int(a_i8, b_i8, policy: AxPolicy,
                  schedule: Optional[KernelSchedule] = None) -> torch.Tensor:
    """Approximate int matmul (..., K) @ (K, N) -> (..., N) int32."""
    mult = M.get(policy.mult_name)
    swap = policy.swap
    if policy.backend == "kernel":
        sched = schedule or KernelSchedule()
        a2d, bp, lead, m0, n0, (bm, bn, bk) = _pad_for_kernel(a_i8, b_i8, sched)
        out = ax_matmul(a2d, bp, mult, swap,
                        schedule=KernelSchedule(bm, bn, bk, sched.grid_order))
        return out[:m0, :n0].reshape(*lead, n0)
    if policy.backend == "emul":
        lead = a_i8.shape[:-1]
        a2d = a_i8.reshape(-1, a_i8.shape[-1])
        return ax_matmul_ref(a2d, b_i8, mult, swap).reshape(*lead, b_i8.shape[-1])
    if policy.backend == "mxu":
        raise NotImplementedError(
            "the 'mxu' backend (separable families as one K-stacked int8 GEMM) "
            "is not ported yet: ROADMAP queue 1, item 3 (quantized projection)")
    raise ValueError(f"unknown backend {policy.backend!r}")


# ---------------------------------------------------------------------------
# the projection layer
# ---------------------------------------------------------------------------

def _ax_dense_fwd_impl(x, w, policy: AxPolicy):
    xq, sx = quantize_rows(x.to(torch.float32), axis=-1)
    wq, sw = quantize_rows(w.to(torch.float32), axis=0)
    acc = ax_matmul_int(xq, wq, policy)
    return (acc.to(torch.float32) * sx * sw).to(x.dtype)


class _AxDense(torch.autograd.Function):
    """Forward: the approximate quantized matmul.  Backward: the exact
    matmul gradients (straight-through estimator)."""

    @staticmethod
    def forward(ctx, x, w, policy):
        ctx.save_for_backward(x, w)
        return _ax_dense_fwd_impl(x, w, policy)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy32 = gy.to(torch.float32)
        gx = (gy32 @ w.to(torch.float32).T).to(x.dtype)
        xf = x.to(torch.float32).reshape(-1, x.shape[-1])
        gw = (xf.T @ gy32.reshape(-1, gy.shape[-1])).to(w.dtype)
        return gx, gw, None


def ax_dense(x, w, policy: AxPolicy):
    """y = x @ w through the SWAPPER approximate path (quantize -> ax matmul
    -> dequantize); straight-through exact gradients."""
    return _AxDense.apply(x, w, policy)

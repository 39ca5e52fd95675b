"""SWAPPER approximate matmul as an LM projection (``repro.quant.ax``).

``ax_dense`` quantizes the activation rows and the weight columns to int8,
runs the approximate int8 matmul, and dequantizes; its backward is the
straight-through exact-matmul gradient.  Backends of ``ax_matmul_int``:

* ``kernel`` — ``kernels.ops.ax_matmul`` (the CUDA kernel on the card, its
  plain version on the CPU), with the JAX package's block padding;
* ``emul``   — the plain reference ``kernels.ref.ax_matmul_ref``;
* ``mxu``    — the separable-family int8 GEMM: not ported yet (ROADMAP
  queue 1, item 3).

The dynamic-config path of the adaptive runtime (``ax_dense_dyn``,
``ax_matmul_int_dyn[_hist]``) takes the swap decision as an int32 tensor on
the operands' device: a (3,) triple or a (gm, gn, 3) per-tile grid.  Its
``kernel`` backend runs ``kernels.ops.ax_matmul_grid``, the CUDA grid
kernel, which reads the triples on the device, so a new policy costs no
rebuild and no host synchronise.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import AxPolicy
from repro_torch.core import multipliers as M
from repro_torch.core.multipliers import separable_transforms
from repro_torch.core.tiling import (largest_divisor_leq, rowtile_count,
                                     rowtile_index, rowtile_span)
from repro_torch.kernels.ops import ax_matmul, ax_matmul_grid
from repro_torch.kernels.ref import ax_matmul_ref, ax_matmul_tiles_ref
from repro_torch.kernels.schedule import KernelSchedule

__all__ = ["ax_dense", "ax_dense_dyn", "quantize_rows", "separable_transforms",
           "ax_matmul_int", "ax_matmul_int_dyn", "ax_matmul_int_dyn_hist"]


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


def _no_mxu():
    return NotImplementedError(
        "the 'mxu' backend (separable families as one K-stacked int8 GEMM) "
        "is not ported yet: ROADMAP queue 1, item 3 (quantized projection)")


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
        raise _no_mxu()
    raise ValueError(f"unknown backend {policy.backend!r}")


# ---------------------------------------------------------------------------
# dynamic-config variants (the adaptive runtime's path)
# ---------------------------------------------------------------------------

def _as_dyn(dyn, device) -> torch.Tensor:
    """The swap decision as an int32 tensor on ``device`` (no copy when it
    already is one)."""
    return torch.as_tensor(dyn, dtype=torch.int32, device=device)


def _block_of(span: int, cap: int = 128) -> int:
    """Kernel block size aligned to a logical tile span, so no block
    straddles a tile."""
    return largest_divisor_leq(span, cap)


def _kernel_grid_tiled(a_i8, b_i8, mult, dyn, sched: KernelSchedule,
                       tile_hist: bool = False):
    """Grid-kernel dispatch of a logical (gm, gn, 3) config grid.

    The kernel applies one triple per *physical* (bm, bn) block, so the
    blocks are aligned to the logical tile spans (``_block_of`` under the
    schedule's caps: each block lies inside one logical tile) and the
    logical grid is gathered onto the block grid with indices made on the
    device — per-tile semantics at any granularity, and no host read.

    ``tile_hist=True`` also returns the kernel's in-reduction bit counts
    aggregated to the LOGICAL row tiles: ``(tile_bits (g, bits) f32,
    tile_neg (g,) f32, tile_n (g,) int32)`` with full per-tile counts
    (padding adds no counts and is left out of ``tile_n``).  Physical row
    blocks are tile-aligned, so the aggregation is an integer segment sum
    (``index_add_``); it equals the JAX package's f32 ``assign @ a_rows``
    because every count stays below 2^24."""
    lead = a_i8.shape[:-1]
    a2d = a_i8.reshape(-1, a_i8.shape[-1])
    m0, k0 = a2d.shape
    n0 = b_i8.shape[-1]
    g_m = rowtile_count(m0, int(dyn.shape[0]))
    g_n = rowtile_count(n0, int(dyn.shape[1]))
    rows_per = rowtile_span(m0, int(dyn.shape[0]))
    cols_per = rowtile_span(n0, int(dyn.shape[1]))
    bm, bn = _block_of(rows_per, sched.bm), _block_of(cols_per, sched.bn)
    bk = min(sched.bk, k0)
    a2d = _pad_to_multiple(_pad_to_multiple(a2d, bm, 0), bk, 1).contiguous()
    bp = _pad_to_multiple(_pad_to_multiple(b_i8, bk, 0), bn, 1).contiguous()
    gmk, gnk = a2d.shape[0] // bm, bp.shape[1] // bn
    dev = a2d.device
    ri = torch.clamp((torch.arange(gmk, device=dev) * bm) // rows_per, max=g_m - 1)
    ci = torch.clamp((torch.arange(gnk, device=dev) * bn) // cols_per, max=g_n - 1)
    grid = dyn.index_select(0, ri).index_select(1, ci).contiguous()
    res = ax_matmul_grid(a2d, bp, mult, grid, tile_hist=tile_hist,
                         schedule=KernelSchedule(bm, bn, bk, sched.grid_order))
    if not tile_hist:
        return res[:m0, :n0].reshape(*lead, n0)
    out, hist = res
    bits = mult.bits
    # A-side counts are the same across a row of output tiles: column 0
    a_rows = hist[:, 0, 0, :].to(torch.int64)                 # (gmk, bits+1)
    agg = torch.zeros((g_m, bits + 1), dtype=torch.int64, device=dev)
    agg = agg.index_add_(0, ri, a_rows).to(torch.float32)
    tile_n = torch.full((g_m,), rows_per * k0, dtype=torch.int32, device=dev)
    tile_n[-1] = (m0 - (g_m - 1) * rows_per) * k0             # absorbed remainder
    return (out[:m0, :n0].reshape(*lead, n0),
            (agg[:, :bits], agg[:, bits], tile_n))


def ax_matmul_int_dyn(a_i8, b_i8, policy: AxPolicy, dyn,
                      schedule: Optional[KernelSchedule] = None) -> torch.Tensor:
    """``ax_matmul_int`` with the swap decision as a run-time int32 tensor:
    a (3,) ``(op_is_a, bit, value)`` triple (value 2 = NoSwap) for the whole
    projection, or a (gm, gn, 3) per-tile grid over the flattened token rows
    and the output columns (``core.tiling.rowtile_*`` partition).

    ``kernel`` runs the CUDA grid kernel (a triple broadcast to every block,
    or the logical grid gathered onto tile-aligned blocks); ``emul`` is the
    plain reference for both; ``mxu`` is not ported yet."""
    mult = M.get(policy.mult_name)
    dyn = _as_dyn(dyn, a_i8.device)
    tiled = dyn.dim() == 3
    if policy.backend == "kernel":
        sched = schedule or KernelSchedule()
        if tiled:
            return _kernel_grid_tiled(a_i8, b_i8, mult, dyn, sched)
        a2d, bp, lead, m0, n0, (bm, bn, bk) = _pad_for_kernel(a_i8, b_i8, sched)
        grid = dyn.expand(a2d.shape[0] // bm, bp.shape[1] // bn, 3).contiguous()
        out = ax_matmul_grid(a2d, bp, mult, grid,
                             schedule=KernelSchedule(bm, bn, bk, sched.grid_order))
        return out[:m0, :n0].reshape(*lead, n0)
    if policy.backend == "emul":
        lead = a_i8.shape[:-1]
        a2d = a_i8.reshape(-1, a_i8.shape[-1])
        M_, N = a2d.shape[0], b_i8.shape[-1]
        if tiled:
            rows = torch.from_numpy(rowtile_index(M_, dyn.shape[0]))
            cols = torch.from_numpy(rowtile_index(N, dyn.shape[1]))
        else:
            dyn = dyn.reshape(1, 1, 3)
            rows = torch.zeros(M_, dtype=torch.int64)
            cols = torch.zeros(N, dtype=torch.int64)
        out = ax_matmul_tiles_ref(a2d, b_i8, mult, dyn, rows, cols)
        return out.reshape(*lead, N)
    if policy.backend == "mxu":
        raise _no_mxu()
    raise ValueError(f"unknown backend {policy.backend!r}")


def ax_matmul_int_dyn_hist(a_i8, b_i8, policy: AxPolicy, dyn,
                           schedule: Optional[KernelSchedule] = None):
    """:func:`ax_matmul_int_dyn` (kernel backend, grid ``dyn``) that also
    returns the kernel's in-reduction per-row-tile operand statistic, the
    ``(tile_bits, tile_neg, tile_n)`` triple ``runtime.telemetry.tile_summary``
    takes as ``bits_from=``: one launch applies the per-tile policy and
    counts what the controller needs for the next one."""
    dyn = _as_dyn(dyn, a_i8.device)
    if policy.backend != "kernel" or dyn.dim() != 3:
        raise ValueError(f"the kernel tile histogram needs backend='kernel' and a "
                         f"(gm, gn, 3) grid: {policy.backend!r}, {tuple(dyn.shape)}")
    return _kernel_grid_tiled(a_i8, b_i8, M.get(policy.mult_name), dyn,
                              schedule or KernelSchedule(), tile_hist=True)


# ---------------------------------------------------------------------------
# the projection layer
# ---------------------------------------------------------------------------

def _ax_dense_fwd_impl(x, w, policy: AxPolicy):
    xq, sx = quantize_rows(x.to(torch.float32), axis=-1)
    wq, sw = quantize_rows(w.to(torch.float32), axis=0)
    acc = ax_matmul_int(xq, wq, policy)
    return (acc.to(torch.float32) * sx * sw).to(x.dtype)


def _ste_grads(ctx, gy):
    """The exact matmul's gradients of ``x @ w`` (straight-through)."""
    x, w = ctx.saved_tensors
    gy32 = gy.to(torch.float32)
    gx = (gy32 @ w.to(torch.float32).T).to(x.dtype)
    xf = x.to(torch.float32).reshape(-1, x.shape[-1])
    gw = (xf.T @ gy32.reshape(-1, gy.shape[-1])).to(w.dtype)
    return gx, gw


class _AxDense(torch.autograd.Function):
    """Forward: the approximate quantized matmul.  Backward: the exact
    matmul gradients (straight-through estimator)."""

    @staticmethod
    def forward(ctx, x, w, policy):
        ctx.save_for_backward(x, w)
        return _ax_dense_fwd_impl(x, w, policy)

    @staticmethod
    def backward(ctx, gy):
        return (*_ste_grads(ctx, gy), None)


def ax_dense(x, w, policy: AxPolicy):
    """y = x @ w through the SWAPPER approximate path (quantize -> ax matmul
    -> dequantize); straight-through exact gradients."""
    return _AxDense.apply(x, w, policy)


class _DynCore(torch.autograd.Function):
    """Dequantized dynamic approximate matmul over pre-quantized operands
    (``repro.quant.ax._ax_dense_dyn_core``); ``x``/``w`` ride along for the
    straight-through gradient, the other inputs get none."""

    @staticmethod
    def forward(ctx, x, w, policy, dyn, xq, sx, wq, sw):
        ctx.save_for_backward(x, w)
        acc = ax_matmul_int_dyn(xq, wq, policy, dyn)
        return (acc.to(torch.float32) * sx * sw).to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        return (*_ste_grads(ctx, gy), None, None, None, None, None, None)


class _DynHistCore(torch.autograd.Function):
    """:class:`_DynCore` whose kernel launch also returns the per-row-tile
    bit statistic (``repro.quant.ax._ax_dense_dyn_hist_core``); the
    statistic is observational and takes no gradient."""

    @staticmethod
    def forward(ctx, x, w, policy, dyn, xq, sx, wq, sw):
        ctx.save_for_backward(x, w)
        acc, (kb, kn, kc) = ax_matmul_int_dyn_hist(xq, wq, policy, dyn)
        ctx.mark_non_differentiable(kb, kn, kc)
        return (acc.to(torch.float32) * sx * sw).to(x.dtype), kb, kn, kc

    @staticmethod
    def backward(ctx, gy, *_):
        return (*_ste_grads(ctx, gy), None, None, None, None, None, None)


def ax_dense_dyn(x, w, policy: AxPolicy, dyn, scope=None, target: str = ""):
    """``ax_dense`` with the swap decision as a run-time int32 tensor (the
    adaptive runtime's path): ``dyn`` is a (3,) triple, or a (gm, 1, 3)
    per-row-tile grid when the scope runs in tile mode.

    ``quantize_rows`` runs once; its codes feed both the telemetry and the
    matmul.  When ``scope`` observes this step (``scope.observing``) the
    call records ``operand_summary`` under ``target`` (its live-policy
    error sample uses ``dyn[0, 0]`` when ``dyn`` is a grid), and in tile
    mode a ``tile_summary`` under ``tile_key(target)``.  With
    ``scope.kernel_hist``, the kernel backend and a grid ``dyn``, the tile
    bit counts come out of the matmul kernel itself (``_DynHistCore``)
    instead of a sampled pass.  A step the scope does not observe computes
    no summary at all."""
    xq, sx = quantize_rows(x.to(torch.float32), axis=-1)
    wq, sw = quantize_rows(w.to(torch.float32), axis=0)
    dyn = _as_dyn(dyn, x.device)
    if scope is not None and scope.observing:
        from repro_torch.runtime.telemetry import operand_summary, tile_key, tile_summary

        mult = M.get(policy.mult_name)
        dyn_rep = dyn if dyn.dim() == 1 else dyn[0, 0]
        scope.record(target, operand_summary(xq, wq, mult, dyn_rep))
        if scope.tile_rows > 0:
            if scope.kernel_hist and policy.backend == "kernel" and dyn.dim() == 3:
                y, *hist = _DynHistCore.apply(x, w, policy, dyn, xq, sx, wq, sw)
                scope.record(tile_key(target),
                             tile_summary(xq, wq, mult, scope.tile_rows, dyn=dyn,
                                          bits_from=tuple(hist)))
                return y
            scope.record(tile_key(target),
                         tile_summary(xq, wq, mult, scope.tile_rows, dyn=dyn))
    return _DynCore.apply(x, w, policy, dyn, xq, sx, wq, sw)

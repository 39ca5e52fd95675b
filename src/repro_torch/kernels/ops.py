"""Public kernel API (``repro.kernels.ops``): schedule-resolving wrappers.

The block caps come from a :class:`KernelSchedule` (defaults 128/128/128),
clamped to the operand dims exactly as the JAX package clamps them, so the
``tile_hist`` layout matches ``repro.kernels.ax_matmul``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.multipliers import AxMult
from repro_torch.core.swapper import SwapConfig

from .ax_matmul import ax_matmul_blocks, ax_matmul_grid_blocks
from .schedule import KernelSchedule

__all__ = ["ax_matmul", "ax_matmul_dequant", "ax_matmul_grid", "KernelSchedule"]


def _blocks(a, b, schedule: Optional[KernelSchedule]):
    s = schedule or KernelSchedule()
    M, K = a.shape
    N = b.shape[1]
    return dict(bm=min(s.bm, M), bn=min(s.bn, N), bk=min(s.bk, K),
                grid_order=s.grid_order)


def ax_matmul(a, b, mult: AxMult, swap: Optional[SwapConfig] = None, *,
              schedule: Optional[KernelSchedule] = None, tile_hist: bool = False):
    """int8 x int8 (or uint8 x uint8) -> int32 approximate matmul with fused
    SWAPPER; ``tile_hist=True`` returns ``(out, hist)``."""
    return ax_matmul_blocks(a, b, mult, swap, tile_hist=tile_hist,
                            **_blocks(a, b, schedule))


def ax_matmul_dequant(a, b, scale_a, scale_b, mult: AxMult,
                      swap: Optional[SwapConfig] = None, *,
                      schedule: Optional[KernelSchedule] = None,
                      out_dtype=torch.float32):
    """Quantized approximate matmul with the dequantization epilogue."""
    acc = ax_matmul(a, b, mult, swap, schedule=schedule)
    return (acc.to(torch.float32) * scale_a * scale_b).to(out_dtype)


def ax_matmul_grid(a, b, mult: AxMult, cfg_grid, *,
                   schedule: Optional[KernelSchedule] = None, tile_hist: bool = False):
    """Approximate matmul with a per-output-tile SWAPPER config grid:
    ``cfg_grid[ti, tj]`` is the (op_is_a, bit, value) int32 triple of output
    tile (ti, tj) of the schedule's blocks (clamped to the dims), value 2 =
    NoSwap.  The grid is a device tensor the kernel reads itself, so a new
    grid value re-tunes the projection with no rebuild and no host
    synchronise.  ``tile_hist=True`` returns ``(out, hist)``."""
    return ax_matmul_grid_blocks(a, b, mult, cfg_grid, tile_hist=tile_hist,
                                 **_blocks(a, b, schedule))

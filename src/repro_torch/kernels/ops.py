"""Public kernel API (``repro.kernels.ops``): schedule-resolving matmul
wrappers and the kernel-driven component sweep.

Every wrapper resolves a :class:`KernelSchedule` on the host at dispatch,
in the JAX package's order: an explicit ``schedule=`` first, then the
deprecated ``block_m=``/``block_n=``/``block_k=``/``k_slab=`` keywords
(with a ``DeprecationWarning``; ``k_slab`` has no counterpart on the card),
then the process-installed table (``schedule.install_table``), then the
defaults.  The caps are clamped to the operand dims exactly as the JAX
package clamps them, so the ``tile_hist`` layout matches
``repro.kernels.ax_matmul``; the schedule's ``tile``/``slots``/``splits``
go to the launch (``ax_matmul.plan``).  A CUDA graph records the launches
of its capture, so installing a table changes no captured graph.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.core.multipliers import AxMult
from repro_torch.core.swapper import SwapConfig
from repro_torch.core.tuning import (ComponentResult, accs_from_row_stats, operand_values,
                                     result_from_accs)

from . import schedule as SCHED
from .ax_matmul import ax_matmul_blocks, ax_matmul_grid_blocks
from .schedule import KernelSchedule
from .tuning_sweep import tuning_sweep

__all__ = ["ax_matmul", "ax_matmul_dequant", "ax_matmul_grid", "component_sweep_kernel",
           "KernelSchedule"]

_LEGACY_MSG = (
    "kernels.%s: block_m/block_n/block_k/k_slab kwargs are deprecated; "
    "pass schedule=KernelSchedule(...) (or install an autotuned table). "
    "The kwarg shim will be removed next release.")


def _sched_for(fname: str, op: str, a, b, mult: AxMult,
               schedule: Optional[KernelSchedule], block_m, block_n, block_k,
               k_slab) -> KernelSchedule:
    """Explicit schedule > deprecated keywords > installed table > defaults."""
    legacy = (block_m, block_n, block_k, k_slab)
    if schedule is not None:
        if any(v is not None for v in legacy):
            raise ValueError("pass either schedule= or the legacy block keywords, not both")
        return SCHED.resolve_for(a.shape, b.shape, "kernel", mult.name, op,
                                 override=schedule)
    if any(v is not None for v in legacy):
        warnings.warn(_LEGACY_MSG % fname, DeprecationWarning, stacklevel=3)
        return SCHED.from_legacy_kwargs("kernel", block_m, block_n, block_k, k_slab)
    return SCHED.resolve_for(a.shape, b.shape, "kernel", mult.name, op)


def _launch_kw(a, b, s: KernelSchedule) -> dict:
    """The blocks wrappers' keywords: caps clamped to the dims, the grid
    order and the launch knobs."""
    M, K = a.shape
    N = b.shape[1]
    return dict(bm=min(s.bm, M), bn=min(s.bn, N), bk=min(s.bk, K),
                grid_order=s.grid_order, **s.knobs())


def ax_matmul(a, b, mult: AxMult, swap: Optional[SwapConfig] = None, *,
              schedule: Optional[KernelSchedule] = None, block_m: Optional[int] = None,
              block_n: Optional[int] = None, block_k: Optional[int] = None,
              k_slab: Optional[int] = None, tile_hist: bool = False):
    """int8 x int8 (or uint8 x uint8) -> int32 approximate matmul with fused
    SWAPPER; ``tile_hist=True`` returns ``(out, hist)``.  The schedule is
    resolved under op "matmul" (module note)."""
    sched = _sched_for("ax_matmul", "matmul", a, b, mult, schedule, block_m, block_n,
                       block_k, k_slab)
    return ax_matmul_blocks(a, b, mult, swap, tile_hist=tile_hist,
                            **_launch_kw(a, b, sched))


def ax_matmul_dequant(a, b, scale_a, scale_b, mult: AxMult,
                      swap: Optional[SwapConfig] = None, *,
                      schedule: Optional[KernelSchedule] = None,
                      block_m: Optional[int] = None, block_n: Optional[int] = None,
                      block_k: Optional[int] = None, out_dtype=torch.float32):
    """Quantized approximate matmul with the dequantization epilogue."""
    sched = _sched_for("ax_matmul_dequant", "matmul", a, b, mult, schedule, block_m,
                       block_n, block_k, None)
    acc = ax_matmul_blocks(a, b, mult, swap, **_launch_kw(a, b, sched))
    return (acc.to(torch.float32) * scale_a * scale_b).to(out_dtype)


def ax_matmul_grid(a, b, mult: AxMult, cfg_grid, *,
                   schedule: Optional[KernelSchedule] = None, block_m: Optional[int] = None,
                   block_n: Optional[int] = None, block_k: Optional[int] = None,
                   k_slab: Optional[int] = None, tile_hist: bool = False):
    """Approximate matmul with a per-output-tile SWAPPER config grid:
    ``cfg_grid[ti, tj]`` is the (op_is_a, bit, value) int32 triple of output
    tile (ti, tj) of the schedule's blocks (clamped to the dims), value 2 =
    NoSwap.  The grid is a device tensor the kernel reads itself, so a new
    grid value re-tunes the projection with no rebuild and no host
    synchronise.  The schedule is resolved under op "matmul_grid".
    ``tile_hist=True`` returns ``(out, hist)``."""
    sched = _sched_for("ax_matmul_grid", "matmul_grid", a, b, mult, schedule, block_m,
                       block_n, block_k, k_slab)
    return ax_matmul_grid_blocks(a, b, mult, cfg_grid, tile_hist=tile_hist,
                                 **_launch_kw(a, b, sched))


def component_sweep_kernel(mult: AxMult, sample_bits: Optional[int] = None, seed: int = 0,
                           device="cuda") -> ComponentResult:
    """Component-level tuning driven by the sweep kernel, the counterpart of
    ``repro.kernels.ops.component_sweep_pallas``: one ``tuning_sweep`` over
    the operand set on ``device`` (the plain version on the CPU), then
    NoSwap, all 4M configurations and the oracle scored on the host."""
    vals = operand_values(mult.bits, mult.signed, sample_bits, seed)
    stats = tuning_sweep(mult, torch.from_numpy(vals).to(device))
    r0, r1, orc = accs_from_row_stats(vals, stats)
    return result_from_accs(mult, vals, r0, r1, orc)

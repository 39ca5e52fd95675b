"""``ax_matmul`` and ``ax_matmul_grid``: the approximate 8-bit matmul with
the SWAPPER swap fused ahead of every product.

Replaces the Pallas TPU kernels ``ax_matmul_pallas`` and
``ax_matmul_grid_pallas`` of ``src/repro/kernels/ax_matmul.py`` with one
hand-written CUDA C++ kernel body in ``csrc/ax_matmul.cu`` (built for
``sm_90a`` by ``_build.py``), compiled twice: with the swap triple as a
launch argument, and with a per-output-tile triple grid it reads from the
device.  On an H100 both are bounded by the int8 weight bytes (K*N) at
decode and by the M*K*N approximate products at prefill; the products run
on the CUDA cores as shared-memory table gathers, not on the tensor cores.
The source's head note says what the design does about that.

The multiplier reaches the kernel as its 256 x 256 product table over the
operand type (:func:`product_table`, cached per multiplier, operand type
and device).  A static swap reaches it as an ``(op_is_a, bit, value)``
triple at launch; a grid is passed by its device pointer and never read on
the host, so a new policy neither rebuilds anything nor synchronises.

:func:`ax_matmul_blocks` and :func:`ax_matmul_grid_blocks` launch the
kernel for CUDA tensors (and raise on anything the kernel does not take)
and run the plain PyTorch version (``kernels/ref.py``) for CPU tensors.
There is no fallback from one to the other.  ``LAUNCHES`` counts each
kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.multipliers import AxMult, operand_table
from repro_torch.core.swapper import SwapConfig, cfg_to_triple

from . import _build
from .ref import ax_matmul_grid_blocks_ref, ax_matmul_ref, tile_hist_blocks
from .schedule import GRID_ORDERS, MAX_BLOCK

__all__ = ["ax_matmul_blocks", "ax_matmul_cuda", "ax_matmul_plain",
           "ax_matmul_grid_blocks", "ax_matmul_grid_cuda", "ax_matmul_grid_plain",
           "product_table", "HIST_WIDTH", "LAUNCHES", "reset_launches"]

LAUNCHES: Dict[str, int] = {"ax_matmul": 0, "ax_matmul_grid": 0}
OPERAND_DTYPES = (torch.int8, torch.uint8)
_TABLES: Dict[Tuple, torch.Tensor] = {}
_C_FNS: Dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def HIST_WIDTH(bits: int) -> int:
    """Columns of a tile histogram row: a count per magnitude-bit position
    plus the negative-sign count."""
    return bits + 1


def product_table(mult: AxMult, operand_dtype: torch.dtype,
                  device="cpu") -> torch.Tensor:
    """The kernel's (65536,) 16-bit product table of ``mult`` over every
    pair of ``operand_dtype`` values, indexed by ``(a8 << 8) | b8`` — int16
    for a signed multiplier, the uint16 bit pattern (stored in int16) for an
    unsigned one.  Raises ``ValueError`` if a product does not fit 16 bits
    (for example a signed multiplier on uint8 values: 255 * 255)."""
    if operand_dtype not in OPERAND_DTYPES:
        raise ValueError(f"operands must be int8 or uint8, got {operand_dtype}")
    device = torch.device(device)
    key = (mult, operand_dtype, device)
    tbl = _TABLES.get(key)
    if tbl is None:
        vals = operand_table(mult, operand_dtype == torch.int8)
        lo, hi = (-(1 << 15), (1 << 15) - 1) if mult.signed else (0, (1 << 16) - 1)
        vmin, vmax = int(vals.min()), int(vals.max())
        if vmin < lo or vmax > hi:
            raise ValueError(
                f"{mult.name} on {operand_dtype} operands: products span "
                f"[{vmin}, {vmax}], outside the 16-bit table range [{lo}, {hi}]")
        bits16 = torch.where(vals > (1 << 15) - 1, vals - (1 << 16), vals)
        tbl = _TABLES[key] = bits16.to(torch.int16).to(device).contiguous()
    return tbl


def ax_matmul_plain(a, b, mult: AxMult, swap: Optional[SwapConfig], *,
                    bm: int, bn: int, tile_hist: bool = False):
    """The plain PyTorch version: every swapped product materialised
    (chunked over K) and summed with int32 wrap."""
    out = ax_matmul_ref(a, b, mult, swap)
    if not tile_hist:
        return out
    return out, tile_hist_blocks(a, b, mult.bits, bm, bn)


def ax_matmul_grid_plain(a, b, mult: AxMult, cfg_grid, *, bm: int, bn: int,
                         tile_hist: bool = False):
    """The plain PyTorch version of the grid kernel: output tile (ti, tj) of
    (bm, bn) applies ``cfg_grid[ti, tj]``."""
    out = ax_matmul_grid_blocks_ref(a, b, mult, cfg_grid, bm, bn)
    if not tile_hist:
        return out
    return out, tile_hist_blocks(a, b, mult.bits, bm, bn)


def _c_fn(name: str):
    """The C entry point ``<name>_launch`` of the built library, typed."""
    fn = _C_FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("ax_matmul"), f"{name}_launch")
        n_ptr, n_int = (5, 13) if name == "ax_matmul" else (6, 10)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _C_FNS[name] = fn
    return fn


def _launch(name: str, a, b, mult: AxMult, bm: int, bn: int, bk: int,
            grid_order: str, tile_hist: bool, mid_args: tuple, tail_args: tuple):
    """Allocate the outputs and launch ``<name>_launch`` on the current
    stream; shapes, types and devices are checked by the callers."""
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous operands")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    M, K = a.shape
    N = b.shape[1]
    table = product_table(mult, a.dtype, a.device)
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    hist = None
    hw = 0
    if tile_hist:
        hw = HIST_WIDTH(mult.bits)
        hist = torch.empty((-(-M // bm), -(-N // bn), 2, hw), dtype=torch.int32,
                           device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _c_fn(name)(a.data_ptr(), b.data_ptr(), table.data_ptr(), *mid_args,
                         out.data_ptr(), hist.data_ptr() if hist is not None else None,
                         M, N, K, bm, bn, bk, int(a.dtype == torch.int8),
                         int(mult.signed), *tail_args, hw, int(grid_order == "nm"),
                         stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {rc} "
                           f"(M={M} N={N} K={K} blocks={bm}x{bn}x{bk})")
    LAUNCHES[name] += 1
    return (out, hist) if tile_hist else out


def ax_matmul_cuda(a, b, mult: AxMult, swap: Optional[SwapConfig], *,
                   bm: int, bn: int, bk: int, grid_order: str = "mn",
                   tile_hist: bool = False):
    """Launch the static-swap CUDA kernel on the current stream (shapes
    already checked by :func:`ax_matmul_blocks`)."""
    return _launch("ax_matmul", a, b, mult, bm, bn, bk, grid_order, tile_hist,
                   (), cfg_to_triple(swap))


def ax_matmul_grid_cuda(a, b, mult: AxMult, cfg_grid, *, bm: int, bn: int,
                        bk: int, grid_order: str = "mn", tile_hist: bool = False):
    """Launch the grid CUDA kernel on the current stream; the grid goes by
    its device pointer (shapes already checked by
    :func:`ax_matmul_grid_blocks`)."""
    return _launch("ax_matmul_grid", a, b, mult, bm, bn, bk, grid_order,
                   tile_hist, (cfg_grid.data_ptr(),), ())


def _check(a, b, bm: int, bn: int, bk: int, grid_order: str) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"ax_matmul takes (M, K) @ (K, N): {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.dtype not in OPERAND_DTYPES or b.dtype != a.dtype:
        raise ValueError(f"ax_matmul takes int8 or uint8 operands of one type: "
                         f"{a.dtype}, {b.dtype}")
    for v in (bm, bn, bk):
        if not 0 < v <= MAX_BLOCK:
            raise ValueError(f"blocks must lie in 1..{MAX_BLOCK}: {(bm, bn, bk)}")
    if a.shape[1] % bk:
        raise ValueError(f"K={a.shape[1]} is not a multiple of bk={bk}: pad K")
    if grid_order not in GRID_ORDERS:
        raise ValueError(grid_order)


def _require_cpu(*ts) -> None:
    if all(t.device.type == "cpu" for t in ts):
        return
    raise ValueError(f"ax_matmul runs on cuda or cpu tensors: "
                     f"{', '.join(str(t.device) for t in ts)}")


def ax_matmul_blocks(a, b, mult: AxMult, swap: Optional[SwapConfig] = None, *,
                     bm: int, bn: int, bk: int, grid_order: str = "mn",
                     tile_hist: bool = False):
    """int32 (M, N) ``sum_k mult(swap(a[m, k], b[k, n]))`` over int8 or uint8
    operands with (bm, bn) output tiles and K steps of ``bk``; with
    ``tile_hist`` also the (ceil(M/bm), ceil(N/bn), 2, bits+1) int32 tile
    histogram.  K must be a multiple of ``bk`` (callers zero-pad K); ragged
    M and N edges are masked."""
    _check(a, b, bm, bn, bk, grid_order)
    if a.device.type == "cuda":
        return ax_matmul_cuda(a, b, mult, swap, bm=bm, bn=bn, bk=bk,
                              grid_order=grid_order, tile_hist=tile_hist)
    _require_cpu(a, b)
    return ax_matmul_plain(a, b, mult, swap, bm=bm, bn=bn, tile_hist=tile_hist)


def ax_matmul_grid_blocks(a, b, mult: AxMult, cfg_grid, *, bm: int, bn: int,
                          bk: int, grid_order: str = "mn", tile_hist: bool = False):
    """:func:`ax_matmul_blocks` with a swap triple per output tile: output
    tile (ti, tj) applies the ``(op_is_a, bit, value)`` triple
    ``cfg_grid[ti, tj]`` (value 2 = NoSwap).  ``cfg_grid`` is a contiguous
    (ceil(M/bm), ceil(N/bn), 3) int32 tensor on the operands' device; only
    its shape, type, device and layout are checked, never its values, so
    a launch reads nothing back from the card."""
    _check(a, b, bm, bn, bk, grid_order)
    want = (-(-a.shape[0] // bm), -(-b.shape[1] // bn), 3)
    if tuple(cfg_grid.shape) != want or cfg_grid.dtype != torch.int32:
        raise ValueError(f"cfg_grid must be int32 of shape {want} for blocks "
                         f"{bm}x{bn}: got {cfg_grid.dtype} {tuple(cfg_grid.shape)}")
    if cfg_grid.device != a.device:
        raise ValueError(f"cfg_grid on {cfg_grid.device}, operands on {a.device}")
    if not cfg_grid.is_contiguous():
        raise ValueError("cfg_grid must be contiguous")
    if a.device.type == "cuda":
        return ax_matmul_grid_cuda(a, b, mult, cfg_grid, bm=bm, bn=bn, bk=bk,
                                   grid_order=grid_order, tile_hist=tile_hist)
    _require_cpu(a, b)
    return ax_matmul_grid_plain(a, b, mult, cfg_grid, bm=bm, bn=bn,
                                tile_hist=tile_hist)

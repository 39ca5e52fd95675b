"""``ax_matmul``: the approximate 8-bit matmul with the SWAPPER swap fused
ahead of every product.

Replaces the Pallas TPU kernel
``src/repro/kernels/ax_matmul.py::ax_matmul_pallas`` with the hand-written
CUDA C++ kernel in ``csrc/ax_matmul.cu`` (built for ``sm_90a`` by
``_build.py``).  On an H100 it is bounded by the int8 weight bytes (K*N)
and the M*K*N approximate products, which run on the CUDA cores as
shared-memory table gathers, not on the tensor cores; the source's head
note says what its design does about that.

The multiplier reaches the kernel as its 256 x 256 product table over the
operand type (:func:`product_table`, cached per multiplier, operand type
and device).  The swap reaches it as an ``(op_is_a, bit, value)`` triple at
launch, so a new swap config never rebuilds anything.

:func:`ax_matmul_blocks` launches the kernel for CUDA tensors (and raises on
anything the kernel does not take) and runs the plain PyTorch version
(``ref.ax_matmul_ref`` and ``ref.tile_hist_blocks``) for CPU tensors.
There is no fallback from one to the other.  ``LAUNCHES`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.multipliers import AxMult, operand_table
from repro_torch.core.swapper import SwapConfig, cfg_to_triple

from . import _build
from .ref import ax_matmul_ref, tile_hist_blocks
from .schedule import GRID_ORDERS, MAX_BLOCK

__all__ = ["ax_matmul_blocks", "ax_matmul_cuda", "ax_matmul_plain",
           "product_table", "HIST_WIDTH", "LAUNCHES", "reset_launches"]

LAUNCHES: Dict[str, int] = {"ax_matmul": 0}
OPERAND_DTYPES = (torch.int8, torch.uint8)
_TABLES: Dict[Tuple, torch.Tensor] = {}
_C_FN = None


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


def _c_fn():
    global _C_FN
    if _C_FN is None:
        fn = _build.load("ax_matmul").ax_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _C_FN = fn
    return _C_FN


def ax_matmul_cuda(a, b, mult: AxMult, swap: Optional[SwapConfig], *,
                   bm: int, bn: int, bk: int, grid_order: str = "mn",
                   tile_hist: bool = False):
    """Launch the CUDA kernel on the current stream (shapes already checked
    by :func:`ax_matmul_blocks`)."""
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ax_matmul kernel takes contiguous operands")
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
    op_is_a, bit, value = cfg_to_triple(swap)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _c_fn()(a.data_ptr(), b.data_ptr(), table.data_ptr(), out.data_ptr(),
                     hist.data_ptr() if hist is not None else None,
                     M, N, K, bm, bn, bk, int(a.dtype == torch.int8),
                     int(mult.signed), op_is_a, bit, value, hw,
                     int(grid_order == "nm"), stream)
    if rc != 0:
        raise RuntimeError(f"ax_matmul kernel launch failed with cudaError {rc} "
                           f"(M={M} N={N} K={K} blocks={bm}x{bn}x{bk})")
    LAUNCHES["ax_matmul"] += 1
    return (out, hist) if tile_hist else out


def ax_matmul_blocks(a, b, mult: AxMult, swap: Optional[SwapConfig] = None, *,
                     bm: int, bn: int, bk: int, grid_order: str = "mn",
                     tile_hist: bool = False):
    """int32 (M, N) ``sum_k mult(swap(a[m, k], b[k, n]))`` over int8 or uint8
    operands with (bm, bn) output tiles and K steps of ``bk``; with
    ``tile_hist`` also the (ceil(M/bm), ceil(N/bn), 2, bits+1) int32 tile
    histogram.  K must be a multiple of ``bk`` (callers zero-pad K); ragged
    M and N edges are masked."""
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
    if a.device.type == "cuda":
        return ax_matmul_cuda(a, b, mult, swap, bm=bm, bn=bn, bk=bk,
                              grid_order=grid_order, tile_hist=tile_hist)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ax_matmul_plain(a, b, mult, swap, bm=bm, bn=bn, tile_hist=tile_hist)
    raise ValueError(f"ax_matmul runs on cuda or cpu tensors: {a.device}, {b.device}")

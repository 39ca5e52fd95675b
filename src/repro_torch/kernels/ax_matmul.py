"""``ax_matmul`` and ``ax_matmul_grid``: the approximate 8-bit matmul with
the SWAPPER swap fused ahead of every product.

Replaces the Pallas TPU kernels ``ax_matmul_pallas`` and
``ax_matmul_grid_pallas`` of ``src/repro/kernels/ax_matmul.py`` with the
hand-written CUDA C++ kernels of ``csrc/ax_matmul.cu`` (built for
``sm_90a`` by ``_build.py``), reached through two C entry points: the swap
triple as a launch argument, or a per-output-tile triple grid the kernel
reads on the device.

Two routes, chosen here once per (multiplier, operand type) and cached
(:func:`route_of`), never from a tensor's value:

* ``"T"`` — the separable multipliers (``trunc*``, ``perf*``: m(a, b) =
  f(a) * g(b), with f and g fitting the operand type and reproducing
  :func:`product_table` on all 65536 pairs): the swapped product as int8
  tensor-core GEMMs over K-stacked limbs built in the kernel from the
  256-entry f/g table (:func:`fg_table`);
* ``"C"`` — every other multiplier: the 256 x 256 product table
  (:func:`product_table`) in shared memory, a gather per product on the
  CUDA cores.

:func:`plan` picks the block shape and the split of K from the shapes and
the card's SM count.  The source's head note says what bounds each route
and what the design does about it.

:func:`ax_matmul_blocks` and :func:`ax_matmul_grid_blocks` launch the
kernel for CUDA tensors (and raise on anything the kernel does not take)
and run the plain PyTorch version (``kernels/ref.py``) for CPU tensors.
There is no fallback from one to the other.  ``LAUNCHES`` counts one per
wrapper call that launches a kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.multipliers import AxMult, operand_table, separable_transforms
from repro_torch.core.swapper import SwapConfig, cfg_to_triple

from . import _build
from .ref import ax_matmul_grid_blocks_ref, ax_matmul_ref, tile_hist_blocks
from .schedule import GRID_ORDERS, MAX_BLOCK

__all__ = ["ax_matmul_blocks", "ax_matmul_cuda", "ax_matmul_plain",
           "ax_matmul_grid_blocks", "ax_matmul_grid_cuda", "ax_matmul_grid_plain",
           "product_table", "route_of", "fg_table", "plan", "Plan", "launch_args",
           "HIST_WIDTH", "LAUNCHES", "reset_launches"]

LAUNCHES: Dict[str, int] = {"ax_matmul": 0, "ax_matmul_grid": 0}
OPERAND_DTYPES = (torch.int8, torch.uint8)
ROUTES = ("T", "C")
K_STEP = 64            # K bytes per pipeline stage of the kernel
BLOCK_N = 128          # columns per CUDA block
_TABLES: Dict[Tuple, torch.Tensor] = {}
_FG: Dict[Tuple, Optional[torch.Tensor]] = {}
_SMS: Dict[torch.device, int] = {}
_C_FNS: Dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def HIST_WIDTH(bits: int) -> int:
    """Columns of a tile histogram row: a count per magnitude-bit position
    plus the negative-sign count."""
    return bits + 1


def _cached(cache: Dict, mult: AxMult, key: Tuple, build):
    """``cache`` entry of (``mult``, ``key``), built on a miss.  AxMult
    compares by name, so the entry also holds the multiplier's function
    and is rebuilt for another function of the same name (two LUTs)."""
    hit = cache.get((mult, key))
    if hit is None or hit[0] is not mult.fn:
        hit = cache[(mult, key)] = (mult.fn, build())
    return hit[1]


def _operand_values(operand_dtype: torch.dtype) -> torch.Tensor:
    """The 256 operand values in byte-pattern order, as int64."""
    v = torch.arange(256, dtype=torch.int64)
    return torch.where(v < 128, v, v - 256) if operand_dtype == torch.int8 else v


def product_table(mult: AxMult, operand_dtype: torch.dtype,
                  device="cpu") -> torch.Tensor:
    """The route-C (65536,) 16-bit product table of ``mult`` over every
    pair of ``operand_dtype`` values, indexed by ``(a8 << 8) | b8`` — int16
    for a signed multiplier, the uint16 bit pattern (stored in int16) for an
    unsigned one.  Raises ``ValueError`` if a product does not fit 16 bits
    (for example a signed multiplier on uint8 values: 255 * 255): the
    kernel takes no such pair on either route."""
    if operand_dtype not in OPERAND_DTYPES:
        raise ValueError(f"operands must be int8 or uint8, got {operand_dtype}")
    device = torch.device(device)

    def build():
        vals = operand_table(mult, operand_dtype == torch.int8)
        lo, hi = (-(1 << 15), (1 << 15) - 1) if mult.signed else (0, (1 << 16) - 1)
        vmin, vmax = int(vals.min()), int(vals.max())
        if vmin < lo or vmax > hi:
            raise ValueError(
                f"{mult.name} on {operand_dtype} operands: products span "
                f"[{vmin}, {vmax}], outside the 16-bit table range [{lo}, {hi}]")
        bits16 = torch.where(vals > (1 << 15) - 1, vals - (1 << 16), vals)
        return bits16.to(torch.int16).to(device).contiguous()

    return _cached(_TABLES, mult, (operand_dtype, device), build)


def _separable_tables(mult: AxMult, operand_dtype: torch.dtype):
    """(f, g) as (256,) int64 tensors in byte-pattern order when ``mult``
    is separable on ``operand_dtype``: ``separable_transforms`` factorizes
    it, f and g fit the operand type, and f(a) * g(b) equals
    :func:`product_table` on all 65536 pairs; else None."""
    fg = separable_transforms(mult.name)
    if fg is None:
        return None
    vals = _operand_values(operand_dtype)
    f, g = (t(vals.to(torch.int32)).to(torch.int64) for t in fg)
    lo, hi = (-128, 127) if operand_dtype == torch.int8 else (0, 255)
    if not all(lo <= int(t.min()) and int(t.max()) <= hi for t in (f, g)):
        return None
    table = product_table(mult, operand_dtype).to(torch.int64)
    if not mult.signed:
        table = table & 0xFFFF
    if not torch.equal((f[:, None] * g[None, :]).reshape(-1), table):
        return None
    return f, g


def route_of(mult: AxMult, operand_dtype: torch.dtype) -> str:
    """``"T"`` when ``mult`` is separable on ``operand_dtype`` (the tensor-
    core route), else ``"C"``; raises ``ValueError`` when the pair has no
    16-bit product table (neither route takes it)."""
    product_table(mult, operand_dtype)
    return "T" if fg_table(mult, operand_dtype) is not None else "C"


def fg_table(mult: AxMult, operand_dtype: torch.dtype, device="cpu") -> Optional[torch.Tensor]:
    """Route T's multiplier: (256,) int32 words ``f(v) & 0xFF | (g(v) &
    0xFF) << 8`` by byte pattern v, or None when ``mult`` is not separable
    on ``operand_dtype``.  Cached per multiplier, operand type and device."""
    def build_cpu():
        tabs = _separable_tables(mult, operand_dtype)
        return None if tabs is None else \
            ((tabs[0] & 0xFF) | ((tabs[1] & 0xFF) << 8)).to(torch.int32)

    device = torch.device(device)
    cpu = _cached(_FG, mult, (operand_dtype, torch.device("cpu")), build_cpu)
    if cpu is None or device.type == "cpu":
        return cpu
    return _cached(_FG, mult, (operand_dtype, device), lambda: cpu.to(device).contiguous())


class Plan(NamedTuple):
    """One launch's shape: ``tile`` m16 tiles per block (route T) or rows
    per thread (route C, with ``slots`` row slots of the 8 warps; the other
    warps split each K step); ``splits`` blocks share each output tile's K
    in ranges of whole 64-byte steps; ``atomic``: partial sums are added
    into a zeroed output."""
    route: str
    tile: int
    slots: int
    splits: int
    atomic: bool


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def plan(route: str, M: int, N: int, K: int, sms: int = 132) -> Plan:
    """The block shape and the split of K for an (M, K) @ (K, N) launch on
    a card with ``sms`` SMs: route T covers up to 128 rows per block (B is
    read once for M <= 128), route C up to 64; K is split until the grid
    holds about 4 x ``sms`` blocks (route T at 32 rows or fewer, 3 blocks
    per SM) or 2 x ``sms`` (otherwise), never below one step per split."""
    if route == "T":
        tile = min(8, _pow2_ceil(-(-M // 16)))
        slots, rows = 8, 16 * tile
        target = (4 if tile <= 2 else 2) * sms
    elif route == "C":
        slots = 8 if M >= 8 else _pow2_ceil(M)
        tile = min(8, _pow2_ceil(-(-M // 8))) if M >= 8 else 1
        rows = slots * tile
        target = 2 * sms
    else:
        raise ValueError(f"route must be one of {ROUTES}: {route!r}")
    steps = -(-K // K_STEP)
    tiles = -(-M // rows) * -(-N // BLOCK_N)
    splits = max(1, min(steps, -(-target // tiles)))
    splits = -(-steps // -(-steps // splits))       # no split without a step
    return Plan(route, tile, slots, splits, splits > 1 or slots < 8)


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
        n_ptr, n_int = (7, 19) if name == "ax_matmul" else (8, 16)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _C_FNS[name] = fn
    return fn


def _sms(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def launch_args(name: str, a, b, mult: AxMult, cfg_grid, swap_triple, bm: int, bn: int,
                bk: int, grid_order: str, tile_hist: bool, route: str, sms: int,
                stream=None):
    """Allocate the outputs and build the argument list of ``<name>_launch``
    for ``route``: returns (args, out, hist, work), ``work`` the histogram
    workspace, which must outlive the call.  Tensors stay where they are
    (the kernel takes device pointers); only :func:`plan`'s atomic sums
    need the output zeroed."""
    M, K = a.shape
    N = b.shape[1]
    pl = plan(route, M, N, K, sms)
    dev = a.device
    if route == "T":
        fg = fg_table(mult, a.dtype, dev)
        if fg is None:
            raise ValueError(f"route T takes separable multipliers: {mult.name} on "
                             f"{a.dtype} is not")
        table = None
    else:
        table, fg = product_table(mult, a.dtype, dev), None
    out = (torch.zeros if pl.atomic else torch.empty)((M, N), dtype=torch.int32, device=dev)
    hist = work = None
    hw = 0
    if tile_hist:
        hw = HIST_WIDTH(mult.bits)
        gm, gn = -(-M // bm), -(-N // bn)
        hist = torch.empty((gm, gn, 2, hw), dtype=torch.int32, device=dev)
        work = torch.zeros(((gm + gn) * 9,), dtype=torch.int32, device=dev)
    vec = int(K % 16 == 0 and N % 16 == 0 and a.data_ptr() % 16 == 0
              and b.data_ptr() % 16 == 0)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    ptrs = [a.data_ptr(), b.data_ptr(), ptr(table), ptr(fg)]
    if name == "ax_matmul_grid":
        ptrs.append(cfg_grid.data_ptr())
    ptrs += [out.data_ptr(), ptr(hist), ptr(work)]
    ints = [M, N, K, bm, bn, bk, int(a.dtype == torch.int8), int(mult.signed), *swap_triple,
            hw, int(grid_order == "nm"), ROUTES.index(route), pl.tile, pl.slots, pl.splits,
            int(pl.atomic), vec]
    return ptrs + ints + [stream], out, hist, work


def _launch(name: str, a, b, mult: AxMult, cfg_grid, swap_triple, bm: int, bn: int,
            bk: int, grid_order: str, tile_hist: bool, route: Optional[str]):
    """Launch ``<name>_launch`` on the current stream; shapes, types and
    devices are checked by the callers."""
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous operands")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    route = route or route_of(mult, a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        args, out, hist, _work = launch_args(name, a, b, mult, cfg_grid, swap_triple, bm,
                                             bn, bk, grid_order, tile_hist, route,
                                             _sms(a.device), stream)
        rc = _c_fn(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {rc} (route "
                           f"{route}, M={a.shape[0]} N={b.shape[1]} K={a.shape[1]} "
                           f"blocks={bm}x{bn}x{bk})")
    LAUNCHES[name] += 1
    return (out, hist) if tile_hist else out


def ax_matmul_cuda(a, b, mult: AxMult, swap: Optional[SwapConfig], *,
                   bm: int, bn: int, bk: int, grid_order: str = "mn",
                   tile_hist: bool = False, _route: Optional[str] = None):
    """Launch the static-swap CUDA kernel on the current stream (shapes
    already checked by :func:`ax_matmul_blocks`).  ``_route`` forces a
    route (tests only)."""
    return _launch("ax_matmul", a, b, mult, None, cfg_to_triple(swap), bm, bn, bk,
                   grid_order, tile_hist, _route)


def ax_matmul_grid_cuda(a, b, mult: AxMult, cfg_grid, *, bm: int, bn: int,
                        bk: int, grid_order: str = "mn", tile_hist: bool = False,
                        _route: Optional[str] = None):
    """Launch the grid CUDA kernel on the current stream; the grid goes by
    its device pointer (shapes already checked by
    :func:`ax_matmul_grid_blocks`).  ``_route`` forces a route (tests
    only)."""
    return _launch("ax_matmul_grid", a, b, mult, cfg_grid, (), bm, bn, bk, grid_order,
                   tile_hist, _route)


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
                     tile_hist: bool = False, _route: Optional[str] = None):
    """int32 (M, N) ``sum_k mult(swap(a[m, k], b[k, n]))`` over int8 or uint8
    operands with (bm, bn) output tiles and K steps of ``bk``; with
    ``tile_hist`` also the (ceil(M/bm), ceil(N/bn), 2, bits+1) int32 tile
    histogram.  K must be a multiple of ``bk`` (callers zero-pad K); ragged
    M and N edges are masked."""
    _check(a, b, bm, bn, bk, grid_order)
    if a.device.type == "cuda":
        return ax_matmul_cuda(a, b, mult, swap, bm=bm, bn=bn, bk=bk,
                              grid_order=grid_order, tile_hist=tile_hist, _route=_route)
    _require_cpu(a, b)
    return ax_matmul_plain(a, b, mult, swap, bm=bm, bn=bn, tile_hist=tile_hist)


def ax_matmul_grid_blocks(a, b, mult: AxMult, cfg_grid, *, bm: int, bn: int,
                          bk: int, grid_order: str = "mn", tile_hist: bool = False,
                          _route: Optional[str] = None):
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
                                   grid_order=grid_order, tile_hist=tile_hist,
                                   _route=_route)
    _require_cpu(a, b)
    return ax_matmul_grid_plain(a, b, mult, cfg_grid, bm=bm, bn=bn,
                                tile_hist=tile_hist)

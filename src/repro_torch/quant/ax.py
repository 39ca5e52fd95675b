"""SWAPPER approximate matmul as an LM projection (``repro.quant.ax``).

``ax_dense`` quantizes the activation rows and the weight columns to int8,
runs the approximate int8 matmul, and dequantizes; its backward is the
straight-through exact-matmul gradient.  Backends of ``ax_matmul_int``:

* ``kernel`` — ``kernels.ops.ax_matmul`` (the CUDA kernel on the card, its
  plain version on the CPU), with the JAX package's block padding;
* ``emul``   — the plain reference ``kernels.ref.ax_matmul_ref``;
* ``mxu``    — the separable families (``trunc*``, ``perf*``: m(a, b) =
  f(a) * g(b)) as one exact integer matmul over K-stacked limbs
  (``_stacked_mm``).  On the card that product is route T of the CUDA
  kernels (int8 tensor cores over the same limbs, built in shared memory);
  on the CPU the limbs are built here and multiplied once, in int64, and
  wrapped to int32 as JAX's int32 accumulation wraps.  A non-separable
  multiplier, a grid with more than one column tile, and a multiplier
  whose products on the operand type do not fit the kernel's 16-bit table
  (the unsigned families on int8 operands) raise ``ValueError`` on both
  devices.

The dynamic-config path of the adaptive runtime (``ax_dense_dyn``,
``ax_matmul_int_dyn[_hist]``) takes the swap decision as an int32 tensor on
the operands' device: a (3,) triple or a (gm, gn, 3) per-tile grid.  Its
``kernel`` and ``mxu`` backends run ``kernels.ops.ax_matmul_grid``, the CUDA
grid kernel, on the card: it reads the triples on the device, so a new
policy costs no rebuild and no host synchronise.

**Weights are quantized once.**  Under ``torch.no_grad``/``inference_mode``
``models.layers.dense`` takes a weight's compute-dtype cast and its int8
codes ``quantize_rows(w.to(dtype).float(), axis=0)`` from a cache
(:func:`weight_cast`, :func:`weight_codes`) instead of recomputing them per
call; the codes are bit-identical, since ``quantize_rows`` is
deterministic.  The cache is keyed on the tensor itself: a weak reference
(the entry goes when the weight does) checked against the tensor's storage
pointer, shape, stride and dtype, and against ``_version`` where the tensor
has one.  So a new tensor (``launch.serve.drift_hook`` returns new ones)
misses and is quantized again, an in-place update outside inference mode
misses, and nothing has to prepare the weights ahead.  A weight made or
changed in place under ``inference_mode`` has no readable version, so the
cache treats such weights as immutable, as the JAX package's functional
parameters are.  With gradients enabled nothing is cached: the
straight-through backward needs the cast of the live weight.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import AxPolicy
from repro_torch.core import multipliers as M
from repro_torch.core.multipliers import separable_transforms
from repro_torch.core.tiling import (largest_divisor_leq, rowtile_count,
                                     rowtile_index, rowtile_span)
from repro_torch.kernels.ax_matmul import route_of
from repro_torch.kernels.ops import ax_matmul, ax_matmul_grid
from repro_torch.kernels.ref import ax_matmul_ref, ax_matmul_tiles_ref
from repro_torch.kernels.schedule import MAX_BLOCK, KernelSchedule, resolve_for

__all__ = ["ax_dense", "ax_dense_dyn", "quantize_rows", "separable_transforms",
           "ax_matmul_int", "ax_matmul_int_dyn", "ax_matmul_int_dyn_hist",
           "ax_matmul_int_2mm", "ax_matmul_int_dyn_2mm", "weight_cast", "weight_codes",
           "weight_cache", "weight_cache_payloads", "WEIGHT_CACHE"]


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


def _resolve(a_i8, b_i8, backend: str, mult_name: str, op: str,
             schedule: Optional[KernelSchedule], caps: bool = True) -> KernelSchedule:
    """The dispatch's schedule from the logical shape before padding
    (``kernels.schedule.resolve_for``: explicit > installed table >
    defaults), under the JAX package's signature ops.

    An explicit schedule is taken as it is.  A table entry brings its launch
    knobs and grid order everywhere, but its caps only where ``caps`` (the
    static call, which has no ``tile_hist``): elsewhere the caps stay the
    defaults, so a table never changes the grid the controller wrote, the
    ``tile_hist`` layout or the telemetry.  Caps other than the defaults
    are lowered to divisors of the logical dims, so an entry never pads (a
    cached weight is not copied each step)."""
    sched = resolve_for(a_i8.shape, b_i8.shape, backend, mult_name, op, override=schedule)
    if schedule is not None:
        return sched
    if not caps:
        return dataclasses.replace(sched, bm=MAX_BLOCK, bn=MAX_BLOCK, bk=MAX_BLOCK)
    if (sched.bm, sched.bn, sched.bk) == (MAX_BLOCK,) * 3:
        return sched
    m0 = a_i8.numel() // max(1, a_i8.shape[-1])
    return dataclasses.replace(sched, bm=largest_divisor_leq(m0, sched.bm),
                               bn=largest_divisor_leq(b_i8.shape[-1], sched.bn),
                               bk=largest_divisor_leq(a_i8.shape[-1], sched.bk))


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


# ---------------------------------------------------------------------------
# the mxu backend: separable families as one K-stacked integer matmul
# ---------------------------------------------------------------------------

def _mxu_transforms(mult_name: str, operand_dtype: torch.dtype):
    """(f, g) of a separable multiplier the ``mxu`` backend takes on
    ``operand_dtype`` operands.  The guards hold on both devices: a
    non-separable multiplier raises (JAX asserts the same), and so does a
    pair whose products do not fit 16 bits or whose f/g do not fit the
    operand type, which route T of the kernel cannot take (the unsigned
    families on int8 operands; no JAX path uses such a pair)."""
    sep = separable_transforms(mult_name)
    if sep is None:
        raise ValueError(f"{mult_name} is not separable; use backend='kernel'")
    try:
        route = route_of(M.get(mult_name), operand_dtype)
    except ValueError as e:
        raise ValueError(f"backend='mxu' refuses {mult_name} on {operand_dtype} "
                         f"operands: {e}") from e
    if route != "T":
        raise ValueError(f"backend='mxu' refuses {mult_name} on {operand_dtype} "
                         f"operands: f and g do not fit the operand type")
    return sep


def _mm64(a, b):
    return torch.matmul(a.to(torch.int64), b.to(torch.int64))


def _int_mm(a, b):
    """Exact integer matmul with int32 accumulation that wraps mod 2^32,
    as JAX's int8 ``dot_general`` with ``preferred_element_type=int32``:
    accumulated in int64 (CPU int32 overflow is no contract), then
    wrapped."""
    return _mm64(a, b).to(torch.int32)


def _stacked_mm(*limbs):
    """``sum_i Xi @ Yi`` as ONE integer matmul over a concatenated inner
    dimension: ``[X1|X2|...] @ [Y1;Y2;...]`` (``limbs`` alternates Xi,
    Yi); exact, so bit-identical to the sum of the products."""
    x = torch.cat(limbs[0::2], dim=-1)
    y = torch.cat(limbs[1::2], dim=0)
    return _int_mm(x, y)


def _swap_mask(x_i32, bit, value):
    return ((x_i32 >> bit) & 1) == value


def _i8(t):
    return t.to(torch.int8)


def _mxu_limbs(ai, bi, f, g, swap):
    """The (X1, Y1, X2, Y2) int8 limbs of the static swap factorization."""
    if swap.operand == "A":
        s = _swap_mask(ai, swap.bit, swap.value).to(torch.int32)
        return _i8(s * g(ai)), _i8(f(bi)), _i8((1 - s) * f(ai)), _i8(g(bi))
    s = _swap_mask(bi, swap.bit, swap.value).to(torch.int32)
    return _i8(g(ai)), _i8(s * f(bi)), _i8(f(ai)), _i8((1 - s) * g(bi))


def _mxu_limbs_dyn(ai, bi, f, g, op_is_a, bit, value):
    """The (X1, Y1, X2, Y2) limbs with the swap decision as int32 tensors:
    with row mask sa (decision on A) and column mask sb (decision on B),
    each gated by ``op_is_a``, ``X1 @ Y1 + X2 @ Y2`` equals the A-form or
    the B-form static factorization for every triple; value 2 (NoSwap)
    matches no bit, so one limb is zero and the sum is ``f(A) @ g(B)``."""
    is_a = op_is_a == 1
    sa = (_swap_mask(ai, bit, value) & is_a).to(torch.int32)
    sb = (_swap_mask(bi, bit, value) & ~is_a).to(torch.int32)
    x1 = _i8(torch.where(is_a, sa * g(ai), g(ai)))
    y1 = _i8(torch.where(is_a, f(bi), sb * f(bi)))
    x2 = _i8(torch.where(is_a, (1 - sa) * f(ai), f(ai)))
    y2 = _i8(torch.where(is_a, g(bi), (1 - sb) * g(bi)))
    return x1, y1, x2, y2


def _mxu_limbs_rowtile(ai, bi, f, g, row_triples, b_rep):
    """K-stacked limbs with a per-row swap decision (``row_triples`` (M, 3)
    int32, one triple per row of the 2-D ``ai``; ``b_rep`` the grid's one
    B-side triple, :func:`_bside_representative`).  A-side and NoSwap rows
    ride the A-form pair; live B-side rows the B-form pair with the
    representative's column mask; the four pairs stack over a 4K inner
    dimension (``repro.quant.ax._mxu_limbs_rowtile``)."""
    op, bit, value = row_triples[:, 0:1], row_triples[:, 1:2], row_triples[:, 2:3]
    is_b = (op == 0) & (value <= 1)
    sa = (_swap_mask(ai, bit, value) & (op == 1)).to(torch.int32)
    ib = is_b.to(torch.int32)
    ia = 1 - ib
    sb = _swap_mask(bi, b_rep[1], b_rep[2]).to(torch.int32)
    return (_i8(sa * g(ai)), _i8(f(bi)), _i8(ia * (1 - sa) * f(ai)), _i8(g(bi)),
            _i8(ib * g(ai)), _i8(sb * f(bi)), _i8(ib * f(ai)), _i8((1 - sb) * g(bi)))


def _bside_representative(flat_triples):
    """The grid's B-side triple: the first live B-side row (``set_tile_grid``
    allows at most one distinct B-side triple per grid); any row when there
    is none, whose mask the all-zero B-side indicator then gates out."""
    is_b = (flat_triples[:, 0] == 0) & (flat_triples[:, 2] <= 1)
    first = torch.argmax(is_b.to(torch.int32)).reshape(1)
    return flat_triples.index_select(0, first)[0]            # no host read


def _mxu_dyn_scalar(ai, bi, f, g, dyn):
    """The mxu product of a (3,) triple: the stacked 2K form for every
    triple, NoSwap included (the port's schedule has no ``limbs`` or
    ``noswap_fast`` knob: the 2-matmul form is the oracle
    :func:`ax_matmul_int_dyn_2mm`)."""
    return _stacked_mm(*_mxu_limbs_dyn(ai, bi, f, g, dyn[0], dyn[1], dyn[2]))


def _mxu_row_grid(dyn):
    """A (gm, 1, 3) row-tile grid as the kernel applies it for ``mxu``: live
    B-side rows take the representative B-side triple and rows of another
    operand code NoSwap, so route T computes exactly the rows of
    :func:`_mxu_limbs_rowtile`, mixed B-side grids included."""
    flat = dyn[:, 0, :]
    op, value = flat[:, 0:1], flat[:, 2:3]
    noswap = torch.zeros_like(flat)
    noswap[:, 0] = 1
    noswap[:, 2] = 2
    rows = torch.where((op == 0) & (value <= 1), _bside_representative(flat)[None, :],
                       torch.where(op == 1, flat, noswap))
    return rows[:, None, :].contiguous()


def _kernel_static(a_i8, b_i8, mult, swap, sched: KernelSchedule):
    a2d, bp, lead, m0, n0, (bm, bn, bk) = _pad_for_kernel(a_i8, b_i8, sched)
    out = ax_matmul(a2d, bp, mult, swap,
                    schedule=dataclasses.replace(sched, bm=bm, bn=bn, bk=bk))
    return out[:m0, :n0].reshape(*lead, n0)


def ax_matmul_int(a_i8, b_i8, policy: AxPolicy,
                  schedule: Optional[KernelSchedule] = None) -> torch.Tensor:
    """Approximate int matmul (..., K) @ (K, N) -> (..., N) int32.  The
    schedule resolves as ``_resolve`` says, under op "matmul" (``kernel``)
    or "int_static" (``mxu``)."""
    mult = M.get(policy.mult_name)
    swap = policy.swap
    if policy.backend == "kernel":
        return _kernel_static(a_i8, b_i8, mult, swap,
                              _resolve(a_i8, b_i8, "kernel", policy.mult_name, "matmul",
                                       schedule))
    if policy.backend == "emul":
        lead = a_i8.shape[:-1]
        a2d = a_i8.reshape(-1, a_i8.shape[-1])
        return ax_matmul_ref(a2d, b_i8, mult, swap).reshape(*lead, b_i8.shape[-1])
    if policy.backend == "mxu":
        sched = _resolve(a_i8, b_i8, "mxu", policy.mult_name, "int_static", schedule)
        f, g = _mxu_transforms(policy.mult_name, a_i8.dtype)
        if a_i8.device.type == "cuda":          # route T: the same limbs
            return _kernel_static(a_i8, b_i8, mult, swap, sched)
        ai, bi = a_i8.to(torch.int32), b_i8.to(torch.int32)
        if swap is None:
            return _int_mm(_i8(f(ai)), _i8(g(bi)))
        return _stacked_mm(*_mxu_limbs(ai, bi, f, g, swap))
    raise ValueError(f"unknown backend {policy.backend!r}")


def ax_matmul_int_2mm(a_i8, b_i8, policy: AxPolicy) -> torch.Tensor:
    """The 2-matmul mxu factorization ``X1 @ Y1 + X2 @ Y2``, the
    bit-identity oracle of the stacked form (``mxu`` only)."""
    if policy.backend != "mxu":
        raise ValueError(f"ax_matmul_int_2mm is the mxu oracle: {policy.backend!r}")
    f, g = _mxu_transforms(policy.mult_name, a_i8.dtype)
    ai, bi = a_i8.to(torch.int32), b_i8.to(torch.int32)
    if policy.swap is None:
        return _int_mm(_i8(f(ai)), _i8(g(bi)))
    x1, y1, x2, y2 = _mxu_limbs(ai, bi, f, g, policy.swap)
    return (_mm64(x1, y1) + _mm64(x2, y2)).to(torch.int32)


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
                         schedule=dataclasses.replace(sched, bm=bm, bn=bn, bk=bk))
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
    plain reference for both.  ``mxu`` takes a triple or a row-tile grid
    (gn must be 1): on the CPU the stacked limbs (2K deep for a triple, 4K
    for a grid), on the card route T of the grid kernel.  The schedule
    resolves under op "matmul_grid" (``kernel``) or "int_dyn" (``mxu``),
    with the default caps (``_resolve``)."""
    mult = M.get(policy.mult_name)
    dyn = _as_dyn(dyn, a_i8.device)
    tiled = dyn.dim() == 3
    if policy.backend == "mxu":
        f, g = _mxu_transforms(policy.mult_name, a_i8.dtype)
        if tiled and dyn.shape[1] != 1:
            raise ValueError(f"mxu per-tile grids are row-granular (gn must be 1, got "
                             f"{tuple(dyn.shape)}); use backend='kernel' for column tiles")
        if a_i8.device.type == "cuda":
            return _kernel_grid(a_i8, b_i8, mult, _mxu_row_grid(dyn) if tiled else dyn,
                                _resolve(a_i8, b_i8, "mxu", policy.mult_name, "int_dyn",
                                         schedule, caps=False))
        ai, bi = a_i8.to(torch.int32), b_i8.to(torch.int32)
        if not tiled:
            _resolve(a_i8, b_i8, "mxu", policy.mult_name, "int_dyn", schedule, caps=False)
            return _mxu_dyn_scalar(ai, bi, f, g, dyn)
        lead = a_i8.shape[:-1]
        a2 = ai.reshape(-1, ai.shape[-1])
        idx = torch.from_numpy(rowtile_index(a2.shape[0], dyn.shape[0])).to(dyn.device)
        row_triples = dyn[:, 0, :].index_select(0, idx)
        out = _stacked_mm(*_mxu_limbs_rowtile(a2, bi, f, g, row_triples,
                                              _bside_representative(dyn[:, 0, :])))
        return out.reshape(*lead, b_i8.shape[-1])
    if policy.backend == "kernel":
        return _kernel_grid(a_i8, b_i8, mult, dyn,
                            _resolve(a_i8, b_i8, "kernel", policy.mult_name, "matmul_grid",
                                     schedule, caps=False))
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
    raise ValueError(f"unknown backend {policy.backend!r}")


def _kernel_grid(a_i8, b_i8, mult, dyn, sched: KernelSchedule):
    """The grid kernel for a (3,) triple (broadcast to every block) or a
    (gm, gn, 3) grid (gathered onto tile-aligned blocks)."""
    if dyn.dim() == 3:
        return _kernel_grid_tiled(a_i8, b_i8, mult, dyn, sched)
    a2d, bp, lead, m0, n0, (bm, bn, bk) = _pad_for_kernel(a_i8, b_i8, sched)
    grid = dyn.expand(a2d.shape[0] // bm, bp.shape[1] // bn, 3).contiguous()
    out = ax_matmul_grid(a2d, bp, mult, grid,
                         schedule=dataclasses.replace(sched, bm=bm, bn=bn, bk=bk))
    return out[:m0, :n0].reshape(*lead, n0)


def ax_matmul_int_dyn_2mm(a_i8, b_i8, policy: AxPolicy, dyn) -> torch.Tensor:
    """The 2-matmul dynamic mxu factorization of a (3,) triple, the
    bit-identity oracle of the stacked form (``mxu`` only)."""
    if policy.backend != "mxu":
        raise ValueError(f"ax_matmul_int_dyn_2mm is the mxu oracle: {policy.backend!r}")
    f, g = _mxu_transforms(policy.mult_name, a_i8.dtype)
    dyn = _as_dyn(dyn, a_i8.device)
    ai, bi = a_i8.to(torch.int32), b_i8.to(torch.int32)
    x1, y1, x2, y2 = _mxu_limbs_dyn(ai, bi, f, g, dyn[0], dyn[1], dyn[2])
    return (_mm64(x1, y1) + _mm64(x2, y2)).to(torch.int32)


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
    sched = _resolve(a_i8, b_i8, "kernel", policy.mult_name, "matmul_grid", schedule,
                     caps=False)
    return _kernel_grid_tiled(a_i8, b_i8, M.get(policy.mult_name), dyn, sched,
                              tile_hist=True)


# ---------------------------------------------------------------------------
# the projection layer and the weight cache (module note)
# ---------------------------------------------------------------------------

class _WeightEntry:
    """What the cache holds for one weight tensor: the identity checks and
    the derived tensors, keyed ``("cast", dtype)`` and ``("codes", dtype)``."""

    __slots__ = ("ref", "sig", "version", "derived")

    def __init__(self, ref, sig, version):
        self.ref, self.sig, self.version, self.derived = ref, sig, version, {}


WEIGHT_CACHE: Dict[str, object] = {"enabled": True, "hits": 0, "misses": 0}
_ENTRIES: Dict[int, _WeightEntry] = {}


def _sig(w: torch.Tensor):
    return (w.data_ptr(), tuple(w.shape), w.stride(), w.dtype, w.device)


def _version(w: torch.Tensor):
    return None if w.is_inference() else w._version


def _drop(key: int, entry: _WeightEntry, entries=_ENTRIES):
    def cb(_ref):
        if entries.get(key) is entry:
            del entries[key]
    return cb


def _cached(w: torch.Tensor, key, build):
    """``build()`` for ``w`` under ``key``, from the cache when it is on,
    gradients are off and ``w`` is the tensor the entry was made for."""
    if not WEIGHT_CACHE["enabled"] or torch.is_grad_enabled():
        return build()
    entry = _ENTRIES.get(id(w))
    if entry is None or entry.ref() is not w or entry.sig != _sig(w) \
            or entry.version != _version(w):
        entry = _WeightEntry(None, _sig(w), _version(w))
        entry.ref = weakref.ref(w, _drop(id(w), entry))
        _ENTRIES[id(w)] = entry
    hit = entry.derived.get(key)
    if hit is None:
        WEIGHT_CACHE["misses"] += 1
        hit = entry.derived[key] = build()
    else:
        WEIGHT_CACHE["hits"] += 1
    return hit


def weight_cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w.to(dtype)``, made once per weight under no-grad (module note)."""
    if w.dtype == dtype:
        return w
    return _cached(w, ("cast", dtype), lambda: w.to(dtype))


def weight_codes(w: torch.Tensor, dtype: torch.dtype):
    """``quantize_rows(w.to(dtype).float(), axis=0)`` -> (int8 codes,
    f32 column scales): the weight quantized as ``dense`` feeds it to the
    approximate matmul, made once per weight under no-grad."""
    return _cached(w, ("codes", dtype),
                   lambda: quantize_rows(w.to(dtype).to(torch.float32), axis=0))


def weight_cache_payloads(tensors):
    """Every cached tensor derived from ``tensors`` (a CUDA graph that read
    them keeps them alive with this list)."""
    out = []
    for w in tensors:
        if not torch.is_tensor(w):
            continue
        entry = _ENTRIES.get(id(w))
        if entry is not None and entry.ref() is w:
            for v in entry.derived.values():
                out.extend(v if isinstance(v, tuple) else (v,))
    return out


@contextlib.contextmanager
def weight_cache(enabled: bool):
    """Turn the weight cache on or off inside a block (off: every call
    casts and quantizes its weights, as the JAX package's steps do)."""
    prev = WEIGHT_CACHE["enabled"]
    WEIGHT_CACHE["enabled"] = bool(enabled)
    try:
        yield
    finally:
        WEIGHT_CACHE["enabled"] = prev


def _ax_dense_fwd_impl(x, w, policy: AxPolicy, wcodes=None):
    xq, sx = quantize_rows(x.to(torch.float32), axis=-1)
    wq, sw = wcodes if wcodes is not None else quantize_rows(w.to(torch.float32), axis=0)
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
    def forward(ctx, x, w, policy, wcodes):
        ctx.save_for_backward(x, w)
        return _ax_dense_fwd_impl(x, w, policy, wcodes)

    @staticmethod
    def backward(ctx, gy):
        return (*_ste_grads(ctx, gy), None, None)


def ax_dense(x, w, policy: AxPolicy, wcodes=None):
    """y = x @ w through the SWAPPER approximate path (quantize -> ax matmul
    -> dequantize); straight-through exact gradients.  ``wcodes`` — the
    weight's ``quantize_rows(w.float(), axis=0)`` when the caller has it
    (:func:`weight_codes`)."""
    return _AxDense.apply(x, w, policy, wcodes)


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


def ax_dense_dyn(x, w, policy: AxPolicy, dyn, scope=None, target: str = "",
                 wcodes=None):
    """``ax_dense`` with the swap decision as a run-time int32 tensor (the
    adaptive runtime's path): ``dyn`` is a (3,) triple, or a (gm, 1, 3)
    per-row-tile grid when the scope runs in tile mode.

    ``quantize_rows`` of the activations runs once; its codes feed both the
    telemetry and the matmul (the weight's come from ``wcodes`` when the
    caller has them).  When ``scope`` observes this step
    (``scope.observing``) the call records ``operand_summary`` under
    ``target`` (its live-policy error sample uses ``dyn[0, 0]`` when
    ``dyn`` is a grid), and in tile mode a ``tile_summary`` under
    ``tile_key(target)``.  With ``scope.kernel_hist``, the kernel backend
    and a grid ``dyn``, the tile bit counts come out of the matmul kernel
    itself (``_DynHistCore``) instead of a sampled pass.  A step the scope
    does not observe computes no summary at all."""
    xq, sx = quantize_rows(x.to(torch.float32), axis=-1)
    wq, sw = wcodes if wcodes is not None else quantize_rows(w.to(torch.float32), axis=0)
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

"""``tuning_sweep``: the component-level SWAPPER tuning sweep.

Replaces the Pallas TPU kernel ``tuning_sweep_pallas`` of
``src/repro/kernels/tuning_sweep.py`` with the hand-written CUDA C++ kernel
``csrc/tuning_sweep.cu`` (built for ``sm_90a`` by ``_build.py``).  Over the
full ``vals x vals`` grid it returns six per-a row statistics of the error
surfaces E0 = |m(a,b) - ab|, E1 = |m(b,a) - ab| and min(E0, E1), as
``{surf: {stat: (N,) tensor}}`` for surf in :data:`SURF_NAMES` and stat in
:data:`STAT_NAMES`: ``lo``/``hi``/``mx`` uint32 lanes (int64 tensors in
[0, 2^32), the port's lane convention), ``cnt`` int32, ``sq``/``rel``
float32.  On an H100 it is bounded by operations (:func:`pair_ops`).
A block of the kernel owns ``2^rshift`` rows and splits the columns among
the rest of its 256 threads; :func:`plan` picks ``rshift`` from N and the
card's SM count.

The multiplier reaches the kernel as its descriptor (``AxMult.desc``):
family code and two parameters at launch, and for ``lut`` its table in
device memory.  A multiplier without a descriptor (``oracle_mult``,
``swapped_mult``) raises on a CUDA tensor.

:func:`tuning_sweep` launches the kernel for a CUDA tensor and runs the
plain PyTorch version (``kernels/ref.py::tuning_sweep_ref``) for a CPU
tensor, with no fallback from one to the other.  ``LAUNCHES`` counts the
kernel's launches (apart from ``ax_matmul.LAUNCHES``, whose keys the serve
phases of ``chip_smoke.py`` compare as a whole).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.multipliers import AxMult
from repro_torch.core.tuning import STAT_NAMES, SURF_NAMES

from . import _build
from .ref import tuning_sweep_ref

__all__ = ["tuning_sweep", "tuning_sweep_cuda", "tuning_sweep_plain", "pair_ops", "plan",
           "instance", "STAT_NAMES", "SURF_NAMES", "FAMILIES", "MAX_N", "LAUNCHES",
           "reset_launches"]

LAUNCHES: Dict[str, int] = {"tuning_sweep": 0}
FAMILIES = {"exact": 0, "trunc": 1, "perforate": 2, "broken_array": 3, "mitchell": 4,
            "drum": 5, "lut": 6}
MAX_N = 1 << 16          # a row's limb sum stays below 2^32
MAX_RSHIFT = 5           # at most 32 rows a block, one warp's width
_TABLES: Dict[Tuple, torch.Tensor] = {}
_C_FNS: Dict[str, object] = {}


def reset_launches() -> None:
    LAUNCHES["tuning_sweep"] = 0


# the plain PyTorch version (any device): ``kernels/ref.py::tuning_sweep_ref``
tuning_sweep_plain = tuning_sweep_ref


def _c_fn():
    """The built library's ``tuning_sweep_launch``, typed."""
    fn = _C_FNS.get("launch")
    if fn is None:
        fn = _build.load("tuning_sweep").tuning_sweep_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _C_FNS["launch"] = fn
    return fn


def plan(n: int, sms: int) -> int:
    """``rshift`` of a sweep over ``n`` values on a card of ``sms`` SMs: a
    block owns ``2^rshift`` rows, the most (up to 32) that still gives the
    grid at least two blocks per SM, and one row when none does."""
    for rshift in range(MAX_RSHIFT, 0, -1):
        if -(-n >> rshift) >= 2 * sms:
            return rshift
    return 0


_TYPES = {"exact": "Exact", "trunc": "Trunc", "perforate": "Perforate",
          "broken_array": "BrokenArray", "mitchell": "Mitchell", "drum": "Drum", "lut": "Lut"}


def instance(mult: AxMult) -> str:
    """The family type of ``csrc/ax_families.cuh`` whose kernel a sweep of
    ``mult`` launches, as ``axf::dispatch`` picks it from the descriptor:
    ``Trunc<true>``, ``BrokenArray<true, 3>`` (its masked rows), ``Exact``
    (one type for both signednesses)."""
    if mult.desc is None:
        raise ValueError(f"{mult.name} has no kernel descriptor")
    family, bits, signed, params = mult.desc
    name = _TYPES[family]
    if family == "exact":
        return name
    s = "true" if signed else "false"
    if family == "broken_array":
        v, h = params
        return f"{name}<{s}, {max(0, min(v, bits) - h)}>"
    return f"{name}<{s}>"


def _kernel_args(mult: AxMult, device) -> Tuple[int, int, int, object]:
    """(family code, p0, p1, table or None) of the multiplier's descriptor."""
    if mult.desc is None:
        raise ValueError(f"{mult.name} has no kernel descriptor: the sweep kernel "
                         f"evaluates closed-form and LUT multipliers only")
    family, bits, signed, params = mult.desc
    if (bits, signed) != (mult.bits, mult.signed) or family not in FAMILIES:
        raise ValueError(f"{mult.name}: bad kernel descriptor {mult.desc[:3]}")
    if family != "lut":
        p = tuple(params) + (0, 0)
        return FAMILIES[family], int(p[0]), int(p[1]), None
    key = (mult.desc, device)
    tbl = _TABLES.get(key)
    if tbl is None:
        raw = torch.frombuffer(bytearray(params[0]), dtype=torch.int32)
        if raw.numel() != 65536:
            raise ValueError(f"{mult.name}: a LUT has 65536 entries, not {raw.numel()}")
        tbl = _TABLES[key] = raw.to(device)
    return FAMILIES["lut"], 0, 0, tbl


def tuning_sweep_cuda(mult: AxMult, vals: torch.Tensor) -> dict:
    """Launch the CUDA kernel on the current stream (``vals`` already
    checked by :func:`tuning_sweep`)."""
    family, p0, p1, table = _kernel_args(mult, vals.device)
    n = vals.numel()
    sms = torch.cuda.get_device_properties(vals.device).multi_processor_count
    u = torch.empty((3, 3, n), dtype=torch.int64, device=vals.device)
    cnt = torch.empty((3, n), dtype=torch.int32, device=vals.device)
    f = torch.empty((3, 2, n), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = _c_fn()(vals.data_ptr(), table.data_ptr() if table is not None else None,
                     u.data_ptr(), cnt.data_ptr(), f.data_ptr(), n, mult.bits,
                     int(mult.signed), family, p0, p1, plan(n, sms), stream)
    if rc != 0:
        raise RuntimeError(f"tuning_sweep kernel launch failed with cudaError {rc} "
                           f"({mult.name}, N={n})")
    LAUNCHES["tuning_sweep"] += 1
    return {surf: dict(lo=u[k, 0], hi=u[k, 1], mx=u[k, 2], cnt=cnt[k],
                       sq=f[k, 0], rel=f[k, 1])
            for k, surf in enumerate(SURF_NAMES)}


def tuning_sweep(mult: AxMult, vals: torch.Tensor) -> dict:
    """Row statistics of the full ``vals x vals`` sweep (module docstring).
    ``vals`` is a contiguous 1-D int32 tensor of 1..65536 operand values in
    any order, each in the multiplier's range (as
    ``core/tuning.py::operand_values`` gives them).  The kernel's closed
    forms assume that range and the wrapper does not check it, which would
    cost a host synchronisation per launch; the plain version takes any
    int32."""
    if vals.dim() != 1 or vals.dtype != torch.int32 or not vals.is_contiguous():
        raise ValueError(f"tuning_sweep takes a contiguous 1-D int32 tensor: "
                         f"{vals.dtype} {tuple(vals.shape)}")
    if not 0 < vals.numel() <= MAX_N:
        raise ValueError(f"tuning_sweep takes 1..{MAX_N} values, not {vals.numel()}")
    if vals.device.type == "cuda":
        return tuning_sweep_cuda(mult, vals)
    if vals.device.type != "cpu":
        raise ValueError(f"tuning_sweep runs on cuda or cpu tensors, not {vals.device}")
    return tuning_sweep_plain(mult, vals)


def pair_ops(mult: AxMult) -> Tuple[int, int, int]:
    """Operations of the sweep, counted from the multiplier family's
    definition (``core/multipliers.py``) in its least form, the same count
    whatever implements it, as (integer ops per (a, b) pair, float ops per
    pair, integer ops per operand value).  A sweep over N values does N^2
    times the first two and N times the third: work that depends on one
    operand only (its sign-magnitude envelope, msb, segment or fraction,
    masks) is done once per value.  Per pair: two multiplier evaluations,
    the exact product, two absolute errors (subtract both ways, compare,
    select), the minimum, and per surface the integer stats (mask, add;
    shift, add; max; compare, add) and the float ones (convert, multiply,
    add; divide, add), plus the shared |ab| (convert, absolute value for
    signed, max)."""
    pair, operand = _mult_ops(mult)
    return 2 * pair + 1 + 2 * 4 + 1 + 3 * 7, 3 * 5 + 2 + int(mult.signed), operand


def _mult_ops(mult: AxMult) -> Tuple[int, int]:
    """Integer operations of one evaluation m(x, y) of ``mult``, as (ops
    on both operands, ops on x plus ops on y).  A value takes the role of x
    in one evaluation and of y in the other, so the second number is also
    the per-value work of a sweep.  The sign-magnitude envelope costs
    compare, negate and select per operand in each role; where the core is
    a product mod 2^32 the sign folds into a per-value factor, else the
    product takes xor, xor and subtract per pair."""
    family, bits, signed, params = mult.desc
    if family == "exact":
        return 1, 0                                 # multiply
    if family == "lut":
        return 2, 3                                 # or, load; 2 masks, shift
    sign_pair = 0
    if family == "trunc":
        pair, operand = 1, 2                        # multiply; a mask each
    elif family == "perforate":
        pair, operand = 1, 1                        # multiply; mask of y
    elif family == "broken_array":
        # rows i >= v keep x << i whole and sum to one multiply by y's high
        # part; each of the R = max(0, min(v, bits) - h) masked rows is an
        # and of y's bit and a multiply-add (the rows' sum takes y's sign
        # by one more multiply); per operand a mask and a shift of x per
        # masked row, y's high part (mask) and low part (shift)
        v, h = params
        rows = max(0, min(v, bits) - h)
        pair, operand, sign_pair = 1 + 2 * rows, 2 * rows + 2, 1
    elif family == "mitchell":
        # per operand: max, clz, sub, shift, sub, shift, shift, zero select
        # (+ mask if t > 0); then add, shift, add, add, or, max, negate,
        # max, shift, shift (a zero operand shifts the product out)
        pair, operand, sign_pair = 10, 2 * 8 + sum(1 for t in params if t > 0), 3
    else:                                           # drum
        # per operand: max, clz, sub, sub, max, shift, compare, or, select,
        # zero test; then multiply, add, shift (a zero segment is 0)
        pair, operand = 3, 2 * 10
    return (pair + sign_pair, operand + 6) if signed else (pair, operand)

"""Eq. 6 of the paper (``repro.core.modular``): the 32-bit Q16.16 multiply
composed from 16-bit multiplies,

    A*B = AH*BH*2^32 (HI) + (AH*BL + AL*BH)*2^16 (MD) + AL*BL (LO),

with 16-bit signed (mul16s) multipliers in the approximated parts; MD and
LO operands are shifted right by one to fit the signed range and the
partial products shifted back (``lsb_fix`` re-adds the lost rows, beyond
the paper).  The Q16.16 result is bits [16:48) of the product,
``(HI << 16) + MD + (LO >> 16)`` mod 2^32.

Operands and results are int32 tensors (wrapping like JAX's int32); the
parts are uint32 lanes in int64 (:mod:`repro_torch.core.lanes`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .lanes import M32, s32, shl, u32
from .multipliers import AxMult
from .swapper import SwapConfig, apply_swapper, apply_swapper_dyn

__all__ = ["AxMul32Config", "PART_ALL", "PART_MD_LO", "PART_NONE", "ax_fxp_mul",
           "ax_fxp_mul_dyn"]

PART_ALL = ("HI", "MD", "LO")
PART_MD_LO = ("MD", "LO")
PART_NONE = ()


@dataclasses.dataclass(frozen=True)
class AxMul32Config:
    """Which 16-bit partial products are approximated, with which multiplier,
    and which SWAPPER configuration (None = NoSwap)."""

    mult: AxMult                       # 16-bit signed multiplier
    parts: tuple = PART_MD_LO          # subset of {"HI", "MD", "LO"}
    swap: Optional[SwapConfig] = None
    lsb_fix: bool = False              # beyond-paper LSB-row restoration

    def __post_init__(self):
        if self.mult.bits != 16 or not self.mult.signed:
            raise ValueError(f"Eq. 6 takes a 16-bit signed multiplier: {self.mult.name}")


def _ax(cfg: AxMul32Config, a, b, dyn):
    """One 16-bit part through the multiplier: its int32 value in int64."""
    if dyn is not None:
        return s32(apply_swapper_dyn(cfg.mult, a, b, *dyn))
    return s32(apply_swapper(cfg.mult, a, b, cfg.swap))


def _mul32_body(A, B, cfg: Optional[AxMul32Config], dyn):
    A, B = torch.broadcast_tensors(A.to(torch.int64), B.to(torch.int64))
    AH, AL = A >> 16, A & 0xFFFF      # high signed 16, low unsigned 16
    BH, BL = B >> 16, B & 0xFFFF
    parts = cfg.parts if cfg is not None else PART_NONE
    fix = cfg.lsb_fix if cfg is not None else False

    # the approximated parts' operand pairs go through the multiplier in one
    # stacked call (elementwise, so the same bits as one call per part)
    names = [k for k in ("HI", "MD1", "MD2", "LO") if k[:2] in parts]
    ax = {}
    if names:
        pairs = {"HI": (AH, BH), "MD1": (AH, BL >> 1), "MD2": (BH, AL >> 1),
                 "LO": (AL >> 1, BL >> 1)}
        prods = _ax(cfg, torch.stack([pairs[k][0] for k in names]),
                    torch.stack([pairs[k][1] for k in names]), dyn)
        ax = {k: u32(p) for k, p in zip(names, prods.unbind(0))}

    # HI: signed x signed, the native mul16s domain
    hi = ax["HI"] if "HI" in parts else u32(AH * BH)

    # MD: signed x unsigned
    if "MD" in parts:
        md1 = shl(ax["MD1"], 1)
        md2 = shl(ax["MD2"], 1)
        if fix:  # AH*BL = 2*AH*(BL>>1) + AH*(BL&1)
            md1 = md1 + u32(torch.where((BL & 1) != 0, AH, 0))
            md2 = md2 + u32(torch.where((AL & 1) != 0, BH, 0))
    else:
        md1 = u32(AH * BL)
        md2 = u32(BH * AL)

    # LO: unsigned x unsigned
    if "LO" in parts:
        lo = shl(ax["LO"], 2)
        if fix:  # AL*BL = 4ab + rb*(AL&~1) + ra*(BL&~1) + (ra & rb)
            ra, rb = AL & 1, BL & 1
            lo = (lo + torch.where(rb != 0, AL & ~1, 0) + torch.where(ra != 0, BL & ~1, 0)
                  + (ra & rb))
    else:
        lo = AL * BL
    # Q16.16 recombination: (product >> 16) mod 2^32
    res = shl(hi, 16) + md1 + md2 + ((lo & M32) >> 16)
    return s32(res).to(torch.int32)


def ax_fxp_mul(A, B, cfg: Optional[AxMul32Config] = None):
    """Q16.16 fixed-point multiply via Eq. 6 (int32 tensors).  ``cfg=None``
    (or empty parts) is bit-exact against the int64 product."""
    return _mul32_body(A, B, cfg, None)


def ax_fxp_mul_dyn(A, B, cfg: AxMul32Config, op_is_a, bit, value):
    """The multiply with the SWAPPER (op_is_a, bit, value) triple as run-time
    values (0-d tensors on the operands' device), for the
    application-level tuner."""
    return _mul32_body(A, B, cfg, (op_is_a, bit, value))

"""Bit-accurate approximate multiplier (AxIC) families on integer tensors.

The same six closed-form families as ``repro.core.multipliers`` —
operand truncation, partial-product perforation, broken array, Mitchell
logarithmic, DRUM — plus the LUT-defined multiplier and the 90-entry
``REGISTRY``, bit for bit.

Conventions: operands are M-bit integers in any integer tensor (their int32
value counts).  ``fn(a, b)`` returns an int64 tensor holding the product's
lane value — the int32 value for signed members, ``[0, 2^32)`` for unsigned
ones (see :mod:`repro_torch.core.lanes`).  Signed members use the same
sign-magnitude envelope around the unsigned core.

Every closed-form member and every LUT multiplier also carries a *kernel
descriptor* ``desc = (family, bits, signed, params)``: a hashable statement
of the circuit that a CUDA kernel evaluates in device code (the sweep
kernel, ``kernels/csrc/tuning_sweep.cu``), where Pallas traced ``fn``.  The
families and their params: ``exact`` ``()``; ``trunc`` ``(ka, kb)``;
``perforate`` ``(rowmask,)``; ``broken_array`` ``(v, h)``; ``mitchell``
``(ta, tb)``; ``drum`` ``(ka, kb)``; ``lut`` ``(table_bytes,)``, the
65536 int32 lanes in little-endian order.  A multiplier built from another
one's ``fn`` (``oracle_mult``, ``swapped_mult``) has ``desc=None``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .lanes import M32, msb, s32, shl, shr, u32

__all__ = [
    "AxMult",
    "exact",
    "trunc",
    "perforate",
    "broken_array",
    "mitchell",
    "drum",
    "operand_table",
    "make_lut",
    "lut_mult",
    "REGISTRY",
    "get",
    "is_commutative",
]


@dataclasses.dataclass(frozen=True)
class AxMult:
    """An M-bit approximate multiplier; ``fn(a, b)`` maps M-bit operands to
    the (approximate) 2M-bit product lane; ``desc`` is its kernel
    descriptor or None (see the module docstring)."""

    name: str
    bits: int
    signed: bool
    fn: Callable = dataclasses.field(hash=False, compare=False)
    commutative: Optional[bool] = None
    desc: Optional[tuple] = dataclasses.field(default=None, compare=False)

    def __call__(self, a, b):
        return self.fn(a, b)

    def exact_product(self, a, b):
        """The precise reference product for these operands."""
        if self.signed:
            return s32(s32(a) * s32(b))
        return (u32(a) * u32(b)) & M32


def _mask(m: int) -> int:
    return (1 << m) - 1


def _signed_envelope(core_u):
    """Wrap an unsigned-core multiplier into a sign-magnitude signed one."""

    def fn(a, b):
        a32, b32 = s32(a), s32(b)
        p = s32(core_u(a32.abs(), b32.abs()))     # |INT_MIN| = 2^31 in int64
        return s32(torch.where((a32 < 0) ^ (b32 < 0), -p, p))

    return fn


def _unsigned(core_u):
    return lambda a, b: core_u(u32(a), u32(b))


def _wrap(core_u, signed: bool):
    return _signed_envelope(core_u) if signed else _unsigned(core_u)


def _tag(bits: int, signed: bool) -> str:
    return f"mul{bits}{'s' if signed else 'u'}"


# ---------------------------------------------------------------------------
# families
# ---------------------------------------------------------------------------

def exact(bits: int, signed: bool = False) -> AxMult:
    if signed:
        fn = lambda a, b: s32(s32(a) * s32(b))
    else:
        fn = lambda a, b: (u32(a) * u32(b)) & M32
    return AxMult(f"{_tag(bits, signed)}_exact", bits, signed, fn, True,
                  ("exact", bits, signed, ()))


def trunc(bits: int, ka: int, kb: int, signed: bool = False) -> AxMult:
    """Operand truncation: zero the low ``ka`` bits of A and ``kb`` of B."""
    mka = ~_mask(ka) & M32
    mkb = ~_mask(kb) & M32

    def core(au, bu):
        return ((au & mka) * (bu & mkb)) & M32

    return AxMult(f"{_tag(bits, signed)}_trunc{ka}_{kb}", bits, signed,
                  _wrap(core, signed), ka == kb, ("trunc", bits, signed, (ka, kb)))


def perforate(bits: int, rows: tuple, signed: bool = False) -> AxMult:
    """Partial-product row perforation: ``p = A * (B & ~rowmask)``."""
    rowmask = 0
    for r in rows:
        rowmask |= 1 << r
    inv = ~rowmask & M32

    def core(au, bu):
        return (au * (bu & inv)) & M32

    nm = f"{_tag(bits, signed)}_perf" + "_".join(str(r) for r in rows)
    return AxMult(nm, bits, signed, _wrap(core, signed), len(rows) == 0,
                  ("perforate", bits, signed, (rowmask,)))


def broken_array(bits: int, v: int, h: int = 0, signed: bool = False) -> AxMult:
    """Broken-array multiplier: ``p = sum_{i >= h} b_i * ((A << i) & ~(2^v - 1))``."""
    cmask = ~_mask(v) & M32

    rows = {}

    def core(au, bu):
        # every row at once: sum_i b_i ((A << i) & cmask), mod 2^32
        i = rows.get(au.device)
        if i is None:
            i = rows[au.device] = torch.arange(h, bits, device=au.device)
        bi = (bu[..., None] >> i) & 1
        pp = (au[..., None] << i) & cmask
        return (bi * pp).sum(dim=-1) & M32

    return AxMult(f"{_tag(bits, signed)}_bam_v{v}_h{h}", bits, signed,
                  _wrap(core, signed), h == 0, ("broken_array", bits, signed, (v, h)))


def mitchell(bits: int, ta: int = 0, tb: int = 0, signed: bool = False) -> AxMult:
    """Mitchell logarithmic multiplier with per-operand fraction truncation
    (``ta``/``tb`` low bits of the F = 16 bit fraction dropped)."""
    F = 16

    def _logfrac(xu, t):
        k = msb(torch.clamp(xu, min=1))
        frac = shr(shl((xu - shl(torch.ones_like(xu), k)) & M32, F), k)
        if t > 0:
            frac = frac & (~_mask(t) & M32)
        return k, frac

    def core(au, bu):
        ka, fa = _logfrac(au, ta)
        kb, fb = _logfrac(bu, tb)
        ksum = (ka + kb) & M32
        fsum = (fa + fb) & M32
        carry = fsum >> F
        kk = s32((ksum + carry) & M32)
        mant = (fsum + shl((1 - carry) & M32, F)) & M32
        p = shr(shl(mant, torch.clamp(kk - F, min=0)), torch.clamp(F - kk, min=0))
        zero = (au == 0) | (bu == 0)
        return torch.where(zero, torch.zeros_like(p), p)

    return AxMult(f"{_tag(bits, signed)}_mitch{ta}_{tb}", bits, signed,
                  _wrap(core, signed), ta == tb, ("mitchell", bits, signed, (ta, tb)))


def drum(bits: int, ka: int, kb: int, signed: bool = False) -> AxMult:
    """DRUM-style segmenting multiplier with per-operand widths ``ka``/``kb``."""

    def _segment(xu, k):
        sh = torch.clamp(msb(torch.clamp(xu, min=1)) - (k - 1), min=0)
        seg = shr(xu, sh)
        seg = torch.where(sh > 0, seg | 1, seg)
        return seg, sh

    def core(au, bu):
        sa, sha = _segment(au, ka)
        sb, shb = _segment(bu, kb)
        p = shl((sa * sb) & M32, sha + shb)
        zero = (au == 0) | (bu == 0)
        return torch.where(zero, torch.zeros_like(p), p)

    return AxMult(f"{_tag(bits, signed)}_drum{ka}_{kb}", bits, signed,
                  _wrap(core, signed), ka == kb, ("drum", bits, signed, (ka, kb)))


# ---------------------------------------------------------------------------
# LUT-defined multipliers (EvoApprox compatibility path, 8-bit)
# ---------------------------------------------------------------------------

def operand_table(mult: AxMult, signed_operands: bool) -> torch.Tensor:
    """``mult.fn`` over every pair of 8-bit operand patterns: a (65536,)
    int64 CPU tensor indexed by ``(a8 << 8) | b8``, where the raw patterns
    decode as int8 values when ``signed_operands`` else as uint8 values."""
    vals = torch.arange(256, dtype=torch.int64)
    ops = torch.where(vals < 128, vals, vals - 256) if signed_operands else vals
    return mult.fn(ops.repeat_interleave(256), ops.repeat(256))


def make_lut(mult: AxMult) -> torch.Tensor:
    """An 8-bit multiplier as its 65536-entry product table over its own
    operand type (``repro.core.multipliers.make_lut``)."""
    if mult.bits != 8:
        raise ValueError(f"the LUT path is defined for 8-bit multipliers: {mult.name}")
    return operand_table(mult, mult.signed)


def lut_mult(name: str, table, signed: bool) -> AxMult:
    """An arbitrary 8-bit multiplier defined by its 65536-entry table."""
    tbl = torch.as_tensor(table, dtype=torch.int64)
    by_device = {}

    def fn(a, b):
        t = by_device.get(a.device)
        if t is None:
            t = by_device[a.device] = tbl.to(a.device)
        idx = ((s32(a) & 0xFF) << 8) | (s32(b) & 0xFF)
        return t[idx]

    lanes = s32(tbl).to(torch.int32).numpy().astype("<i4").tobytes()
    return AxMult(name, 8, signed, fn, None, ("lut", 8, signed, (lanes,)))


# ---------------------------------------------------------------------------
# registry — the same fixed library of named circuits
# ---------------------------------------------------------------------------

def _build_registry():
    reg = {}

    def add(m: AxMult):
        reg[m.name] = m

    for bits in (8, 12, 16):
        for signed in (False, True):
            add(exact(bits, signed))
            q = bits // 4
            h = bits // 2
            add(trunc(bits, q, q, signed))
            add(mitchell(bits, 0, 0, signed))
            add(drum(bits, h, h, signed))
            add(trunc(bits, 0, h, signed))
            add(trunc(bits, q, h, signed))
            add(trunc(bits, 1, h + 1, signed))
            add(perforate(bits, tuple(range(0, q)), signed))
            add(perforate(bits, tuple(range(1, h, 2)), signed))
            add(broken_array(bits, v=h, h=0, signed=signed))
            add(broken_array(bits, v=q, h=1, signed=signed))
            add(mitchell(bits, 13, 0, signed))
            add(mitchell(bits, 10, 13, signed))
            add(drum(bits, q + 1, h, signed))
            add(drum(bits, 2, bits - 2, signed))
    return reg


REGISTRY = _build_registry()


def get(name: str) -> AxMult:
    return REGISTRY[name]


def is_commutative(mult: AxMult, probe: int = 4096, seed: int = 0, device="cuda") -> bool:
    """Empirically check commutativity on ``probe`` random operand pairs
    (``repro.core.multipliers.is_commutative``: the same seeded pairs)."""
    rng = np.random.default_rng(seed)
    lo, hi = ((-(1 << (mult.bits - 1)), 1 << (mult.bits - 1)) if mult.signed
              else (0, 1 << mult.bits))
    a = torch.from_numpy(rng.integers(lo, hi, probe, dtype=np.int64).astype(np.int32)).to(device)
    b = torch.from_numpy(rng.integers(lo, hi, probe, dtype=np.int64).astype(np.int32)).to(device)
    return bool(torch.equal(mult.fn(a, b), mult.fn(b, a)))

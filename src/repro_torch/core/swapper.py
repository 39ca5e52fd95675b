"""SWAPPER — single-bit online operand swapping (``repro.core.swapper``).

A :class:`SwapConfig` names (operand in {A,B}, bit position, reference
value).  Where the selected bit of the selected operand equals the value,
the multiplier is evaluated as ``m(b, a)`` instead of ``m(a, b)``: a pair of
branch-free selects ahead of the multiply.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .lanes import s32
from .metrics import abs_err
from .multipliers import AxMult

__all__ = [
    "SwapConfig",
    "swap_mask",
    "swap_mask_dyn",
    "apply_swapper",
    "apply_swapper_dyn",
    "NO_SWAP_TRIPLE",
    "cfg_to_triple",
    "oracle_mult",
    "all_configs",
]

# (op_is_a, bit, value): value=2 never matches a bit => NoSwap.
NO_SWAP_TRIPLE = (1, 0, 2)


@dataclasses.dataclass(frozen=True)
class SwapConfig:
    operand: str  # 'A' or 'B'
    bit: int      # 0 .. M-1 within the M-bit representation
    value: int    # 0 or 1

    def __post_init__(self):
        if self.operand not in ("A", "B") or self.value not in (0, 1):
            raise ValueError(f"invalid SwapConfig {self}")

    def short(self) -> str:
        return f"{self.operand}[{self.bit}]=={self.value}"


def all_configs(bits: int):
    """The 4M-entry exploration space of the tuning phase."""
    return [SwapConfig(op, i, v) for op in ("A", "B") for i in range(bits)
            for v in (0, 1)]


def swap_mask(a, b, cfg: SwapConfig):
    """True where the operands must be swapped (bit of the int32 value)."""
    src = a if cfg.operand == "A" else b
    return ((s32(src) >> cfg.bit) & 1) == cfg.value


def _swap(m, a, b):
    return torch.where(m, b, a), torch.where(m, a, b)


def apply_swapper(mult: AxMult, a, b, cfg: Optional[SwapConfig]):
    """Evaluate ``mult`` with the SWAPPER decision applied."""
    if cfg is None:
        return mult.fn(a, b)
    return mult.fn(*_swap(swap_mask(a, b, cfg), a, b))


def swap_mask_dyn(a, b, op_is_a, bit, value):
    """The swap mask with the (op_is_a, bit, value) triple as run-time
    values (ints or 0-d tensors); ``value == 2`` never matches."""
    a_bit = (s32(a) >> torch.as_tensor(bit, device=a.device)) & 1
    b_bit = (s32(b) >> torch.as_tensor(bit, device=b.device)) & 1
    src = torch.where(torch.as_tensor(op_is_a, device=a.device) != 0, a_bit, b_bit)
    return src == torch.as_tensor(value, device=a.device)


def apply_swapper_dyn(mult: AxMult, a, b, op_is_a, bit, value):
    return mult.fn(*_swap(swap_mask_dyn(a, b, op_is_a, bit, value), a, b))


def cfg_to_triple(cfg: Optional[SwapConfig]):
    """SwapConfig -> (op_is_a, bit, value) int triple; None -> NoSwap."""
    if cfg is None:
        return NO_SWAP_TRIPLE
    return (1 if cfg.operand == "A" else 0, cfg.bit, cfg.value)


def oracle_mult(mult: AxMult) -> AxMult:
    """The paper's theoretical oracle: per multiplication, the operand order
    with the smaller absolute error.  The bound, not a circuit."""

    def fn(a, b):
        p0 = mult.fn(a, b)
        p1 = mult.fn(b, a)
        exact = mult.exact_product(a, b)
        e0 = abs_err(p0, exact, mult.signed)
        e1 = abs_err(p1, exact, mult.signed)
        return torch.where(e0 <= e1, p0, p1)

    return AxMult(f"{mult.name}+oracle", mult.bits, mult.signed, fn, None)

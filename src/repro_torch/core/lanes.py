"""32-bit integer lanes carried in int64 tensors.

The JAX package computes multiplier products in ``uint32``/``int32`` lanes
that wrap mod 2^32.  PyTorch's CPU ``uint32`` lacks shifts, addition and
comparisons, so the port carries every lane in ``int64``: an unsigned lane
holds ``[0, 2^32)`` (masked with :data:`M32` after each op that can leave
the range), a signed lane holds the int32 value (:func:`s32` re-wraps).
Shifts follow XLA: a logical shift by 32 or more gives 0.
"""
from __future__ import annotations

import torch

__all__ = ["M32", "u32", "s32", "shl", "shr", "msb"]

M32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(uint32)``: the low 32 bits of the value, as [0, 2^32)."""
    return x.to(torch.int64) & M32


def s32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(int32)``: the low 32 bits read as two's complement."""
    return ((x.to(torch.int64) + (1 << 31)) & M32) - (1 << 31)


def _as_shift(s, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(s, dtype=torch.int64, device=like.device)


def shl(x: torch.Tensor, s) -> torch.Tensor:
    """uint32 ``x << s`` (0 where ``s >= 32``)."""
    if isinstance(s, int):
        return (x << s) & M32 if s < 32 else torch.zeros_like(x)
    s = _as_shift(s, x)
    out = (x << s.clamp(0, 31)) & M32
    return torch.where(s >= 32, torch.zeros_like(out), out)


def shr(x: torch.Tensor, s) -> torch.Tensor:
    """uint32 logical ``x >> s`` (0 where ``s >= 32``)."""
    if isinstance(s, int):
        return x >> s if s < 32 else torch.zeros_like(x)
    s = _as_shift(s, x)
    out = x >> s.clamp(0, 31)
    return torch.where(s >= 32, torch.zeros_like(out), out)


def msb(x: torch.Tensor) -> torch.Tensor:
    """``31 - clz(x)`` for uint32 lanes ``x >= 1``: the index of the leading
    one (exact; ``jax.lax.clz`` has no torch op)."""
    k = torch.zeros_like(x)
    for j in range(1, 32):
        k += (x >= (1 << j)).to(torch.int64)
    return k

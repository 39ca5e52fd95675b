"""Error metrics of the paper.  Only ``abs_err`` is ported so far (the
swapper's oracle needs it); the array metrics and ``ErrorStats`` come with
component tuning."""
from __future__ import annotations

import torch

from .lanes import M32, s32, u32

__all__ = ["abs_err"]


def abs_err(approx: torch.Tensor, precise: torch.Tensor, signed: bool) -> torch.Tensor:
    """Exact |approx - precise| as uint32 lanes (int64 tensor in [0, 2^32))."""
    au = u32(approx)
    pu = u32(precise)
    big = (s32(approx) >= s32(precise)) if signed else (au >= pu)
    return torch.where(big, (au - pu) & M32, (pu - au) & M32)

"""The port's kernel schedule: a frozen value naming one ``ax_matmul``
dispatch.

``bm``/``bn``/``bk`` are the output-tile and K-step caps (clamped to the
operand dims by the caller, as the JAX package does); ``grid_order`` picks
which tile axis the CUDA grid walks first ("mn": M-major, "nm": N-major).
The order changes only which blocks run together, never the bits.  The
kernel takes every cap up to 128.  There are no tables and no autotuner yet
(``repro.kernels.schedule`` has both).
"""
from __future__ import annotations

import dataclasses

__all__ = ["KernelSchedule", "GRID_ORDERS", "MAX_BLOCK"]

GRID_ORDERS = ("mn", "nm")
MAX_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class KernelSchedule:
    bm: int = 128
    bn: int = 128
    bk: int = 128
    grid_order: str = "mn"

    def __post_init__(self):
        for v in (self.bm, self.bn, self.bk):
            if not 0 < v <= MAX_BLOCK:
                raise ValueError(f"block caps must lie in 1..{MAX_BLOCK}: {self}")
        if self.grid_order not in GRID_ORDERS:
            raise ValueError(f"grid_order must be one of {GRID_ORDERS}: {self}")

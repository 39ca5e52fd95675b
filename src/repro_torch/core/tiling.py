"""The row -> row-tile map and the block-size primitive shared by the
kernel layer and the quant layer (see ``repro.core.tiling`` for the
partition's rationale: ``gm`` requested tiles become ``min(gm, M)`` tiles of
``floor(M / count)`` rows, the last absorbing the remainder)."""
from __future__ import annotations

import numpy as np

__all__ = ["rowtile_count", "rowtile_span", "rowtile_index",
           "largest_divisor_leq"]


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (>= 1)."""
    d = max(1, min(n, cap))
    while n % d:
        d -= 1
    return d


def rowtile_count(M: int, gm: int) -> int:
    """Actual number of row tiles: ``gm`` capped by the row count."""
    return max(1, min(gm, M))


def rowtile_span(M: int, gm: int) -> int:
    """Rows per tile, ``floor(M / rowtile_count)``."""
    return max(1, M // rowtile_count(M, gm))


def rowtile_index(M: int, gm: int) -> np.ndarray:
    """(M,) int array: the tile index of every row."""
    return np.minimum(np.arange(M) // rowtile_span(M, gm),
                      rowtile_count(M, gm) - 1)

"""Plain PyTorch oracles for the port's kernels (``repro.kernels.ref``).

They run on any device: on the CPU they are what the kernel wrappers use,
on the card they are what the kernels are held against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lanes import s32
from repro_torch.core.multipliers import AxMult
from repro_torch.core.swapper import SwapConfig, apply_swapper, apply_swapper_dyn
from repro_torch.core.tuning import SURF_NAMES, tile_stats

__all__ = ["ax_matmul_ref", "ax_matmul_grid_ref", "ax_matmul_grid_blocks_ref",
           "ax_matmul_tiles_ref", "tile_hist_ref", "tile_hist_blocks",
           "tuning_sweep_ref"]

# products materialised per K chunk: bounds the (M, chunk, N) int64 temps
_CHUNK_ELEMS = 1 << 25


def ax_matmul_ref(a, b, mult: AxMult, swap: Optional[SwapConfig] = None):
    """O(M*N*K) reference: every scalar approximate product with the SWAPPER
    decision applied, summed over K with int32 wrap.  int32 (M, N)."""
    M, K = a.shape
    N = b.shape[1]
    A = a.to(torch.int64)
    B = b.to(torch.int64)
    kc = max(1, min(K, _CHUNK_ELEMS // max(1, M * N)))
    acc = torch.zeros((M, N), dtype=torch.int64, device=a.device)
    for k0 in range(0, K, kc):
        prod = apply_swapper(mult, A[:, k0:k0 + kc, None], B[None, k0:k0 + kc, :], swap)
        acc = s32(acc + s32(prod).sum(dim=1))
    return acc.to(torch.int32)


def ax_matmul_tiles_ref(a, b, mult: AxMult, cfg_grid, row_tile, col_tile):
    """Dynamic-config reference with the triple chosen per output element:
    element (m, n) applies ``cfg_grid[row_tile[m], col_tile[n]]`` (index
    tensors of length M and N).  The triples are spread to every element
    and the products materialised in K chunks, as in
    :func:`ax_matmul_ref`.  int32 (M, N)."""
    M, K = a.shape
    N = b.shape[1]
    g = cfg_grid.to(device=a.device, dtype=torch.int64)
    trip = g[row_tile.to(a.device)][:, col_tile.to(a.device)]      # (M, N, 3)
    op, bit, val = (trip[:, None, :, j] for j in range(3))       # (M, 1, N)
    A = a.to(torch.int64)
    B = b.to(torch.int64)
    kc = max(1, min(K, _CHUNK_ELEMS // max(1, M * N)))
    acc = torch.zeros((M, N), dtype=torch.int64, device=a.device)
    for k0 in range(0, K, kc):
        prod = apply_swapper_dyn(mult, A[:, k0:k0 + kc, None], B[None, k0:k0 + kc, :],
                                 op, bit, val)
        acc = s32(acc + s32(prod).sum(dim=1))
    return acc.to(torch.int32)


def ax_matmul_grid_blocks_ref(a, b, mult: AxMult, cfg_grid, bm: int, bn: int):
    """The grid kernel's function over (bm, bn) output tiles: tile (ti, tj)
    applies ``cfg_grid[ti, tj]``; a ragged last tile reads the last entry."""
    rows = torch.arange(a.shape[0], device=a.device) // bm
    cols = torch.arange(b.shape[1], device=a.device) // bn
    return ax_matmul_tiles_ref(a, b, mult, cfg_grid, rows, cols)


def ax_matmul_grid_ref(a, b, mult: AxMult, cfg_grid):
    """``repro.kernels.ref.ax_matmul_grid_ref``: tile (ti, tj) of a (gm, gn)
    grid of equal output tiles uses the triple ``cfg_grid[ti, tj]``."""
    M, N = a.shape[0], b.shape[1]
    gm, gn = cfg_grid.shape[0], cfg_grid.shape[1]
    if M % gm or N % gn:
        raise ValueError(f"a {gm}x{gn} config grid does not divide {M}x{N}")
    return ax_matmul_grid_blocks_ref(a, b, mult, cfg_grid, M // gm, N // gn)


def _counts(blk: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., R, C) int tiles -> (..., bits+1): set magnitude bits per
    position, then the negative count."""
    mag = blk.abs()
    cnt = [((mag >> s) & 1).sum(dim=(-2, -1)) for s in range(bits)]
    cnt.append((blk < 0).to(torch.int64).sum(dim=(-2, -1)))
    return torch.stack(cnt, dim=-1)


def tile_hist_blocks(a, b, bits: int, bm: int, bn: int) -> torch.Tensor:
    """The kernels' ``tile_hist`` output for (bm, bn) output tiles:
    (ceil(M/bm), ceil(N/bn), 2, bits+1) int32.  Tile (ti, tj) counts the A
    rows ``[ti*bm, (ti+1)*bm)`` over all of K (row 0) and the B columns
    ``[tj*bn, (tj+1)*bn)`` over all of K (row 1); a ragged last tile counts
    the rows or columns it holds."""
    M, K = a.shape
    N = b.shape[1]
    gm, gn = -(-M // bm), -(-N // bn)
    A = torch.nn.functional.pad(a.to(torch.int64), (0, 0, 0, gm * bm - M))
    B = torch.nn.functional.pad(b.to(torch.int64), (0, gn * bn - N))
    ca = _counts(A.reshape(gm, bm, K), bits)                       # (gm, w)
    cb = _counts(B.reshape(K, gn, bn).permute(1, 0, 2), bits)      # (gn, w)
    hist = torch.stack([ca[:, None, :].expand(gm, gn, bits + 1),
                        cb[None, :, :].expand(gm, gn, bits + 1)], dim=2)
    return hist.to(torch.int32)


def tile_hist_ref(a, b, bits: int, gm: int, gn: int) -> torch.Tensor:
    """``repro.kernels.ref.tile_hist_ref``: the histogram of a (gm, gn)
    grid of equal output tiles."""
    M, N = a.shape[0], b.shape[1]
    if M % gm or N % gn:
        raise ValueError(f"a {gm}x{gn} tile grid does not divide {M}x{N}")
    return tile_hist_blocks(a, b, bits, M // gm, N // gn)


def tuning_sweep_ref(mult: AxMult, vals: torch.Tensor, rows=None) -> dict:
    """The sweep kernel's function (``tile_stats_jnp`` / ``_row_stats_tuple``
    over the full grid): per-a row statistics of E0, E1 and min(E0, E1)
    over ``vals x vals``, as ``{surf: {stat: (R,) tensor}}`` for the rows
    ``vals[rows]`` (all rows by default).  Rows are taken in chunks so
    that a 16-bit grid (2^32 pairs) runs in bounded memory."""
    a = vals if rows is None else vals[rows]
    chunk = max(1, _CHUNK_ELEMS // (4 * max(1, vals.numel())))
    parts = [tile_stats(mult, a[i:i + chunk], vals) for i in range(0, a.numel(), chunk)]
    return {surf: {k: torch.cat([p[surf][k] for p in parts]) for k in parts[0][surf]}
            for surf in SURF_NAMES}

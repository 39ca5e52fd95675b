"""Plain PyTorch oracles for the port's kernels (``repro.kernels.ref``).

They run on any device: on the CPU they are what the kernel wrappers use,
on the card they are what the kernels are held against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lanes import s32
from repro_torch.core.multipliers import AxMult
from repro_torch.core.swapper import SwapConfig, apply_swapper

__all__ = ["ax_matmul_ref", "tile_hist_ref", "tile_hist_blocks"]

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

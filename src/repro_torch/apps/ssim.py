"""Structural Similarity Index (SSIM), the paper's image-quality metric
(``repro.apps.ssim``): uniform 8x8 windows on a 0..255 dynamic range.

The window mean is a separable 'valid' 1-D convolution along the two
trailing axes, batched over the other axis, in float32 as the JAX code
computes it.  It is written as a sum of shifted slices, so no cuDNN (and
no TF32) is involved and the CPU and the card add in the same order.
"""
from __future__ import annotations

import torch

__all__ = ["ssim"]

_C1 = (0.01 * 255.0) ** 2
_C2 = (0.03 * 255.0) ** 2


def _conv_valid(x: torch.Tensor, w: int, dim: int) -> torch.Tensor:
    """``convolve(row, ones(w) / w, 'valid')`` along ``dim`` of every row."""
    k = torch.full((), 1.0 / w, dtype=x.dtype, device=x.device)
    L = x.shape[dim] - w + 1
    out = x.narrow(dim, 0, L) * k
    for i in range(1, w):
        out = out + x.narrow(dim, i, L) * k
    return out


def _window_mean(x: torch.Tensor, w: int) -> torch.Tensor:
    return _conv_valid(_conv_valid(x, w, x.dim() - 2), w, x.dim() - 1)


def ssim(img_a, img_b, window: int = 8) -> torch.Tensor:
    """Mean SSIM between two images (H, W) or (H, W, C), float, 0..255."""
    a = img_a.to(torch.float32)
    b = img_b.to(torch.float32)
    if a.dim() == 3:  # channel-wise mean
        return torch.stack([ssim(a[..., c], b[..., c], window)
                            for c in range(a.shape[-1])]).mean()
    mu_a = _window_mean(a, window)
    mu_b = _window_mean(b, window)
    aa = _window_mean(a * a, window) - mu_a * mu_a
    bb = _window_mean(b * b, window) - mu_b * mu_b
    ab = _window_mean(a * b, window) - mu_a * mu_b
    num = (2 * mu_a * mu_b + _C1) * (2 * ab + _C2)
    den = (mu_a ** 2 + mu_b ** 2 + _C1) * (aa + bb + _C2)
    return (num / den).mean()

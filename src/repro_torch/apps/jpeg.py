"""AxBench `jpeg`: 8x8 block DCT -> quantize -> dequantize -> IDCT.

Unlike the other benchmarks, jpeg uses 16-bit integer arithmetic directly
(paper §III.B): every multiply is a single mul16s call, no Eq. 6 modular
composition.  The DCT matrix is scaled by 2^7 and quantization uses
reciprocal multiplies, as integer libjpeg does.  Metric: SSIM of the
reconstructed image.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import AxApp, smooth_image
from .ssim import ssim

_S = 7  # DCT matrix scale = 2^7


def _dct_matrix():
    M = np.zeros((8, 8))
    for u in range(8):
        cu = np.sqrt(0.125) if u == 0 else 0.5
        for x in range(8):
            M[u, x] = cu * np.cos((2 * x + 1) * u * np.pi / 16)
    return M


_M_INT = np.round(_dct_matrix() * (1 << _S)).astype(np.int32)       # |m| <= 64
_Q50 = np.array(  # JPEG luminance quantization table (quality 50)
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], np.int32)
_RECIP_Q = np.round((1 << 15) / _Q50).astype(np.int32)              # <= 2048


def gen_inputs(n, seed):
    side = max(32, int(n))
    side -= side % 8
    return {"img": smooth_image(side, side, seed)}  # [0,255]


def _blocks(img):
    h, w = img.shape
    return img.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3).reshape(-1, 8, 8)


def _unblocks(blk, h, w):
    return blk.reshape(h // 8, w // 8, 8, 8).permute(0, 2, 1, 3).reshape(h, w)


def _matmul16(mul16, A, B):
    """(..., 8, 8) x (..., 8, 8) int matmul with every scalar product routed
    through mul16 (int16-domain operands), summed with int32 wrap."""
    prod = mul16(A[..., :, :, None], B[..., None, :, :])  # (..., 8, 8k, 8)
    return prod.sum(dim=-2, dtype=torch.int32)


def run_fxp(inputs, mul16):
    img = inputs["img"].to(torch.float32)
    dev = img.device
    h, w = img.shape
    x = _blocks(torch.round(img).to(torch.int32) - 128)             # (B, 8, 8)
    M = torch.from_numpy(_M_INT).to(dev)
    # forward DCT: Y = (M X M^T) >> 2S, staged to keep operands 16-bit
    t = _matmul16(mul16, M[None], x) >> _S
    y = _matmul16(mul16, t, M.T[None]) >> _S
    # quantize / dequantize (reciprocal multiply, then restore)
    q = mul16(y, torch.from_numpy(_RECIP_Q).to(dev)[None]) >> 15
    yq = mul16(q, torch.from_numpy(_Q50).to(dev)[None])
    # inverse DCT: X' = (M^T Y M) >> 2S
    t2 = _matmul16(mul16, M.T[None], yq) >> _S
    x2 = _matmul16(mul16, t2, M[None]) >> _S
    out = torch.clamp(x2 + 128, 0, 255).to(torch.float32)
    return _unblocks(out, h, w)


def reference(inputs):
    """The same integer pipeline with precise multiplies (the 'original'
    16-bit integer implementation, as in AxBench's jpeg)."""
    img = np.asarray(inputs["img"], np.float64)
    h, w = img.shape
    x = np.round(img).astype(np.int64) - 128
    blk = x.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    M = _M_INT.astype(np.int64)
    t = (M[None] @ blk) >> _S
    y = (t @ M.T[None]) >> _S
    q = (y * _RECIP_Q[None]) >> 15
    yq = q * _Q50[None]
    t2 = (M.T[None] @ yq) >> _S
    x2 = (t2 @ M[None]) >> _S
    out = np.clip(x2 + 128, 0, 255).astype(np.float32)
    return out.reshape(h // 8, w // 8, 8, 8).transpose(0, 2, 1, 3).reshape(h, w)


def metric(out, ref):
    return ssim(out, ref)


APP = AxApp(name="jpeg", metric_name="ssim", minimize=False, kind="int16",
            gen_inputs=gen_inputs, reference=reference, run_fxp=run_fxp, metric=metric)

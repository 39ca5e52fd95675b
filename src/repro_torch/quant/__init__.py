"""Quantized SWAPPER projections (counterpart of ``repro.quant``)."""
from .ax import ax_dense, ax_matmul_int, quantize_rows, separable_transforms

__all__ = ["ax_dense", "ax_matmul_int", "quantize_rows", "separable_transforms"]

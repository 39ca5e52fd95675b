"""The port's kernels: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it (counterpart of ``repro.kernels``)."""
from .ax_matmul import HIST_WIDTH, LAUNCHES, product_table, reset_launches
from .ops import ax_matmul, ax_matmul_dequant, ax_matmul_grid
from .ref import ax_matmul_grid_ref, ax_matmul_ref, tile_hist_ref
from .schedule import KernelSchedule

__all__ = ["ax_matmul", "ax_matmul_dequant", "ax_matmul_grid", "ax_matmul_ref",
           "ax_matmul_grid_ref", "tile_hist_ref", "KernelSchedule", "HIST_WIDTH",
           "LAUNCHES", "product_table", "reset_launches"]

"""The port's kernels: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it (counterpart of ``repro.kernels``).

The submodules ``ax_matmul`` and ``tuning_sweep`` share their names with
functions; the functions re-exported here are the ``ops`` ones, and the
``tuning_sweep`` function is not re-exported, so
``repro_torch.kernels.tuning_sweep`` stays the module."""
from .ax_matmul import HIST_WIDTH, LAUNCHES, product_table, reset_launches
from .ops import ax_matmul, ax_matmul_dequant, ax_matmul_grid, component_sweep_kernel
from .ref import ax_matmul_grid_ref, ax_matmul_ref, tile_hist_ref, tuning_sweep_ref
from .schedule import KernelSchedule

__all__ = ["ax_matmul", "ax_matmul_dequant", "ax_matmul_grid", "ax_matmul_ref",
           "ax_matmul_grid_ref", "tile_hist_ref", "tuning_sweep_ref",
           "component_sweep_kernel", "KernelSchedule", "HIST_WIDTH", "LAUNCHES",
           "product_table", "reset_launches"]

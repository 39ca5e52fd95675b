"""The port's kernels: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it (counterpart of ``repro.kernels``).

  ax_matmul     — the approximate 8-bit matmul with the SWAPPER swap fused
                  ahead of every product (``csrc/ax_matmul.cu``)
  tuning_sweep  — the component-level exhaustive tuning sweep
                  (``csrc/tuning_sweep.cu``)
  schedule      — KernelSchedule (the dispatch value every wrapper
                  resolves) and the versioned ScheduleTable
  autotune      — a timed sweep over the schedule space, with the policy
                  store's file protocol for tables

``ops`` holds the schedule-resolving wrappers, ``ref`` the plain versions.
The submodules ``ax_matmul`` and ``tuning_sweep`` share their names with
functions; the functions re-exported here are the ``ops`` ones, and the
``tuning_sweep`` function is not re-exported, so
``repro_torch.kernels.tuning_sweep`` stays the module."""
from .ax_matmul import HIST_WIDTH, LAUNCHES, product_table, reset_launches
from .ops import ax_matmul, ax_matmul_dequant, ax_matmul_grid, component_sweep_kernel
from .ref import ax_matmul_grid_ref, ax_matmul_ref, tile_hist_ref, tuning_sweep_ref
from .schedule import (KernelSchedule, ScheduleTable, clear_table, default_schedule,
                       install_table, installed_table, resolve, sig_key)

__all__ = ["ax_matmul", "ax_matmul_dequant", "ax_matmul_grid", "component_sweep_kernel",
           "ax_matmul_ref", "ax_matmul_grid_ref", "tile_hist_ref", "tuning_sweep_ref",
           "KernelSchedule", "ScheduleTable", "default_schedule", "install_table",
           "installed_table", "clear_table", "resolve", "sig_key", "HIST_WIDTH",
           "LAUNCHES", "product_table", "reset_launches"]

"""Training (``repro.train``): AdamW, the train step (static and adaptive,
on one device or sharded over a mesh: ``train_step.py``,
``distributed.py``), synthetic and file data, checkpoints, the supervised
run loop and the straggler watchdog.  Checkpoints restore onto a device
mesh and the supervised loop resumes elastically."""
from .checkpoint import AsyncCheckpointer, gather_state, latest_step, load_tree, restore, save
from .data import DataConfig, FileStream, SyntheticStream, make_batch_specs
from .fault import FaultConfig, SimulatedFailure, StragglerWatchdog, run_supervised
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .train_step import fresh_train_state, init_train_blocks, init_train_state, make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "DataConfig", "SyntheticStream",
           "FileStream", "make_batch_specs", "save", "restore", "gather_state", "latest_step",
           "load_tree",
           "AsyncCheckpointer", "FaultConfig", "StragglerWatchdog", "SimulatedFailure",
           "run_supervised", "init_train_state", "fresh_train_state", "init_train_blocks",
           "make_train_step"]

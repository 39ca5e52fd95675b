"""Training-side runtime of the port (``repro.train``).  Only the fault
module's straggler watchdog is ported so far: the continuous batcher
watches its steps with it.  The train step, the optimizer, checkpoints and
the supervised run loop are the training item of ROADMAP queue 1."""
from .fault import SimulatedFailure, StragglerWatchdog

__all__ = ["SimulatedFailure", "StragglerWatchdog"]

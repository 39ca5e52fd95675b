"""Fleet-scale adaptive serving of the port (``repro.fleet``).

  store — versioned ``PolicyStore``: single-writer / many-reader policy JSON
          with monotonic versions, an atomic CURRENT pointer, a heartbeat
          fast path, candidates, promotion and rollback, in the JAX
          package's on-disk format; ``PolicyReader`` is a serve replica's
          view of it
  chaos — deterministic fault injection (``FaultPlan`` / ``ChaosHarness``)
          at the store, reader and controller sites

The continuous batcher (``scheduler``) and the cross-device telemetry
aggregation (``collect``) are not ported yet: the fleet serving item of
ROADMAP queue 1.
"""
from . import chaos
from .chaos import ChaosHarness, FaultPlan, FaultSpec, InjectedFault
from .store import PolicyReader, PolicyStore

__all__ = [
    "PolicyReader",
    "PolicyStore",
    "chaos",
    "ChaosHarness",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
]

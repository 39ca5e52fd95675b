"""Fleet-scale adaptive serving of the port (``repro.fleet``).

  scheduler — the continuous batcher ``ContinuousBatcher``: requests of any
              length and budget admitted into fixed decode slots, served in
              fused waves or spliced in token by token (``token_step``),
              with EOS retirement, per-request seeds, arrival traces
              (``ArrivalSource`` / ``poisson_arrivals``), async admission,
              deadlines, load shedding and per-request QoR attribution
  collect   — telemetry aggregation over a ``torch.distributed`` process
              group: sums, the max and the gathered samples of a step's
              records, equal to the host oracle ``combine_records``
  store     — versioned ``PolicyStore``: single-writer / many-reader policy
              JSON with monotonic versions, an atomic CURRENT pointer, a
              heartbeat fast path, candidates, promotion and rollback, in
              the JAX package's on-disk format; ``PolicyReader`` is a serve
              replica's view of it
  chaos     — deterministic fault injection (``FaultPlan`` /
              ``ChaosHarness``) at the store, reader, controller and
              scheduler sites

The mesh-sharded parts (``shard_decode_specs``, ``token_step_specs``,
``cache_pspecs``, ``batch_axis_names`` and the batcher's ``mesh=``) wait for
the torch device mesh (ROADMAP queue 1, item 8).
"""
from . import chaos
from .chaos import ChaosHarness, FaultPlan, FaultSpec, InjectedFault
from .collect import aggregate_records, combine_shards, make_sharded_summarizer
from .scheduler import (
    ArrivalSource,
    BatcherConfig,
    Completion,
    ContinuousBatcher,
    Request,
    poisson_arrivals,
)
from .store import PolicyReader, PolicyStore

__all__ = [
    "aggregate_records",
    "combine_shards",
    "make_sharded_summarizer",
    "ArrivalSource",
    "BatcherConfig",
    "Completion",
    "ContinuousBatcher",
    "Request",
    "poisson_arrivals",
    "PolicyReader",
    "PolicyStore",
    "chaos",
    "ChaosHarness",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
]

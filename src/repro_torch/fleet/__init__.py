"""Fleet-scale adaptive serving of the port (``repro.fleet``).

  scheduler — the continuous batcher ``ContinuousBatcher``: requests of any
              length and budget admitted into fixed decode slots, served in
              fused waves or spliced in token by token (``token_step``),
              with EOS retirement, per-request seeds, arrival traces
              (``ArrivalSource`` / ``poisson_arrivals``), async admission,
              deadlines, load shedding and per-request QoR attribution
  collect   — telemetry aggregation over a ``torch.distributed`` process
              group: sums, the max and the gathered samples of a step's
              records, equal to the host oracle ``combine_records``; the
              partition specs of the mesh-sharded decode and the helpers
              that slice a rank's block and gather the global batch
  store     — versioned ``PolicyStore``: single-writer / many-reader policy
              JSON with monotonic versions, an atomic CURRENT pointer, a
              heartbeat fast path, candidates, promotion and rollback, in
              the JAX package's on-disk format; ``PolicyReader`` is a serve
              replica's view of it
  chaos     — deterministic fault injection (``FaultPlan`` /
              ``ChaosHarness``) at the store, reader, controller and
              scheduler sites

The batcher takes a fleet mesh (``mesh=``, ``launch/mesh.py``): every rank
runs it over the same requests and serves its block of the slots.
"""
from . import chaos
from .chaos import ChaosHarness, FaultPlan, FaultSpec, InjectedFault
from .collect import (aggregate_records, batch_axis_names, cache_pspecs, combine_shards,
                      make_sharded_summarizer, shard_decode_specs, token_step_specs)
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
    "batch_axis_names",
    "cache_pspecs",
    "shard_decode_specs",
    "token_step_specs",
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

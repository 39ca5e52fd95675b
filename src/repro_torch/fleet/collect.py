"""Cross-device telemetry aggregation (``repro.fleet.collect``), over a
``torch.distributed`` process group where the JAX package uses mesh axes.

A step's telemetry records are built from sums (bit-occupancy counts,
error limb sums, element counts), one max (``err_max``) and operand samples
(the field classes of ``runtime.telemetry``), so the fleet record is an
exact all-reduce SUM / all-reduce MAX / all-gather over the ranks.  One
controller then re-tunes from the fleet's operand distribution.  The result
is identical on every rank and bit-equal to the host oracle
``runtime.telemetry.combine_records`` of the per-rank records.

The device summaries carry 32-bit unsigned lanes in int64
(``core/lanes``): the limb sums are added in int64 and wrapped to 32 bits,
the uint32 arithmetic ``combine_records`` does on the host.  Below the
32-shard bound nothing wraps: a shard's limb sum is at most
``TELEMETRY_SAMPLE * 0xFFFF``, and 32 of them still fit 32 bits.

:func:`combine_shards` applies the same rule to a list of per-shard record
trees in one process (simulated shards, and the oracle the collective path
is tested against).  The JAX package's partition specs
(``batch_axis_names``, ``shard_decode_specs``, ``token_step_specs``,
``cache_pspecs``) describe a mesh-sharded decode step and wait for the torch
device mesh (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import multipliers as M
from repro_torch.runtime.telemetry import (MAX_FIELDS, SAMPLE_FIELDS, SUM_FIELDS,
                                           TELEMETRY_SAMPLE, operand_summary, tile_key,
                                           tile_summary)

__all__ = ["MAX_SHARDS", "aggregate_records", "combine_shards", "make_sharded_summarizer",
           "world_size"]

# 32 shards x TELEMETRY_SAMPLE x 0xFFFF fits a uint32 limb sum
MAX_SHARDS = (2 ** 32 - 1) // (TELEMETRY_SAMPLE * 0xFFFF)
_U32_SUMS = ("err_lo", "err_hi", "tile_err_lo", "tile_err_hi")
_M32 = 0xFFFFFFFF

Records = Dict[str, Dict[str, torch.Tensor]]


def _check_shards(n: int) -> int:
    if n > MAX_SHARDS:
        raise ValueError(f"{n} shards would overflow the uint32 error-limb sums "
                         f"(at most {MAX_SHARDS} at TELEMETRY_SAMPLE={TELEMETRY_SAMPLE})")
    return n


def world_size(group=None) -> int:
    """The ranks of ``group``: 1 without a group or an initialised world."""
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _classify(name: str) -> str:
    if name in MAX_FIELDS:
        return "max"
    if name in SAMPLE_FIELDS:
        return "sample"
    if name not in SUM_FIELDS:
        raise KeyError(f"unclassified telemetry field {name!r}")
    return "sum"


def _wrap(name: str, v: torch.Tensor) -> torch.Tensor:
    return v & _M32 if name in _U32_SUMS and v.dtype == torch.int64 else v


def _reduce_field(name: str, leaf: torch.Tensor, group) -> torch.Tensor:
    kind = _classify(name)
    if kind == "sample":
        # concatenate the shards' samples along axis -2: the call axis of the
        # scalar records, the sample axis of the (S, gm) tile records
        parts = [torch.empty_like(leaf) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, leaf.contiguous(), group=group)
        return torch.cat(parts, dim=leaf.dim() - 2)
    out = leaf.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if kind == "max" else dist.ReduceOp.SUM,
                    group=group)
    return _wrap(name, out)


def aggregate_records(records: Records, group=None) -> Records:
    """Fleet-reduce a step's record tree over the ranks of ``group``: sum
    fields all-reduced (SUM), ``err_max`` all-reduced (MAX), samples
    all-gathered and concatenated along axis ``ndim - 2`` in rank order.
    No group, or a world of one rank, returns ``records`` as they are."""
    n = world_size(group)
    if n == 1:
        return records
    _check_shards(n)
    return {target: {k: _reduce_field(k, v, group) for k, v in rec.items()}
            for target, rec in records.items()}


def combine_shards(shard_records: Sequence[Records]) -> Records:
    """:func:`aggregate_records`' rule over per-shard record trees held in
    one process (sum, max, concatenation along axis ``ndim - 2``)."""
    _check_shards(len(shard_records))
    out: Records = {}
    for target in shard_records[0]:
        out[target] = {}
        for k in shard_records[0][target]:
            leaves = [rec[target][k] for rec in shard_records]
            kind = _classify(k)
            if kind == "sample":
                v = torch.cat(leaves, dim=leaves[0].dim() - 2)
            elif kind == "max":
                v = functools.reduce(torch.maximum, leaves)
            else:
                v = _wrap(k, functools.reduce(torch.add, leaves))
            out[target][k] = v
    return out


def make_sharded_summarizer(mult_name: str, group=None, target: str = "stream",
                            tile_rows: int = 0):
    """A function ``(a, b, dyn) -> record`` that summarizes this rank's slice
    of an int operand stream (``operand_summary``, with a leading call
    axis) and aggregates it over ``group``: the fleet record to feed
    ``AdaptiveController.observe`` as ``{target: record}``.  With
    ``tile_rows > 0`` it returns the record tree of ``target`` and
    ``tile_key(target)``: each rank's row tile t pools into fleet tile t,
    the tile samples gather along the sample axis."""
    mult = M.get(mult_name)
    _check_shards(world_size(group))

    def summarize(a, b, dyn: Optional[torch.Tensor]):
        rec = {k: v[None] for k, v in operand_summary(a, b, mult, dyn).items()}
        if tile_rows == 0:
            return aggregate_records({target: rec}, group)[target]
        trec = tile_summary(a, b, mult, tile_rows, dyn=dyn)
        return aggregate_records({target: rec,
                                  tile_key(target): {k: v[None] for k, v in trec.items()}},
                                 group)

    return summarize

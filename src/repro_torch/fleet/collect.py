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
is tested against).

**Partition specs of the mesh-sharded serve** (``batch_axis_names``,
``cache_pspecs``, ``shard_decode_specs``, ``token_step_specs``: the JAX
package's, as ``launch/sharding.PartitionSpec``).  Under the port's
multi-process SPMD a rank holds the global host vectors and only its own
rows of the cache: :func:`shard_args` takes a rank's slice of each
argument whose spec names the batch axes, and :func:`gather_outputs`
all-gathers each such output back into the global batch order (ranks in
mesh order, contiguous blocks, as a ``P(axes)`` dim is laid out).  A spec
function given ``cache=None`` leaves the cache's spec out: the port's
cache is made on each rank and is local from the start.

:func:`aggregate_records` packs a step's fields into one buffer per
(field class, dtype), so a step costs one collective per buffer (three
or four), not one per field.  The collectives take the records where they
lie: on the card for ``nccl`` and ``gloo`` alike (``gloo`` takes card
tensors for every collective used here, with torch 2.11 on an H100), on
the host for CPU ranks.  They run on the host's schedule between decode
steps, never inside a captured CUDA graph.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import multipliers as M
from repro_torch.launch.sharding import PartitionSpec as P, mesh_shape
from repro_torch.runtime.telemetry import (MAX_FIELDS, SAMPLE_FIELDS, SUM_FIELDS,
                                           TELEMETRY_SAMPLE, operand_summary, tile_key,
                                           tile_summary)

__all__ = ["MAX_SHARDS", "aggregate_records", "combine_shards", "make_sharded_summarizer",
           "world_size", "batch_axis_names", "batch_group", "cache_pspecs",
           "shard_decode_specs", "token_step_specs", "shard_args", "gather_outputs",
           "local_slice", "gather"]

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


def _is_mesh(obj) -> bool:
    return getattr(obj, "mesh_dim_names", None) is not None


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


def _all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def aggregate_records(records: Records, group=None) -> Records:
    """Fleet-reduce a step's record tree over the ranks of ``group`` (a
    process group, or a mesh whose batch axes name it): sum fields
    all-reduced (SUM), ``err_max`` all-reduced (MAX), samples all-gathered
    and concatenated along axis ``ndim - 2`` in rank order, each class
    packed into one buffer per dtype (module note).  No group, or a world
    of one rank, returns ``records`` as they are."""
    if _is_mesh(group):
        group = batch_group(group)[0]
    n = world_size(group)
    if n == 1:
        return records
    _check_shards(n)
    buckets: Dict[tuple, list] = {}
    for target, rec in records.items():
        for k, v in rec.items():
            buckets.setdefault((_classify(k), v.dtype, v.device), []).append((target, k, v))
    out: Dict[str, Dict[str, torch.Tensor]] = {t: {} for t in records}
    for (kind, _, _), fields in buckets.items():
        flat = torch.cat([v.reshape(-1) for _, _, v in fields])
        if kind == "sample":
            parts = [torch.empty_like(flat) for _ in range(n)]
            dist.all_gather(parts, flat, group=group)
        else:
            dist.all_reduce(flat, op=dist.ReduceOp.MAX if kind == "max" else dist.ReduceOp.SUM,
                            group=group)
        off = 0
        for target, k, v in fields:
            m = v.numel()
            if kind == "sample":
                out[target][k] = torch.cat([p[off:off + m].reshape(v.shape) for p in parts],
                                           dim=v.dim() - 2)
            else:
                out[target][k] = _wrap(k, flat[off:off + m].reshape(v.shape))
            off += m
    return {t: {k: out[t][k] for k in rec} for t, rec in records.items()}


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


def make_sharded_summarizer(mult_name: str, mesh=None, target: str = "stream",
                            tile_rows: int = 0):
    """A function ``(a, b, dyn) -> record`` that summarizes this rank's slice
    of an int operand stream (``operand_summary``, with a leading call
    axis) and aggregates it over ``mesh``'s batch axes (or over a process
    group given in its place): the fleet record to feed
    ``AdaptiveController.observe`` as ``{target: record}``.  With
    ``tile_rows > 0`` it returns the record tree of ``target`` and
    ``tile_key(target)``: each rank's row tile t pools into fleet tile t,
    the tile samples gather along the sample axis."""
    mult = M.get(mult_name)
    group = batch_group(mesh)[0] if _is_mesh(mesh) else mesh
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


# ---------------------------------------------------------------------------
# partition specs of the mesh-sharded decode (the JAX package's)
# ---------------------------------------------------------------------------

def batch_axis_names(mesh) -> Tuple[str, ...]:
    """The mesh axes the batch dimension shards over: the 'batch' rule of
    ``launch.sharding.axis_rules`` ('pod' + 'data')."""
    names = mesh_shape(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def _n_shards(mesh, axes) -> int:
    shape = mesh_shape(mesh).shape
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def batch_group(mesh):
    """(process group, this rank's shard index, shard count) of ``mesh``'s
    batch axes.  The serving mesh is 1-D (``launch.mesh.make_fleet_mesh``);
    a batch over several mesh axes (the multi-pod mesh) waits for ROADMAP
    queue 1, item 8b."""
    axes = batch_axis_names(mesh)
    if len(axes) != 1:
        raise NotImplementedError(
            f"a batch sharded over the mesh axes {axes}: the serving mesh is ('data',); "
            f"several batch axes are ROADMAP queue 1, item 8b")
    return mesh.get_group(axes[0]), mesh.get_local_rank(axes[0]), mesh.size(
        mesh.mesh_dim_names.index(axes[0]))


def cache_pspecs(cache, batch: int, axes: Tuple[str, ...]):
    """A spec per decode-cache leaf sharding its batch dim (dim 0 of every
    leaf of the port's per-layer cache list) over ``axes``."""
    from repro_torch.launch.mesh import tree_paths, tree_unflatten

    paths, leaves = tree_paths(cache)
    for path, leaf in zip(paths, leaves):
        if leaf.shape[0] != batch:
            raise ValueError(f"fleet cache spec: leaf {path} shape {tuple(leaf.shape)} has "
                             f"no batch dim {batch} at axis 0")
    return tree_unflatten(cache, [P(axes) for _ in leaves])


def _batch_axes_checked(batch: int, mesh) -> Tuple[str, ...]:
    axes = batch_axis_names(mesh)
    nshard = _n_shards(mesh, axes)
    if not nshard or batch % nshard:
        raise ValueError(f"fleet serving batch {batch} must divide the mesh batch axes "
                         f"{axes} (|{axes}| = {nshard})")
    if nshard > MAX_SHARDS:
        raise ValueError(f"{nshard} batch shards would overflow the uint32 error-limb sums "
                         f"(at most {MAX_SHARDS} at TELEMETRY_SAMPLE={TELEMETRY_SAMPLE})")
    return axes


def shard_decode_specs(cache, batch: int, mesh, seeded: bool = False):
    """(in_specs, out_specs, axes) of the fused adaptive decode ``(params,
    cache, tok0, key0, pos0, budget, bmax, dyn[, seeds]) -> (toks,
    telem)``: params, the key, the global budget maximum (the
    shard-invariant observe gate) and the policy are replicated; the
    tokens, per-slot positions, budgets, seeds and cache leaves shard their
    batch dim; the (steps, B) tokens come out batch-sharded and the
    telemetry replicated (aggregated).  ``cache=None``: no cache spec
    (module note)."""
    axes = _batch_axes_checked(batch, mesh)
    cspec = None if cache is None else cache_pspecs(cache, batch, axes)
    in_specs = (P(), cspec, P(axes), P(), P(axes), P(axes), P(), P())
    if seeded:
        in_specs = in_specs + (P(axes),)
    return in_specs, (P(None, axes), P()), axes


def token_step_specs(cache, batch: int, mesh, seeded: bool = False):
    """(in_specs, out_specs, axes) of the token step ``(params, cache, tok,
    sub, pos, active, dyn, gate[, seeds, nt]) -> (tok, cache, telem)``:
    per-slot vectors and cache leaves shard their batch dim, the rest is
    replicated (the telemetry aggregated).  ``cache=None``: no cache spec."""
    axes = _batch_axes_checked(batch, mesh)
    cspec = None if cache is None else cache_pspecs(cache, batch, axes)
    in_specs = (P(), cspec, P(axes), P(), P(axes), P(axes), P(), P())
    if seeded:
        in_specs = in_specs + (P(axes), P(axes))
    return in_specs, (P(axes), cspec, P()), axes


def _batch_dim(spec) -> Optional[int]:
    """The dim a spec shards over the mesh (at most one in these specs)."""
    dims = [d for d, ax in enumerate(spec) if ax]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} shards more than one dim")
    return dims[0] if dims else None


def local_slice(x, spec, mesh):
    """This rank's block of the global ``x`` (a tensor or array) under
    ``spec``: contiguous blocks in shard order along the sharded dim."""
    d = _batch_dim(spec)
    if d is None or x is None:
        return x
    _, index, n = batch_group(mesh)
    size = x.shape[d]
    if size % n:
        raise ValueError(f"dim {d} of size {size} does not divide over {n} shards")
    k = size // n
    return x[(slice(None),) * d + (slice(index * k, (index + 1) * k),)]


def gather(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor of this rank's block ``x`` under ``spec``: an
    all-gather over the batch group, concatenated in shard order."""
    d = _batch_dim(spec)
    if d is None or x is None:
        return x
    group = batch_group(mesh)[0]
    if world_size(group) == 1:
        return x
    return _all_gather_cat(x, d, group)


def _map_spec(fn, args, specs, mesh):
    out = tuple(a if sp is None else fn(a, sp, mesh) for a, sp in zip(args, specs))
    return out + tuple(args[len(specs):])


def shard_args(args: tuple, in_specs: tuple, mesh) -> tuple:
    """Each argument's local block under its spec, replicated ones (and
    those whose spec is None: the port's local cache) as they are."""
    return _map_spec(local_slice, args, in_specs, mesh)


def gather_outputs(outs: tuple, out_specs: tuple, mesh) -> tuple:
    """Each batch-sharded output all-gathered into the global batch order;
    replicated ones (the aggregated telemetry) as they are."""
    return _map_spec(gather, outs, out_specs, mesh)

"""The collectives of the sharded train step (``repro.train.train_step``
under ``set_mesh_ctx``, as JAX's GSPMD partitions it), made explicit for
the port's multi-process SPMD.

A rank's train state holds its blocks under ``launch.mesh.state_shardings``
(:func:`local_state` takes them from a whole state,
``checkpoint.gather_state`` puts them back).  In a step:

* :func:`gather_leaf` all-gathers a parameter block over the mesh axes of
  its sharded dims that the rank does not compute with (FSDP's ``"embed"``
  over ``"data"``; the router's experts dim and the SSD's ``conv/w``, whose
  concatenated channels do not line up with ``din``'s split, over
  ``"model"``), once per step before the first microbatch.  Its backward
  is a reduce-scatter SUM, run once after the last microbatch.  The routed
  experts' weights keep their experts dim sharded: with ``ep`` a rank
  holds ``E / model`` experts; so do the tensor-parallel leaves.
* The MoE block carries each expert's capacity slots to the rank that
  holds it and back (``launch.parallel.expert_all_to_all``).
* :meth:`TrainMesh.reduce_grads` all-reduces (SUM) each gradient over the
  mesh axes on which its leaf is replicated, in one buffer per group and
  dtype.
* The loss is a sum over ranks of per-rank terms (``models/registry.py``,
  ``models/blocks.py``, which find the step's :class:`TrainMesh` through
  ``launch.sharding.current_groups``): each rank backpropagates its own, so
  gradients are summed, never averaged; :meth:`TrainMesh.batch_sum` and
  :meth:`TrainMesh.token_sum` give the counts those terms divide by
  (labels, tokens, top-1 choices); the reported metrics are the terms
  summed over the world.

Every collective runs in the same order on every rank: the leaves in tree
order, the layers in order, and a recomputed layer (``remat="layer"``)
repeats its forward's collectives in the backward, where autograd runs the
same graph on every rank.  The recomputation runs under its forward's
mesh context (``launch.sharding.recompute_context``): on the card
autograd runs the backward on a device thread of its own, where the
step's thread-local context is not installed.

**Tensor and sequence parallelism** over ``"model"``: the collectives
and the groups are ``launch/parallel.py``'s (its module note), which the
model-sharded prefill and decode step use too; a leaf sharded over
``"model"`` is not gathered, its block being what the rank computes with.

Every collective's backward is its adjoint.  The loss is the sum
over **every** rank of per-rank terms: where the model ranks of a batch
shard compute the same term (the vocab-parallel cross-entropy, the MoE term
over replicated tokens) each takes its ``1 / model`` share.  So a
replicated activation's gradient is, on each rank, that rank's part of the
whole; Megatron's *f* (identity forward, all-reduce backward) is not needed,
its all-reduce being the *g* all-reduce's adjoint at the block's exit; and a
leaf's gradient is all-reduced (SUM) over every mesh axis its spec does
not shard, ``"model"`` included: without ``seq_shard`` because each model
rank holds its share, with it also because each seq shard holds the part of
its rows.  The reported metrics are the terms all-reduced over the world.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axes_group, local_blocks, state_shardings, tree_paths
from repro_torch.launch.parallel import (GATHERED_ON_MODEL, MeshGroups, TensorParallel, _Gather,
                                         _group_of, all_reduce_sum)
from repro_torch.launch.sharding import _names, axis_size, mesh_shape

__all__ = ["TrainMesh", "LeafPlan", "TensorParallel", "train_mesh", "gather_leaf",
           "all_reduce_sum", "state_specs", "local_state"]


def gather_leaf(x: torch.Tensor, dims) -> torch.Tensor:
    """The whole of ``x`` along ``dims`` (``[(dim, (group, index, n)),
    ...]``): blocks all-gathered in rank order; the backward reduce-scatters
    (SUM) the gradient back to the block."""
    for d, (group, _, n) in dims:
        x = _Gather.apply(x, d, group, n)
    return x



class LeafPlan(NamedTuple):
    """What the sharded step does with one parameter leaf: the dims it
    gathers (``[(dim, (group, index, n))]``), the group and axes its
    gradient is all-reduced over (None: no reduction), and how many ranks
    hold the same block (the grad norm's divisor)."""
    gather: list
    reduce_group: object
    reduce_axes: tuple
    replicas: int


def _is_expert_weight(path: str) -> bool:
    parts = path.split("/")
    return len(parts) >= 3 and parts[-3] == "experts"


class TrainMesh(MeshGroups):
    """A mesh's groups (``launch.parallel.MeshGroups``) and, per parameter
    leaf of a sharded step, the dims to gather, the group its gradient is
    reduced over and its replication factor."""

    def __init__(self, mesh, par):
        super().__init__(mesh, par)
        self._plans = {}

    def plans(self, cfg, opt_cfg):
        """``{path: LeafPlan}`` per parameter leaf of ``cfg``'s state, from
        the specs of the whole state (:func:`state_specs`), made once per
        config."""
        key = repr((cfg, opt_cfg))
        if key not in self._plans:
            specs = state_specs(cfg, opt_cfg, self.mesh, self.par)
            paths, spec_leaves = tree_paths(specs["params"])
            all_axes = mesh_shape(self.mesh).axis_names
            plans = {}
            for path, spec in zip(paths, spec_leaves):
                used = {a for ax in spec for a in _names(ax)}
                dims = []
                for d, ax in enumerate(spec):
                    if not _names(ax) or axis_size(self.mesh, ax) == 1:
                        continue
                    if _names(ax) == ("model",) and not path.endswith(GATHERED_ON_MODEL):
                        if self.tp is not None:
                            continue                # a tensor-parallel block
                        if d == 0 and _is_expert_weight(path):
                            continue                # the rank's experts stay its own
                    dims.append((d, axes_group(self.mesh, _names(ax))))
                reduce_axes = tuple(a for a in all_axes
                                    if a not in used and axis_size(self.mesh, a) > 1)
                replicas = axis_size(self.mesh, tuple(a for a in all_axes if a not in used))
                group = _group_of(self.mesh, reduce_axes)
                plans[path] = LeafPlan(dims, group and group[0], reduce_axes, replicas)
            self._plans[key] = plans
        return self._plans[key]

    def reduce_grads(self, grads, plans):
        """Each gradient all-reduced (SUM) over the mesh axes its leaf is
        replicated on, packed into one buffer per (axes, dtype, device)."""
        buckets = {}
        for i, (g, plan) in enumerate(zip(grads, plans)):
            if plan.reduce_group is not None:
                buckets.setdefault((plan.reduce_axes, g.dtype, g.device), []).append(i)
        out = list(grads)
        for idx in buckets.values():
            group = plans[idx[0]].reduce_group
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=group)
            off = 0
            for i in idx:
                m = grads[i].numel()
                out[i] = flat[off:off + m].view_as(grads[i])
                off += m
        return out


def train_mesh(mesh, par) -> TrainMesh:
    """The :class:`TrainMesh` of ``mesh`` under ``par``, made once and kept
    on the mesh (its groups are made on every rank in one order)."""
    made = mesh.__dict__.setdefault("_repro_train_meshes", {})
    if par not in made:
        made[par] = TrainMesh(mesh, par)
    return made[par]


def state_specs(cfg, opt_cfg, mesh, par):
    """``launch.mesh.state_shardings`` of ``cfg``'s whole train state (its
    shapes from the meta device)."""
    from .train_step import fresh_train_state

    return state_shardings(mesh, par, fresh_train_state(cfg, opt_cfg, device="meta"))


local_state = local_blocks     # a whole state's blocks under its spec tree

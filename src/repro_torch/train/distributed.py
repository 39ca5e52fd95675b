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
* :func:`expert_all_to_all` carries each expert's capacity slots from the
  ranks that dispatched them to the rank that holds the expert, over
  ``"model"`` (JAX's ``expert_ffn`` resharding, ``shard(buf, "experts",
  "batch", None)``), and :func:`expert_all_to_all_back` returns them; each
  one's backward is the other.
* :meth:`TrainMesh.reduce_grads` all-reduces (SUM) each gradient over the
  mesh axes on which its leaf is replicated, in one buffer per group and
  dtype.
* The loss is a sum over ranks of per-rank terms (``models/registry.py``,
  ``models/blocks.py``, which find the step's :class:`TrainMesh` through
  ``launch.sharding.current_train``): each rank backpropagates its own, so
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

**Tensor and sequence parallelism** over ``"model"`` (the rules without
``dp_only``: ``heads``, ``ff`` and ``vocab`` on ``"model"``, and ``seq`` with
``seq_shard``).  A leaf sharded over ``"model"`` is not gathered: its block
is what the rank computes with (:class:`TensorParallel`, found by the models
through ``launch.sharding.current_tp``).  Column-parallel projections (q/k/v,
in/gate) need no collective; row-parallel ones (attention's ``o``, the
FFN's ``out``, the vocab-parallel embedding lookup) reduce their partial
sums: all-reduce SUM, or with ``seq_shard`` a reduce-scatter over ``seq``,
the residual living on its seq shard between blocks and all-gathered over
``seq`` at the entry of each block (:meth:`TensorParallel.enter`,
:meth:`TensorParallel.exit`).  The SWAPPER projection reduces its int32
partial sums before it dequantizes (``quant.ax``), so it stays exact.

Every collective's backward is its adjoint: all-gather <-> reduce-scatter,
and an all-reduce SUM's backward is an all-reduce SUM.  The loss is the sum
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

**Backends.**  ``nccl`` and ``gloo`` both run these collectives natively
on card tensors (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``all_reduce``; ``gloo`` with torch 2.11 on an H100,
probed by ``chip_smoke.py``), and ``gloo`` on CPU tensors; nothing is
composed, and an unsupported call raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.fleet.collect import batch_axis_names, batch_group
from repro_torch.launch.mesh import axes_group, state_shardings, tree_paths
from repro_torch.launch.sharding import _names, axis_rules, axis_size, mesh_shape

__all__ = ["TrainMesh", "LeafPlan", "TensorParallel", "train_mesh", "gather_leaf",
           "expert_all_to_all", "expert_all_to_all_back", "all_reduce_sum", "state_specs",
           "local_state"]


def _group_of(mesh, axes):
    """``axes_group(mesh, axes)``, or None when they span one rank."""
    if not axes or axis_size(mesh, tuple(axes)) == 1:
        return None
    return axes_group(mesh, tuple(axes))


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A detached all-reduce SUM of ``t`` over ``group`` (``t`` itself for
    a one-rank group)."""
    if group is None:
        return t.detach()
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None


def gather_leaf(x: torch.Tensor, dims) -> torch.Tensor:
    """The whole of ``x`` along ``dims`` (``[(dim, (group, index, n)),
    ...]``): blocks all-gathered in rank order; the backward reduce-scatters
    (SUM) the gradient back to the block."""
    for d, (group, _, n) in dims:
        x = _Gather.apply(x, d, group, n)
    return x


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter SUM along ``dim`` (this rank keeps block ``index``);
    its backward is the all-gather of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _reduce_scatter(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _AllReduce(torch.autograd.Function):
    """All-reduce SUM of partial sums; its backward (the adjoint) is the
    all-reduce SUM of the gradient: each rank holds its part of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _all_gather(x, dim, group, n):
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x, dim, group, n):
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class TensorParallel:
    """The ``"model"`` axis of a train mesh that carries tensor parallelism
    (module note): its group, this rank's index and the rank count, and
    whether the residual is sequence-sharded (``seq_shard``).  A dim of a
    leaf or an activation that the rules put on ``"model"`` holds this
    rank's block ``index`` of ``n`` equal blocks (:meth:`block`): the rank's
    offsets into ``heads``, ``ff``, ``vocab`` and ``seq``.

    The autograd collectives (:meth:`gather`, :meth:`reduce`,
    :meth:`reduce_scatter`, :meth:`enter`, :meth:`exit`) take their adjoint
    in the backward; :meth:`all_reduce_`, :meth:`all_gather_` and
    :meth:`reduce_scatter_` take no gradient (scales, integer sums,
    telemetry samples)."""

    def __init__(self, group, index: int, n: int, seq: bool):
        self.group, self.index, self.n, self.seq = group, index, n, seq

    def block(self, full: int):
        """(lo, hi) of this rank's block of a dim of ``full`` entries."""
        if full % self.n:
            raise ValueError(f"a dim of {full} does not split over {self.n} model ranks")
        b = full // self.n
        return self.index * b, (self.index + 1) * b

    def split(self, local: int, full: int) -> bool:
        """Whether a dim of ``full`` entries holds ``local`` of them here: its
        block (True) or the whole, replicated (False; ``param_spec`` drops
        a constraint that does not divide)."""
        if local == full:
            return False
        if local * self.n != full:
            raise ValueError(f"a dim of {local} is neither {full} nor its 1/{self.n} block")
        return True

    # -- with gradients ----------------------------------------------------
    def gather(self, x, dim: int):
        """All-gather along ``dim`` (backward: reduce-scatter SUM)."""
        return _Gather.apply(x, dim % x.dim(), self.group, self.n)

    def reduce(self, x):
        """All-reduce SUM of partial sums (backward: the same)."""
        return _AllReduce.apply(x, self.group)

    def reduce_scatter(self, x, dim: int):
        """Reduce-scatter SUM along ``dim`` (backward: all-gather)."""
        return _ReduceScatter.apply(x, dim % x.dim(), self.group, self.n)

    def enter(self, x):
        """A block's input from the residual: all-gathered over ``seq``
        (dim 1) under ``seq_shard``, else the residual itself."""
        return self.gather(x, 1) if self.seq else x

    def exit(self, y, partial: bool):
        """A block's output (B, S, ...) to the residual's layout: partial
        sums over the model ranks reduced (reduce-scattered over ``seq``
        under ``seq_shard``); a complete, replicated value taken as it is,
        or its seq shard."""
        if partial:
            return self.reduce_scatter(y, 1) if self.seq else self.reduce(y)
        if self.seq:
            lo, hi = self.block(y.shape[1])
            return y[:, lo:hi]
        return y

    # -- without gradients -------------------------------------------------
    def all_reduce_(self, t, op=dist.ReduceOp.SUM):
        return _all_reduce(t, self.group, op)

    def all_gather_(self, t, dim: int):
        return _all_gather(t.detach(), dim % t.dim(), self.group, self.n)

    def reduce_scatter_(self, t, dim: int):
        return _reduce_scatter(t.detach(), dim % t.dim(), self.group, self.n)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with equal splits along dim 0: chunk j goes to
    rank j, and the chunk from rank j lands at j.  It is its own inverse,
    so its backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    # both buffers row-major: a gradient may arrive with permuted strides,
    # which ``empty_like`` would keep while the collective writes row-major
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def expert_all_to_all(buf: torch.Tensor, group, n: int) -> torch.Tensor:
    """A rank's dispatch buffer ``(E, C, D)`` (its own tokens' slots for
    every expert) -> ``(E / n, n C, D)``: every rank's slots for this rank's
    ``E / n`` experts, the source ranks' slots side by side."""
    E, C, D = buf.shape
    x = _AllToAll.apply(buf.reshape(n, E // n, C, D), group)   # (source, E/n, C, D)
    return x.transpose(0, 1).reshape(E // n, n * C, D)


def expert_all_to_all_back(y: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of :func:`expert_all_to_all`: ``(E / n, n C, D)`` ->
    this rank's ``(E, C, D)``."""
    El, nC, D = y.shape
    x = y.reshape(El, n, nC // n, D).transpose(0, 1).contiguous()
    return _AllToAll.apply(x, group).reshape(n * El, nC // n, D)


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


# leaves sharded over "model" that a rank gathers: the router scores every
# expert, and the SSD's conv channels (din + 2N, split as one dim) do not
# line up with din's split
_GATHERED_ON_MODEL = ("router/w", "ssm/conv/w")


class TrainMesh:
    """A mesh, its rules under ``par`` and the groups a sharded step uses:
    ``batch`` (the rules' batch axes: ``(group, index, n)``), ``experts``
    (``"model"`` with ``ep`` when it has more than one rank, else None),
    ``tp`` (the :class:`TensorParallel` of a ``"model"`` axis of several
    ranks without ``dp_only``, else None), ``tokens`` (the MoE dispatch's
    token shards: the batch axes, and ``"model"`` under ``seq_shard``) and,
    per parameter leaf, the dims to gather, the group its gradient is
    reduced over and its replication factor."""

    def __init__(self, mesh, par):
        self.mesh, self.par = mesh, par
        self.rules = axis_rules(mesh, par)
        self.batch_axes = batch_axis_names(mesh, self.rules)
        self.batch = batch_group(mesh, self.rules)
        ex = self.rules["experts"]
        self.experts = _group_of(mesh, _names(ex))
        names = mesh_shape(mesh).axis_names
        self.tp = None
        if not par.dp_only and "model" in names and axis_size(mesh, "model") > 1:
            self.tp = TensorParallel(*axes_group(mesh, "model"), seq=par.seq_shard)
        token_axes = self.batch_axes + (("model",) if self.tp is not None and self.tp.seq
                                        else ())
        self.tokens = _group_of(mesh, token_axes)
        self._plans = {}

    @property
    def batch_group(self):
        """The batch axes' group, None over one rank."""
        return self.batch[0] if self.batch[2] > 1 else None

    @property
    def world_group(self):
        """The whole mesh's group, None over one rank."""
        return dist.group.WORLD if dist.get_world_size() > 1 else None

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch shards, detached."""
        return all_reduce_sum(t, self.batch_group)

    def token_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the MoE dispatch's token shards, detached."""
        return all_reduce_sum(t, self.tokens and self.tokens[0])

    def experts_apply(self, buf: torch.Tensor, ffn):
        """``ffn`` of this rank's experts on every rank's slots for them,
        when they are split over ``"model"``: the dispatch buffer ``(E, C,
        D)`` through the expert all-to-all and back."""
        group, _, n = self.experts
        return expert_all_to_all_back(ffn(expert_all_to_all(buf, group, n)), group, n)

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
                    if _names(ax) == ("model",) and not path.endswith(_GATHERED_ON_MODEL):
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


def local_state(state, specs, mesh):
    """This rank's block of each leaf of a whole ``state`` under the spec
    tree ``specs`` (matched by key; ``checkpoint.restore(sharding_tree=)``'s
    placement)."""
    from .checkpoint import _block

    def build(node, spec):
        if isinstance(node, dict):
            return {k: build(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, spec[i]) for i, v in enumerate(node)]
        if not any(spec):
            return node
        return node[_block(mesh, spec, tuple(node.shape))].clone()

    return build(state, specs)

"""The collectives of a mesh's ``"model"`` and batch axes and the groups
that carry them, shared by the sharded train step (``train/distributed.py``)
and the model-sharded prefill and decode step (``models.registry`` under
``launch.sharding.set_mesh_ctx``).

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
and an all-reduce SUM's backward is an all-reduce SUM (the train step's
note says why that is the whole gradient).  :func:`expert_all_to_all`
carries each expert's capacity slots from the ranks that dispatched them to
the rank that holds the expert, over ``"model"`` (JAX's ``expert_ffn``
resharding, ``shard(buf, "experts", "batch", None)``), and
:func:`expert_all_to_all_back` returns them; each one's backward is the
other.

:class:`MeshGroups` holds a mesh's groups under a ``ParallelConfig``: the
batch axes, the experts, the ``TensorParallel``, the MoE dispatch's token
shards, and for serving a global batch's rows and the K/V cache's sequence
group.  :func:`mesh_groups` makes it once per mesh; ``set_mesh_ctx``
installs it for a model-sharded mesh, and the train step's ``TrainMesh``
adds its per-leaf plans to it.  :func:`serve_params` takes a rank's blocks
of a whole param tree for serving and notes on the mesh's groups where
each block starts in its leaf (:meth:`MeshGroups.block_starts`), which a
transform of the whole weights by their global indices reads
(``launch.serve.drift_hook``).

**Backends.**  ``nccl`` and ``gloo`` both run these collectives natively
on card tensors (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``all_reduce``; ``gloo`` with torch 2.11 on an H100,
probed by ``chip_smoke.py``), and ``gloo`` on CPU tensors; nothing is
composed, and an unsupported call raises.
"""
from __future__ import annotations

import weakref
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axes_group, batch_axis_names, batch_group, block_index, \
    local_blocks, param_shardings, tree_paths, tree_unflatten
from repro_torch.launch.sharding import PartitionSpec, _names, axis_rules, axis_size, mesh_shape

__all__ = ["TensorParallel", "MeshGroups", "mesh_groups", "expert_all_to_all",
           "expert_all_to_all_back", "all_reduce_sum", "serve_param_specs", "serve_params"]

# leaves sharded over "model" that a rank gathers: the router scores every
# expert, and the SSD's conv channels (din + 2N, split as one dim) do not
# line up with din's split
GATHERED_ON_MODEL = ("router/w", "ssm/conv/w")


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
    """The ``"model"`` axis of a mesh that carries tensor parallelism
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
        self._unseq = None

    def unseq(self) -> "TensorParallel":
        """The same group with the residual whole over ``seq``: a decode
        step's, whose one token does not split (made once)."""
        if not self.seq:
            return self
        if self._unseq is None:
            self._unseq = TensorParallel(self.group, self.index, self.n, False)
        return self._unseq

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
        if not self.seq:
            return self.reduce(y) if partial else y
        lo, hi = self.block(y.shape[1])           # ValueError where seq does not split
        return self.reduce_scatter(y, 1) if partial else y[:, lo:hi]

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


class MeshGroups:
    """A mesh, its rules under ``par`` and its groups: ``batch`` (the rules'
    batch axes: ``(group, index, n)``), ``experts`` (``"model"`` with ``ep``
    when it has more than one rank, else None), ``tp`` (the
    :class:`TensorParallel` of a ``"model"`` axis of several ranks without
    ``dp_only``, else None), ``tokens`` (the MoE dispatch's token shards:
    the batch axes, and ``"model"`` under ``seq_shard``); for serving, a
    global batch's rows (:meth:`rows`) and the K/V cache's sequence group
    (:meth:`kv_group`)."""

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
        self._starts = {}          # tensor id -> (weak reference, its block's starts)

    def note_block(self, t: torch.Tensor, starts: Sequence[int]) -> None:
        """Note that ``t`` is the block of a whole leaf that starts at
        ``starts`` (one index per dim); the note goes with the tensor."""
        key, starts = id(t), tuple(int(i) for i in starts)
        self._starts[key] = (weakref.ref(t, lambda _r, k=key: self._starts.pop(k, None)),
                             starts)

    def block_starts(self, t: torch.Tensor) -> Optional[Tuple[int, ...]]:
        """Where ``t``'s block starts in its whole leaf, as :func:`serve_params`
        (or :meth:`note_block`) noted it; None for a tensor with no note."""
        entry = self._starts.get(id(t))
        if entry is None or entry[0]() is not t:
            return None
        return entry[1]

    def rows(self, B: int):
        """(lo, hi) of this rank's rows of a global batch of ``B``: its block
        over the batch axes, or every row where ``B`` does not divide over
        them (``batch_shardings`` leaves such a batch replicated)."""
        _, index, n = self.batch
        if n == 1 or B % n:
            return 0, B
        return index * (B // n), (index + 1) * (B // n)

    def gather_rows(self, t: torch.Tensor, B: int) -> torch.Tensor:
        """``t``, this rank's :meth:`rows` of a global batch of ``B`` on dim
        0, all-gathered to the whole batch (no gradient)."""
        lo, hi = self.rows(B)
        if hi - lo == B:
            return t
        return _all_gather(t.detach(), 0, self.batch[0], self.batch[2])

    def kv_group(self, B: int):
        """(group, index, n) of the ranks that hold a K/V cache's sequence
        for a global batch of ``B``, as ``launch.mesh.cache_shardings``
        places it: ``"model"``, or the batch axes and ``"model"`` where the
        batch does not divide over the batch axes (long-context batch 1)."""
        lo, hi = self.rows(B)
        if hi - lo < B or self.batch[2] == 1:
            return axes_group(self.mesh, "model")
        return axes_group(self.mesh, self.batch_axes + ("model",))

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


def mesh_groups(mesh, par) -> MeshGroups:
    """The :class:`MeshGroups` of ``mesh`` under ``par``, made once and kept
    on the mesh (its groups are made on every rank in one order)."""
    made = mesh.__dict__.setdefault("_repro_mesh_groups", {})
    if par not in made:
        made[par] = MeshGroups(mesh, par)
    return made[par]


def serve_param_specs(mesh, par, params_shape):
    """The spec tree of a param tree as the model-sharded prefill and decode
    step holds it (``models.registry``): ``launch.mesh.param_shardings``
    with only the ``"model"`` entries of the tensor-parallel leaves kept.
    A serving rank computes with its blocks over ``"model"`` and keeps the
    rest whole: FSDP's ``"embed"`` over ``"data"`` is gathered once at
    load, and so are the leaves every rank reads whole (the router, the
    SSD's ``conv/w``).  With ``dp_only`` or one model rank every leaf is
    whole."""
    specs = param_shardings(mesh, par, params_shape)
    paths, leaves = tree_paths(specs)
    names = mesh_shape(mesh).axis_names
    tp = not par.dp_only and "model" in names and axis_size(mesh, "model") > 1
    out = []
    for path, spec in zip(paths, leaves):
        keep = tp and not path.endswith(GATHERED_ON_MODEL)
        out.append(PartitionSpec(*[ax if keep and _names(ax) == ("model",) else None
                                   for ax in spec]))
    return tree_unflatten(specs, out)


def serve_params(params, mesh, par):
    """This rank's blocks of a whole param tree for the model-sharded
    prefill and decode step (:func:`serve_param_specs`); each block's
    offsets into its leaf are noted on the mesh's groups
    (:meth:`MeshGroups.block_starts`)."""
    specs = serve_param_specs(mesh, par, params)
    local = local_blocks(params, specs, mesh)
    groups = mesh_groups(mesh, par)
    for spec, whole, blk in zip(tree_paths(specs)[1], tree_paths(params)[1],
                                tree_paths(local)[1]):
        groups.note_block(blk, [s.start for s in block_index(mesh, spec, tuple(whole.shape))])
    return local

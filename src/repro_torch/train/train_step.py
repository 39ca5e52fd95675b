"""The training step (``repro.train.train_step``): loss, gradients and
AdamW, with microbatch gradient accumulation, on one device.

``make_train_step(cfg, par, opt_cfg)`` returns ``step(state, batch) ->
(state, metrics)``; the state is ``{"params", "opt"}`` (``init_train_state``)
and each step returns a new one (the JAX package's functional step; the
tensors it was given are left as they were).  A batch is a dict of numpy
or torch arrays, ``{"tokens", "labels"}`` (``{"frames", "tokens",
"labels"}`` for the encoder-decoder), moved to the parameters' device.
Metrics stay tensors on that device (``loss``, ``ce``, ``aux``,
``grad_norm``, ``lr``): a step reads nothing back to the host.

The SWAPPER projections run forward through the approximate kernels and
backward as the exact straight-through product (``quant.ax``), so a
backward pass launches no approximate kernel.

``adaptive=True`` returns ``step(state, batch, ax_dyn)``: the loss runs
inside ``ax_scope(ax_dyn, collect=True, tile_rows=)``, so each covered
projection takes its swap triple (or per-row-tile grid) from ``ax_dyn`` (the
controller's ``dyn_tree()``) and records its telemetry, which comes back
detached in ``metrics["ax_telemetry"]``.  A policy change between steps
changes tensor values only.  As in JAX it needs ``grad_accum == 1`` and
``remat == "none"``.

``ParallelConfig`` (``configs/base.py``): ``remat="layer"`` is
``torch.utils.checkpoint`` per layer of a decoder-only stack and
``remat="dots"`` raises.  ``fsdp``, ``seq_shard``, ``ep`` and ``dp_only``
act only on a mesh, as JAX's ``shard()`` does nothing outside one;
``grad_compress`` is accepted and read nowhere, as in JAX.

**The sharded step.**  ``make_train_step(..., mesh=)``, or a step called
inside ``launch.sharding.set_mesh_ctx(mesh, par)``, runs JAX's step under
``set_mesh_ctx`` as multi-process SPMD (``train/distributed.py``): the
state holds the rank's blocks under ``launch.mesh.state_shardings``
(``distributed.local_state``), and every rank is given the **global**
batch and takes its rows over the rules' batch axes.  With ``grad_accum
= k`` microbatch j is rows ``[j B/k, (j+1) B/k)`` of the global batch (JAX's
reshape) and the rank takes its block of that; ``B/k`` must divide over
the batch shards (``ValueError``; JAX would reshard).  The parameters are
gathered once before the first microbatch and the gradients reduced once
after the last.  The loss is a sum over ranks of per-rank terms
(``models/registry.py``), so each rank backpropagates its own and
gradients sum; ``loss``, ``ce`` and ``aux`` are reported all-reduced, the
grad norm counts every element once and AdamW updates each rank's block.
The adaptive step aggregates its telemetry over the batch group
(``fleet/collect.aggregate_records``), so every rank's controller sees the
fleet's records.  Without a mesh the same body runs on the whole batch
with nothing gathered, reduced or all-reduced.  A ``"model"`` axis of
several ranks without ``dp_only`` carries tensor parallelism (``heads``,
``ff``, ``vocab``; ``seq`` with ``seq_shard``; ``train/distributed.py``):
the model ranks of a batch shard take the same rows, compute with their
blocks, and each backpropagates its share of the loss, so ``loss``,
``ce`` and ``aux`` are all-reduced over every rank; the adaptive records
of those ranks are the same, the one-rank records of their rows.  JAX's
default ``ParallelConfig()`` (``fsdp``, ``seq_shard``, ``remat="layer"``,
``ep``) trains on a ``("data", "model")`` mesh.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.fleet.collect import aggregate_records
from repro_torch.launch.mesh import tree_paths, tree_unflatten
from repro_torch.launch.sharding import current_mesh, mesh_shape, set_mesh_ctx
from repro_torch.models import init_params, train_loss
from repro_torch.runtime.scope import ax_scope

from . import distributed as D
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["make_train_step", "init_train_state", "fresh_train_state", "check_parallel"]


def init_train_state(params, opt_cfg: AdamWConfig):
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def fresh_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, *, seed: int = 0,
                      device="cuda"):
    """``init_train_state`` of ``models.init_params(cfg, seed=, device=)``."""
    return init_train_state(init_params(cfg, seed=seed, device=device), opt_cfg)


def check_parallel(par: ParallelConfig, adaptive: bool = False, mesh=None) -> None:
    """Refuse what the port cannot do (``ValueError``).  Beside the knobs'
    own values and the adaptive step's limits, on a mesh: one without a
    ``"model"`` axis needs ``dp_only`` (JAX's ``param_spec`` raises
    ``KeyError`` there).  At step time (:func:`make_train_step`'s body): a
    global batch whose microbatches do not divide over the batch shards
    (JAX would reshard; the port takes equal blocks), and under
    ``seq_shard`` with tensor parallelism a sequence (and, for the
    encoder-decoder, a frame count) that does not divide over the model
    ranks (JAX would pad the shards; the port's seq shards are equal), and
    an SSD whose ``din`` splits over the model ranks while its heads do not
    (JAX would split a head's channels; the port's SSD is parallel over
    whole heads)."""
    if par.remat not in ("none", "layer"):
        raise ValueError(f"remat={par.remat!r}: the port recomputes whole layers "
                         f"('layer') or nothing ('none'); JAX's 'dots' policy has no "
                         f"counterpart")
    if par.grad_compress not in ("none", "bf16"):
        raise ValueError(f"grad_compress: 'none' or 'bf16', not {par.grad_compress!r}")
    if par.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1: {par.grad_accum}")
    if adaptive and par.grad_accum > 1:
        raise ValueError("adaptive SWAPPER training requires grad_accum=1")
    if adaptive and par.remat != "none":
        raise ValueError("adaptive SWAPPER training requires remat='none'")
    if mesh is None:
        return
    names = mesh_shape(mesh).axis_names
    if not par.dp_only and "model" not in names:
        raise ValueError(f"a train mesh {names} without dp_only needs a 'model' axis: "
                         f"the rules put heads, ff and vocab on it (JAX's param_spec "
                         f"raises KeyError); give it one of size 1, or set dp_only")


def _check_tp(cfg: ModelConfig, batch, tp) -> None:
    """The step-time refusals of tensor parallelism (``check_parallel``)."""
    if tp.seq:
        for key in ("tokens", "frames", "embeds"):
            if key in batch and batch[key].shape[1] % tp.n:
                raise ValueError(f"seq_shard: a {key} length of {batch[key].shape[1]} does "
                                 f"not divide over {tp.n} model ranks (JAX would pad the "
                                 f"shards; the port takes equal ones)")
    if cfg.family == "ssm":
        din = cfg.ssm_expand * cfg.d_model
        if din % tp.n == 0 and (din // cfg.ssm_head_dim) % tp.n:
            raise ValueError(f"SSD: din {din} splits over {tp.n} model ranks but its "
                             f"{din // cfg.ssm_head_dim} heads do not (the port's SSD is "
                             f"parallel over whole heads)")


def _to_device(batch, device):
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v)))
            .to(device) for k, v in batch.items()}


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach() if torch.is_tensor(tree) else tree


def make_train_step(cfg: ModelConfig, par: Optional[ParallelConfig], opt_cfg: AdamWConfig,
                    adaptive: bool = False, tile_rows: int = 0, mesh=None):
    """Returns ``step(state, batch)``, or ``step(state, batch, ax_dyn)`` with
    ``adaptive`` (module note).  With ``par.grad_accum = k`` the batch is
    split into k microbatches along its first axis, their gradients summed
    in f32 and divided by k, and the loss is their mean (``aux`` is then
    reported as 0, as in JAX).  ``mesh`` (or the mesh context the step is
    called in) makes it the sharded step (module note)."""
    par = par or ParallelConfig()
    check_parallel(par, adaptive, mesh)

    def body(state, batch, dyn, tm):
        """The step on one device (``tm`` None) or on a rank of the train
        mesh ``tm`` (module note)."""
        params = state["params"]
        paths, blocks = tree_paths(params)
        plans = [tm.plans(cfg, opt_cfg)[p] for p in paths] if tm is not None else None
        device = blocks[0].device
        batch = _to_device(batch, device)
        if dyn is not None:
            dyn = {name: v.to(device) for name, v in dyn.items()}
        k = par.grad_accum
        B = next(iter(batch.values())).shape[0]
        _, index, n = tm.batch if tm is not None else (None, 0, 1)
        if B % k or (B // k) % n:
            raise ValueError(f"a global batch of {B} rows in {k} microbatches of {B // k} does "
                             f"not divide over {n} batch shards "
                             f"{tm.batch_axes if tm is not None else ()} (JAX would reshard; "
                             f"the port takes equal blocks)")
        m = B // k // n
        if tm is not None and tm.tp is not None:
            _check_tp(cfg, batch, tm.tp)
        live = [x.detach().requires_grad_(True) for x in blocks]
        with torch.enable_grad():
            gathered = ([D.gather_leaf(x, plan.gather) for x, plan in zip(live, plans)]
                        if tm is not None else live)
        full = [g.detach().requires_grad_(True) for g in gathered]
        full_tree = tree_unflatten(params, full)
        acc, term_sum, metrics = None, None, {}
        for j in range(k):
            lo = j * (B // k) + index * m
            mb = {name: v[lo:lo + m] for name, v in batch.items()}
            with torch.enable_grad():
                if dyn is None:
                    term, metrics = train_loss(full_tree, mb, cfg, par)
                else:
                    # the records are made inside the differentiated forward:
                    # they leave it through the metrics, detached
                    with ax_scope(dyn, collect=True, tile_rows=tile_rows) as sc:
                        term, metrics = train_loss(full_tree, mb, cfg, par)
                    metrics = dict(metrics, ax_telemetry=sc.collected())
                g = torch.autograd.grad(term, full, allow_unused=True)
            # a parameter the loss does not reach gets a zero gradient
            g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(full, g)]
            if k > 1:
                # microbatch gradients summed in f32, then divided by k
                g = [gi.to(torch.float32) for gi in g]
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
            else:
                acc = g
            term_sum = term.detach() if term_sum is None else term_sum + term.detach()
        # the gathers' backward: reduce-scatter each gathered gradient to the block
        idx = [i for i, plan in enumerate(plans or ()) if plan.gather]
        if idx:
            back = torch.autograd.grad([gathered[i] for i in idx], [live[i] for i in idx],
                                       grad_outputs=[acc[i] for i in idx])
            for i, b in zip(idx, back):
                acc[i] = b
        # the update needs the room: nothing of the forward or backward outlives it
        del live, gathered, full, full_tree, g
        with torch.no_grad():
            grads = tm.reduce_grads(acc, plans) if tm is not None else acc
            del acc
            if k > 1:
                grads = [g / k for g in grads]
            # every rank's terms sum to the loss (``models/registry.py``)
            group = tm.world_group if tm is not None else None
            if k > 1:
                # the loss is the microbatches' mean; aux is reported as 0, as in JAX
                vals = D.all_reduce_sum(term_sum.reshape(1), group)
                loss = vals[0] / k
                out = {"ce": loss, "aux": torch.zeros_like(loss)}
            else:
                vals = D.all_reduce_sum(torch.stack([term_sum, metrics["ce"].detach(),
                                                     metrics["aux"].detach()]), group)
                loss = vals[0]
                out = dict(metrics, ce=vals[1], aux=vals[2])
            if dyn is not None and tm is not None:
                out["ax_telemetry"] = aggregate_records(out["ax_telemetry"], tm.batch_group)
        kw = {}
        if tm is not None:
            # every rank holds blocks: each counts its leaves once over the world
            kw = dict(replicas=[p.replicas for p in plans], group=tm.world_group)
        new_params, new_opt, opt_metrics = adamw_update(tree_unflatten(params, grads),
                                                        state["opt"], params, opt_cfg, **kw)
        return ({"params": new_params, "opt": new_opt},
                dict(_detach(out), loss=loss, **opt_metrics))

    def run(state, batch, dyn=None):
        mesh_ = mesh if mesh is not None else current_mesh()
        if mesh_ is None:
            return body(state, batch, dyn, None)
        if mesh is None:
            check_parallel(par, adaptive, mesh_)
        tm = D.train_mesh(mesh_, par)
        with set_mesh_ctx(mesh_, par, groups=tm):
            return body(state, batch, dyn, tm)

    if not adaptive:
        return lambda state, batch: run(state, batch)
    return lambda state, batch, ax_dyn: run(state, batch, ax_dyn)

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

``ParallelConfig`` (``configs/base.py``) on one device: ``remat="layer"``
is ``torch.utils.checkpoint`` per layer of a decoder-only stack,
``remat="dots"`` raises, and the sharded settings raise (ROADMAP queue 1,
item 8b: the sharded train step).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import init_params, train_loss
from repro_torch.runtime.scope import ax_scope

from .optimizer import AdamWConfig, adamw_init, adamw_update, tree_leaves, tree_map

__all__ = ["make_train_step", "init_train_state", "fresh_train_state", "check_parallel"]


def init_train_state(params, opt_cfg: AdamWConfig):
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def fresh_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, *, seed: int = 0,
                      device="cuda"):
    """``init_train_state`` of ``models.init_params(cfg, seed=, device=)``."""
    return init_train_state(init_params(cfg, seed=seed, device=device), opt_cfg)


def check_parallel(par: ParallelConfig, adaptive: bool = False) -> None:
    """Refuse what one device cannot do (module note)."""
    if par.remat not in ("none", "layer"):
        raise ValueError(f"remat={par.remat!r}: the port recomputes whole layers "
                         f"('layer') or nothing ('none'); JAX's 'dots' policy has no "
                         f"counterpart")
    sharded = [f for f in ("fsdp", "seq_shard", "ep", "dp_only") if getattr(par, f)]
    if sharded or par.grad_compress != "none":
        raise NotImplementedError(
            f"ParallelConfig {sharded or ['grad_compress=' + par.grad_compress]}: sharded "
            f"training is ROADMAP queue 1, item 8b (the sharded train step)")
    if par.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1: {par.grad_accum}")
    if adaptive and par.grad_accum > 1:
        raise ValueError("adaptive SWAPPER training requires grad_accum=1")
    if adaptive and par.remat != "none":
        raise ValueError("adaptive SWAPPER training requires remat='none'")


def _to_device(batch, device):
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v)))
            .to(device) for k, v in batch.items()}


def _value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``; a parameter
    the loss does not reach gets a zero gradient."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
    return loss.detach(), metrics, tree_map(lambda _: next(it), live)


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach() if torch.is_tensor(tree) else tree


def make_train_step(cfg: ModelConfig, par: Optional[ParallelConfig], opt_cfg: AdamWConfig,
                    adaptive: bool = False, tile_rows: int = 0):
    """Returns ``step(state, batch)``, or ``step(state, batch, ax_dyn)`` with
    ``adaptive`` (module note).  With ``par.grad_accum = k`` the batch is
    split into k microbatches along its first axis, their gradients summed
    in f32 and divided by k, and the loss is their mean (``aux`` is then
    reported as 0, as in JAX)."""
    par = par or ParallelConfig()
    check_parallel(par, adaptive)

    def loss_fn(params, batch):
        return train_loss(params, batch, cfg, par)

    def finish(state, grads, loss, metrics):
        new_params, new_opt, opt_metrics = adamw_update(grads, state["opt"], state["params"],
                                                        opt_cfg)
        metrics = dict(_detach(metrics), loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    def step(state, batch):
        params = state["params"]
        batch = _to_device(batch, tree_leaves(params)[0].device)
        k = par.grad_accum
        if k <= 1:
            loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
            return finish(state, grads, loss, metrics)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        for i in range(k):
            mb = {n: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))[i]
                  for n, v in batch.items()}
            l_i, _, g = _value_and_grad(loss_fn, params, mb)
            with torch.no_grad():
                grads = tree_map(lambda a, b: a + b.to(torch.float32), grads, g)
                loss = loss + l_i
        with torch.no_grad():
            grads = tree_map(lambda g: g / k, grads)
            loss = loss / k
        return finish(state, grads, loss, {"ce": loss, "aux": torch.zeros_like(loss)})

    if not adaptive:
        return step

    def adaptive_step(state, batch, ax_dyn):
        params = state["params"]
        device = tree_leaves(params)[0].device
        batch = _to_device(batch, device)
        dyn = {n: v.to(device) for n, v in ax_dyn.items()}

        def loss_fn_dyn(params, batch):
            # the records are made inside the differentiated forward: they
            # leave it through the metrics, detached
            with ax_scope(dyn, collect=True, tile_rows=tile_rows) as sc:
                loss, metrics = train_loss(params, batch, cfg, par)
            return loss, dict(metrics, ax_telemetry=sc.collected())

        loss, metrics, grads = _value_and_grad(loss_fn_dyn, params, batch)
        return finish(state, grads, loss, metrics)

    return adaptive_step

"""Parameters and decode caches of the JAX package as the port's.

``params_from_jax`` takes the JAX package's parameter tree with numpy
leaves (``jax.device_get`` of ``repro.models.init_params``; the caller does
that, the port never imports JAX) and returns the port's dict of tensors on
``device``; ``cache_from_jax`` does the same for a decode cache
(``repro.models.init_cache`` or a prefill's).  The JAX stack keeps its
leading heterogeneous layers as ``lead{i}``, scan-stacks each position j of
the repeating pattern under ``layers/p{j}`` (``stack/p{j}`` in a cache)
with a leading period axis, and keeps the pattern's remainder as
``rest{i}``; the port's stack is one plain list in layer order:

    lead{i}           -> layer i
    layers/p{j}[n]    -> layer first_dense + n * len(period) + j
    rest{i}           -> layer first_dense + n_periods * len(period) + i

Weight layouts are the same: ``(in, out)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["params_from_jax", "cache_from_jax", "layer_order"]


def _tensor(x, device):
    return torch.from_numpy(np.array(x, copy=True, order="C")).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def layer_order(cfg: ModelConfig):
    """``[(tree key, period index or None), ...]`` in layer order: where
    layer i of the port sits in the JAX package's stack (module note)."""
    if cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder family is not ported "
                                  f"yet (ROADMAP queue 1, item 7b)")
    n = len(cfg.layer_kinds())
    lead = cfg.first_dense
    period = len(cfg.pattern) if cfg.pattern else 1
    n_periods = (n - lead) // period
    order = [(f"lead{i}", None) for i in range(lead)]
    order += [(f"p{j}", k) for k in range(n_periods) for j in range(period)]
    order += [(f"rest{i}", None) for i in range(n - lead - n_periods * period)]
    return order


def _layers(np_tree, cfg: ModelConfig, stack_key: str, device):
    order = layer_order(cfg)
    want = {key for key, k in order if k is None}
    if any(k is not None for _, k in order):
        want.add(stack_key)
    have = {k for k in np_tree if k.startswith(("lead", "rest")) or k == stack_key}
    if have != want:
        raise ValueError(f"{cfg.name}: the JAX tree has layer keys {sorted(have)}, the "
                         f"config's layout {sorted(want)}")
    out = []
    for key, k in order:
        if k is None:
            out.append(_map(np_tree[key], lambda a: _tensor(a, device)))
        else:
            out.append(_map(np_tree[stack_key][key],
                            lambda a, k=k: _tensor(np.asarray(a)[k], device)))
    return out


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    extra = {k for k in np_tree if not k.startswith(("lead", "rest"))} - {
        "embed", "ln_f", "lm_head", "layers"}
    if extra:
        raise ValueError(f"unexpected tree keys: {sorted(extra)}")
    out = {k: _map(np_tree[k], lambda a: _tensor(a, device))
           for k in ("embed", "ln_f", "lm_head") if k in np_tree}
    out["layers"] = _layers(np_tree, cfg, "layers", device)
    return out


def cache_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """A JAX decode cache (numpy leaves) as the port's per-layer list."""
    return _layers(np_tree, cfg, "stack", device)

"""Parameters of the JAX package as the port's parameters.

``params_from_jax`` takes the JAX package's parameter tree with numpy
leaves (``jax.device_get`` of ``repro.models.init_params``; the caller does
that, the port never imports JAX) and returns the port's dict of tensors on
``device``.  The JAX tree scan-stacks the dense layers under
``params["layers"]["p0"]`` with a leading layer axis; they become the
port's plain per-layer list.  Weight layouts are the same: ``(in, out)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["params_from_jax"]


def _tensor(x, device):
    return torch.from_numpy(np.array(x, copy=True, order="C")).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    if cfg.family != "dense" or any(k != "global" for k in cfg.layer_kinds()):
        raise NotImplementedError(f"{cfg.name}: only the dense family is ported")
    extra = set(np_tree) - {"embed", "ln_f", "lm_head", "layers"}
    if extra or set(np_tree["layers"]) != {"p0"}:
        raise ValueError(f"unexpected dense-family tree keys: {sorted(np_tree)}")
    out = {k: _map(np_tree[k], lambda a: _tensor(a, device))
           for k in ("embed", "ln_f", "lm_head") if k in np_tree}
    stacked = np_tree["layers"]["p0"]
    out["layers"] = [_map(stacked, lambda a, i=i: _tensor(np.asarray(a)[i], device))
                     for i in range(cfg.n_layers)]
    return out

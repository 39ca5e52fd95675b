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

Weight layouts are the same: ``(in, out)``.  ``serve_params_from_jax``
gives a serving rank only its blocks, sliced from JAX's numpy leaves.

The encoder-decoder (whisper) keeps each stack, ``layers_enc`` and
``layers_dec``, as one ``jax.vmap``-stacked tree with a leading layer axis;
the port's stacks are plain lists in layer order.  Its JAX decode cache
``{"self": {"k", "v"}, "cross"}`` (the self K/V with a leading layer axis,
the cross K/V one ``(L, 2, B, S_enc, KV, hd)`` tensor) becomes the port's
per-layer list ``{"k", "v", "xk", "xv"}`` (``models/whisper.py``).

``train_state_from_jax`` carries a JAX train state ``{"params", "opt":
{"step", "m", "v"[, "ef"]}}`` across: the moments and the error feedback
have the parameters' tree and convert as they do; bfloat16 leaves (numpy's
``ml_dtypes`` type, or its raw 2-byte view) become ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["params_from_jax", "serve_params_from_jax", "cache_from_jax", "train_state_from_jax",
           "layer_order"]


def _tensor(x, device):
    a = np.array(x, copy=True, order="C")
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def layer_order(cfg: ModelConfig):
    """``[(tree key, period index or None), ...]`` in layer order: where
    layer i of the port sits in the JAX package's stack (module note)."""
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: the encoder-decoder's stacks are layers_enc and "
                         f"layers_dec, one layer axis each (module note)")
    n = len(cfg.layer_kinds())
    lead = cfg.first_dense
    period = len(cfg.pattern) if cfg.pattern else 1
    n_periods = (n - lead) // period
    order = [(f"lead{i}", None) for i in range(lead)]
    order += [(f"p{j}", k) for k in range(n_periods) for j in range(period)]
    order += [(f"rest{i}", None) for i in range(n - lead - n_periods * period)]
    return order


def _layers(np_tree, cfg: ModelConfig, stack_key: str, leaf):
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
            out.append(_map(np_tree[key], leaf))
        else:
            out.append(_map(np_tree[stack_key][key], lambda a, k=k: leaf(np.asarray(a)[k])))
    return out


def _unstack(np_tree, n: int, leaf):
    """A tree whose leaves carry a leading layer axis of ``n`` as a list of
    ``n`` per-layer trees."""
    first = {a.shape[0] for a in _leaves(np_tree)}
    if first != {n}:
        raise ValueError(f"a stacked layer tree with leading axes {sorted(first)}, "
                         f"expected {n}")
    return [_map(np_tree, lambda a, i=i: leaf(np.asarray(a)[i])) for i in range(n)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield np.asarray(tree)


_ENCDEC_KEYS = {"embed", "pos_embed", "layers_enc", "layers_dec", "ln_enc", "ln_f"}


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    return _params(np_tree, cfg, lambda a: _tensor(a, device))


def serve_params_from_jax(np_tree, cfg: ModelConfig, mesh, par, device="cuda"):
    """This rank's blocks of :func:`params_from_jax` for the model-sharded
    prefill and decode step (``launch.parallel.serve_params``, its notes of
    each block's offsets included), each sliced from JAX's numpy leaf before
    it becomes a tensor: no whole torch tree is made (JAX's ``device_put``
    of a tree with its shardings)."""
    from repro_torch.launch.mesh import block_index, tree_paths, tree_unflatten
    from repro_torch.launch.parallel import note_blocks, serve_param_specs

    views = _params(np_tree, cfg, np.asarray)
    specs = serve_param_specs(mesh, par, views)
    local = tree_unflatten(views, [
        _tensor(v[block_index(mesh, spec, v.shape)] if any(spec) else v, device)
        for spec, v in zip(tree_paths(specs)[1], tree_paths(views)[1])])
    note_blocks(mesh, par, specs, views, local)
    return local


def _params(np_tree, cfg: ModelConfig, leaf):
    """The port's param tree of JAX's ``np_tree``, each leaf ``leaf`` of
    JAX's array (a layer's slice of a stacked one)."""
    if cfg.family == "encdec":
        if set(np_tree) != _ENCDEC_KEYS:
            raise ValueError(f"{cfg.name}: tree keys {sorted(np_tree)}, expected "
                             f"{sorted(_ENCDEC_KEYS)}")
        out = {k: _map(np_tree[k], leaf) for k in ("embed", "pos_embed", "ln_enc", "ln_f")}
        out["layers_enc"] = _unstack(np_tree["layers_enc"], cfg.n_enc_layers, leaf)
        out["layers_dec"] = _unstack(np_tree["layers_dec"], cfg.n_layers, leaf)
        return out
    extra = {k for k in np_tree if not k.startswith(("lead", "rest"))} - {
        "embed", "ln_f", "lm_head", "layers"}
    if extra:
        raise ValueError(f"unexpected tree keys: {sorted(extra)}")
    out = {k: _map(np_tree[k], leaf) for k in ("embed", "ln_f", "lm_head") if k in np_tree}
    out["layers"] = _layers(np_tree, cfg, "layers", leaf)
    return out


def cache_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """A JAX decode cache (numpy leaves) as the port's per-layer list."""
    tensor = (lambda a: _tensor(a, device))  # noqa: E731
    if cfg.family == "encdec":
        self_c = _unstack(np_tree["self"], cfg.n_layers, tensor)
        cross = np.asarray(np_tree["cross"])
        return [dict(c, xk=_tensor(cross[i, 0], device), xv=_tensor(cross[i, 1], device))
                for i, c in enumerate(self_c)]
    return _layers(np_tree, cfg, "stack", tensor)


def train_state_from_jax(np_state, cfg: ModelConfig, device="cuda"):
    """A JAX train state (numpy leaves: ``jax.device_get`` of
    ``repro.train.init_train_state`` or a step's, or a JAX checkpoint read
    by ``train.checkpoint.load_tree``) as the port's (module note)."""
    opt = np_state["opt"]
    extra = set(opt) - {"step", "m", "v", "ef"}
    if extra:
        raise ValueError(f"unexpected optimizer state keys: {sorted(extra)}")
    out_opt = {"step": _tensor(np.asarray(opt["step"], np.int32), device)}
    for k in ("m", "v", "ef"):
        if k in opt:
            out_opt[k] = params_from_jax(opt[k], cfg, device)
    return {"params": params_from_jax(np_state["params"], cfg, device), "opt": out_opt}

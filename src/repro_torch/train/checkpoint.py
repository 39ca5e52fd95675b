"""Checkpoints in the JAX package's on-disk format (``repro.train.checkpoint``):
atomic, and asynchronous on request.

A checkpoint of step n is ``step_{n}.npz``, whose entries ``a{i}`` hold the
state's leaves in the sorted order of their '/'-joined tree paths (a dict
key, or a list index as in JAX's sequence keys), and ``step_{n}.json`` with
``step``, ``names`` (those paths), ``extra`` (the caller's: data-pipeline
state, the train step) and ``dtypes``.  Each file is written to a temporary
name and renamed, so a crash mid-save never corrupts the newest checkpoint.
A bfloat16 leaf is stored as its raw 16-bit pattern (numpy has no bfloat16
without ``ml_dtypes``) under the dtype name ``bfloat16``, and read back
from a checkpoint of either package by that name.

``restore`` puts each leaf on ``device``, the card unless the caller says
otherwise (JAX's restore puts it on the default device).  With
``sharding_tree`` (a tree of ``launch.sharding.PartitionSpec`` shaped like
the state) it places each leaf by its spec on the current mesh, the
elastic restore onto another mesh: a replicated spec gives the whole leaf
on the rank's device, a sharded one the rank's block (the port is
multi-process SPMD, so a rank holds its shard as a plain tensor, and
``like`` describes the rank's own state).  :func:`gather_state` is the way
back: the whole state on every rank, for rank 0 to save.  ``load_tree`` reads a checkpoint as a nested dict of numpy
arrays: a JAX train state read so goes to ``convert.train_state_from_jax``.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.launch.mesh import block_index as _block

__all__ = ["save", "restore", "gather_state", "latest_step", "load_tree", "AsyncCheckpointer"]


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _to_numpy(x):
    """(numpy array, dtype name) of a leaf; bfloat16 as its 16-bit pattern."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    return x, str(x.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def save(ckpt_dir: str, step: int, state, extra: Optional[dict] = None) -> str:
    """Write ``state`` (nested dicts and lists of tensors or arrays) as the
    checkpoint of ``step``; returns the ``.npz`` path."""
    return _write(ckpt_dir, step, {k: _to_numpy(v) for k, v in _flatten(state).items()},
                  extra)


def _write(ckpt_dir: str, step: int, flat: dict, extra: Optional[dict]) -> str:
    """Write {path: (array, dtype name)} atomically (module note)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    names = sorted(flat)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}.npz")
    final = os.path.join(ckpt_dir, f"step_{step}.npz")
    np.savez(tmp, **{f"a{i}": flat[k][0] for i, k in enumerate(names)})
    os.replace(tmp, final)
    manifest = {"step": step, "names": names, "extra": extra or {},
                "dtypes": {k: flat[k][1] for k in names}}
    mtmp = os.path.join(ckpt_dir, f".tmp_step_{step}.json")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(ckpt_dir, f"step_{step}.json"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(fn[len("step_"):-len(".json")]) for fn in os.listdir(ckpt_dir)
             if fn.startswith("step_") and fn.endswith(".json")]
    return max(steps) if steps else None


def _load(ckpt_dir: str, step: int):
    with open(os.path.join(ckpt_dir, f"step_{step}.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(ckpt_dir, f"step_{step}.npz")) as data:
        flat = {k: data[f"a{i}"] for i, k in enumerate(manifest["names"])}
    return flat, manifest


def load_tree(ckpt_dir: str, step: int):
    """(nested dict of numpy arrays keyed by the path parts, extra); a
    bfloat16 leaf comes back as its 16-bit pattern, a ``uint16`` array."""
    flat, manifest = _load(ckpt_dir, step)
    tree = {}
    for path, a in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        if manifest["dtypes"].get(path) == "bfloat16":
            a = np.ascontiguousarray(a).view(np.uint16)
        node[leaf] = a
    return tree, manifest["extra"]


def restore(ckpt_dir: str, step: int, like, device="cuda", sharding_tree=None, mesh=None):
    """Restore into the structure of ``like`` (nested dicts and lists of
    tensors or anything with a ``shape``), each leaf on ``device``.
    ``sharding_tree`` (shaped like ``like``; a ``None`` leaf is replicated)
    places each leaf by its spec on ``mesh``, the mesh context's when None
    (module note); ``like`` then holds the rank's block shapes.  Returns
    (state, extra)."""
    flat, manifest = _load(ckpt_dir, step)
    dtypes = manifest["dtypes"]
    if sharding_tree is not None and mesh is None:
        from repro_torch.launch.sharding import current_mesh

        mesh = current_mesh()
        if mesh is None:
            raise ValueError("restore(sharding_tree=): no mesh given and no mesh context")

    def build(node, spec, prefix):
        if isinstance(node, dict):
            return {k: build(v, None if spec is None else spec[k],
                             f"{prefix}/{k}" if prefix else str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, None if spec is None else spec[i],
                          f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(node)]
        if prefix not in flat:
            raise KeyError(f"checkpoint step {step} in {ckpt_dir} has no leaf {prefix!r}")
        t = _from_numpy(flat[prefix], dtypes.get(prefix, str(flat[prefix].dtype)))
        if spec is not None and any(spec):
            t = t[_block(mesh, spec, tuple(t.shape))]
        if tuple(t.shape) != tuple(node.shape):
            raise ValueError(f"{prefix}: checkpoint shape {tuple(t.shape)}, expected "
                             f"{tuple(node.shape)}")
        return t.contiguous().to(device)

    return build(like, sharding_tree, ""), manifest["extra"]


def gather_state(state, sharding_tree, mesh):
    """The whole state on every rank from each rank's blocks (the inverse
    of ``restore(sharding_tree=)``): each sharded dim all-gathered over its
    mesh axes (several axes as one group, row-major,
    ``launch.mesh.axes_group``) and its blocks concatenated in rank
    order."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import axes_group

    def build(node, spec):
        if isinstance(node, dict):
            return {k: build(v, None if spec is None else spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, None if spec is None else spec[i]) for i, v in enumerate(node)]
        if spec is None or not any(spec):
            return node
        for d, ax in enumerate(spec):
            if not ax:
                continue
            group, _, n = axes_group(mesh, ax)
            x = node.contiguous()
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
            node = torch.cat(parts, dim=d)
        return node

    return build(state, sharding_tree)


class AsyncCheckpointer:
    """Background-thread saver: the state is copied to host memory before
    ``save_async`` returns, the files are written on a thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, ckpt_dir: str, step: int, state, extra=None):
        self.wait()
        host = {k: (np.array(a, copy=True), d)
                for k, (a, d) in ((k, _to_numpy(v)) for k, v in _flatten(state).items())}
        self._thread = threading.Thread(target=_write, args=(ckpt_dir, step, host, extra),
                                        daemon=True)
        self._thread.start()

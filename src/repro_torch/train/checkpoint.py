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
otherwise (JAX's restore puts it on the default device).  JAX's ``sharding_tree`` (a restore onto another mesh)
waits for the device mesh, ROADMAP queue 1, item 8: this ``restore`` has no
such argument.  ``load_tree`` reads a checkpoint as a nested dict of numpy
arrays: a JAX train state read so goes to ``convert.train_state_from_jax``.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "load_tree", "AsyncCheckpointer"]


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


def restore(ckpt_dir: str, step: int, like, device="cuda"):
    """Restore into the structure of ``like`` (nested dicts and lists of
    tensors or anything with a ``shape``), each leaf on ``device``.
    Returns (state, extra)."""
    flat, manifest = _load(ckpt_dir, step)
    dtypes = manifest["dtypes"]

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(node)]
        if prefix not in flat:
            raise KeyError(f"checkpoint step {step} in {ckpt_dir} has no leaf {prefix!r}")
        t = _from_numpy(flat[prefix], dtypes.get(prefix, str(flat[prefix].dtype)))
        if tuple(t.shape) != tuple(node.shape):
            raise ValueError(f"{prefix}: checkpoint shape {tuple(t.shape)}, expected "
                             f"{tuple(node.shape)}")
        return t.to(device)

    return build(like, ""), manifest["extra"]


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

"""Logical-axis sharding rules (``repro.launch.sharding``) on a torch mesh.

Parameters and activations carry *logical* axis names; the rules map them
onto mesh axes, as the JAX package's do:

    batch   -> ('pod', 'data') on the multi-pod mesh, 'data' on one pod
    embed   -> 'data' when FSDP is on (2-D weight sharding), else replicated
    heads/ff/vocab -> 'model', experts -> 'model' with ``ep``
    seq     -> 'model' with sequence-parallel residuals
    kv_seq  -> 'model'                  (the decode cache's sequence dim)

A spec is a :class:`PartitionSpec` of this module: a tuple whose entries
are a mesh axis name, a tuple of names or ``None``, printed as JAX prints
its ``PartitionSpec``.  The functions take a mesh's *shape*
(:class:`MeshShape`: axis names and sizes), built from a torch
``DeviceMesh`` by :func:`mesh_shape` or given directly, so the specs of
the 256- and 512-chip meshes are computed without a world.

**Multi-process SPMD.**  The port runs one process per device, and a
tensor in a rank's hands is already that rank's shard: :func:`shard`
checks the logical axes against the tensor's rank and returns it as it
is (the JAX package's ``with_sharding_constraint`` has nothing to
constrain here).  :func:`set_mesh_ctx` installs a mesh and its rules for
the code inside it; ``models/blocks.py`` reads them (per-shard MoE
capacity).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Tuple

__all__ = ["PartitionSpec", "MeshShape", "mesh_shape", "axis_rules", "set_mesh_ctx",
           "current_mesh", "current_rules", "shard", "spec_for", "param_spec",
           "axis_size"]

_ctx = threading.local()


class PartitionSpec(tuple):
    """A partition spec: one entry per dim, a mesh axis name, a tuple of
    names or ``None``; a one-name tuple is stored as the name, as JAX
    stores it.  Equal to the tuple of its entries; printed as
    ``PartitionSpec('data', 'model')``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self):
        return f"PartitionSpec({', '.join(repr(p) for p in self)})"

    __str__ = __repr__


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axis names {self.axis_names} and sizes {self.sizes} differ "
                             f"in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of a ``DeviceMesh`` (or of a MeshShape, or of
    anything with ``axis_names`` and a ``shape`` mapping, such as a JAX
    ``AbstractMesh``)."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                      # torch DeviceMesh
        return MeshShape(tuple(names), tuple(int(s) for s in mesh.shape))
    shape = mesh.shape
    return MeshShape(tuple(mesh.axis_names), tuple(int(shape[a]) for a in mesh.axis_names))


def axis_size(mesh, ax) -> int:
    """The product of the sizes of the mesh axes ``ax`` (a name, a tuple of
    names, or None for 1)."""
    shape = mesh_shape(mesh).shape
    names = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
    n = 1
    for nm in names:
        n *= shape[nm]
    return n


def axis_rules(mesh, par) -> dict:
    """The logical -> mesh axis rules of ``par`` on ``mesh``
    (``repro.launch.sharding.axis_rules``)."""
    names = mesh_shape(mesh).axis_names
    if par.dp_only:
        # small models: no tensor parallelism; the 'model' axis joins the
        # batch and parameters FSDP-shard over 'data'
        batch_axes = tuple(a for a in ("pod", "data", "model") if a in names)
        return {
            "batch": batch_axes,
            "embed": "data" if par.fsdp else None,
            "heads": None, "kv_heads": None, "ff": None, "vocab": None,
            "experts": "model" if par.ep else None,
            "seq": None, "kv_seq": None, "layers": None, None: None,
        }
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    return {
        "batch": batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes else None),
        "embed": "data" if par.fsdp else None,
        "heads": "model",
        "kv_heads": None,        # GQA kv-head counts often < mesh model size
        "ff": "model",
        "vocab": "model",
        "experts": "model" if par.ep else None,
        "seq": "model" if par.seq_shard else None,
        "kv_seq": "model",
        "layers": None,
        None: None,
    }


@contextlib.contextmanager
def set_mesh_ctx(mesh, par):
    """Install ``mesh`` (a ``DeviceMesh`` or a :class:`MeshShape`) and the
    rules of ``par`` for the code inside; yields the rules."""
    rules = axis_rules(mesh, par)
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules)
    try:
        yield rules
    finally:
        _ctx.state = prev


def current_mesh():
    st = getattr(_ctx, "state", None)
    return st[0] if st else None


def current_rules() -> Optional[dict]:
    st = getattr(_ctx, "state", None)
    return st[1] if st else None


def _names(ax) -> Tuple[str, ...]:
    return ax if isinstance(ax, tuple) else ((ax,) if ax else ())


def _dedup(parts):
    """A mesh axis may appear at most once in a spec: keep the first
    occurrence (MoE expert weights shard 'experts' over model; their 'ff'
    dim then stays unsharded)."""
    seen = set()
    out = []
    for ax in parts:
        names = _names(ax)
        if any(n in seen for n in names):
            out.append(None)
        else:
            seen.update(names)
            out.append(ax)
    return out


def spec_for(logical_axes: Tuple, rules=None) -> PartitionSpec:
    """The spec of ``logical_axes`` under ``rules`` (the installed rules
    when None; an empty spec outside a mesh context)."""
    if rules is None:
        rules = current_rules()
        if rules is None:
            return PartitionSpec()
    return PartitionSpec(*_dedup([rules.get(a, None) for a in logical_axes]))


def shard(x, *logical_axes):
    """``x`` itself: under multi-process SPMD a rank's tensor is already its
    local shard (module note).  Inside a mesh context the logical axes must
    name every dim of ``x``, as JAX asserts."""
    if current_rules() is not None and len(logical_axes) != x.dim():
        raise ValueError(f"shard: logical axes {logical_axes} for a tensor of shape "
                         f"{tuple(x.shape)}")
    return x


def param_spec(logical_axes: Tuple, mesh, par, shape=None) -> PartitionSpec:
    """The spec of a parameter: the rules' axes, a repeated mesh axis kept
    at its first occurrence, and with ``shape`` each constraint that does
    not divide its dim dropped."""
    rules = axis_rules(mesh, par)
    spec = _dedup([rules.get(a, None) for a in logical_axes])
    if shape is not None:
        for i, (dim, ax) in enumerate(zip(shape, spec)):
            size = axis_size(mesh, ax)
            if size == 0 or dim % size != 0:
                spec[i] = None
    return PartitionSpec(*spec)

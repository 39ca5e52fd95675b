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
capacity).  A mesh's groups (``launch/parallel.py``'s ``MeshGroups``; the
sharded train step's ``TrainMesh`` adds its per-leaf plans to them) travel
with it, and the loss and the MoE block read them through
:func:`current_groups`; with tensor parallelism over ``"model"`` the models
take their ``TensorParallel`` through :func:`current_tp`: the model group,
this rank's index and offsets into
``heads``, ``ff``, ``vocab`` and ``seq`` (``TensorParallel.block``), and
the collectives of a block's entry and exit.  All of it travels in one
installed state, which :func:`recompute_context` re-installs for a layer
recomputed in the backward, so the recomputation repeats its collectives
in order.

**The model-sharded prefill and decode step.**  Outside the train step,
:func:`set_mesh_ctx` of a ``DeviceMesh`` whose ``"model"`` axis has several
ranks (and no ``dp_only``) installs the mesh's groups
(``launch.parallel.mesh_groups``, made once per mesh and ``par``), so
:func:`current_tp` gives the models the same ``TensorParallel`` in
``models.registry.prefill`` and ``decode_step``.
Those entry points narrow the installed state for the call
(:func:`serving`): a decode step's residual is whole over ``seq`` (one
token does not split), and :func:`current_kv` names the group that holds
a K/V cache's sequence, as ``launch.mesh.cache_shardings`` places it.  A
1-D ``("data",)`` fleet mesh (``launch.mesh.make_fleet_mesh``) and a
:class:`MeshShape` install no collectives.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, NamedTuple, Optional, Tuple

__all__ = ["PartitionSpec", "MeshShape", "mesh_shape", "axis_rules", "set_mesh_ctx",
           "current_mesh", "current_rules", "current_groups", "current_tp", "current_kv",
           "current_rows", "serving", "recompute_context", "shard", "spec_for", "param_spec",
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


class _State(NamedTuple):
    mesh: object
    rules: dict
    groups: object           # the mesh's MeshGroups (a TrainMesh in a train step), or None
    tp: object               # the models' TensorParallel, or None
    kv: object               # (group, index, n) of a K/V cache's sequence, or None
    rows: object = None      # (lo, hi, B, group) of a global batch split over the batch axes


def _model_sharded(mesh, par) -> bool:
    """A ``DeviceMesh`` whose ``"model"`` axis carries tensor parallelism."""
    names = getattr(mesh, "mesh_dim_names", None)
    return (names is not None and "model" in names and not par.dp_only
            and axis_size(mesh, "model") > 1)


@contextlib.contextmanager
def set_mesh_ctx(mesh, par, groups=None):
    """Install ``mesh`` (a ``DeviceMesh`` or a :class:`MeshShape`) and the
    rules of ``par`` for the code inside; yields the rules.  ``groups``: the
    sharded train step's ``TrainMesh``; without it, a model-sharded
    ``DeviceMesh`` installs its own groups for the prefill and decode step
    (module note)."""
    rules = axis_rules(mesh, par)
    if groups is None and _model_sharded(mesh, par):
        from repro_torch.launch.parallel import mesh_groups

        groups = mesh_groups(mesh, par)
    with _installed(_State(mesh, rules, groups, groups.tp if groups is not None else None,
                           None)):
        yield rules


@contextlib.contextmanager
def serving(tp, kv, rows=None):
    """The installed state with ``tp`` (the models' ``TensorParallel`` for
    this call), ``kv`` (the K/V cache's sequence group) and ``rows`` for
    the code inside: ``models.registry``'s model-sharded prefill and decode
    step.  ``rows`` = ``(lo, hi, B, group)``: the call computes rows lo..hi
    of a global batch of ``B`` split over the batch axes' ``group`` (None:
    every row)."""
    st = getattr(_ctx, "state", None)
    if st is None:
        raise ValueError("serving() needs an installed mesh context (set_mesh_ctx)")
    with _installed(st._replace(tp=tp, kv=kv, rows=rows)):
        yield


@contextlib.contextmanager
def _installed(state):
    prev = getattr(_ctx, "state", None)
    _ctx.state = state
    try:
        yield
    finally:
        _ctx.state = prev


def recompute_context():
    """A ``torch.utils.checkpoint`` ``context_fn``: a layer recomputed in
    the backward pass runs under the mesh context its forward ran in.  The
    context is thread-local, and on the card autograd runs the backward,
    recomputations included, on a device thread of its own."""
    return contextlib.nullcontext(), _installed(getattr(_ctx, "state", None))


def current_mesh():
    st = getattr(_ctx, "state", None)
    return st.mesh if st else None


def current_rules() -> Optional[dict]:
    st = getattr(_ctx, "state", None)
    return st.rules if st else None


def current_groups():
    """The installed mesh's groups (``launch.parallel.MeshGroups``): the
    sharded train step's ``TrainMesh``, or a model-sharded mesh's own
    (module note); None otherwise."""
    st = getattr(_ctx, "state", None)
    return st.groups if st else None


def current_tp():
    """The ``launch.parallel.TensorParallel`` the models compute with: the
    sharded train step's, or the installed model-sharded mesh's (a decode
    step's without ``seq``, module note).  None outside a mesh context and
    on a mesh whose ``"model"`` axis carries no tensor parallelism (one
    rank, or ``dp_only``)."""
    st = getattr(_ctx, "state", None)
    return st.tp if st else None


def current_kv():
    """(group, index, n) of the ranks that hold a K/V cache's sequence in the
    model-sharded prefill or decode step running now (:func:`serving`), or
    None."""
    st = getattr(_ctx, "state", None)
    return st.kv if st else None


def current_rows():
    """``(lo, hi, B, group)`` of the global batch whose rows lo..hi the
    model-sharded prefill or decode step running now computes, when its
    batch is split over the batch axes (:func:`serving`); else None.  The
    adaptive records read the whole batch's sampled rows through it
    (``runtime.telemetry.tp_operands``), and a tile grid indexes the whole
    batch's row tiles (``quant.ax``)."""
    st = getattr(_ctx, "state", None)
    return st.rows if st else None


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

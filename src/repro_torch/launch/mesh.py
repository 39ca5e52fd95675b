"""Device meshes and the spec trees of the port's state
(``repro.launch.mesh``), over ``torch.distributed``.

The port is **multi-process SPMD**: one process (rank) per device, every
rank running the same host logic.  A torch ``DeviceMesh`` names the ranks'
axes, as a JAX ``Mesh`` names its devices'.

* :func:`make_fleet_mesh` — the 1-D ``("data",)`` serving mesh: each rank
  holds the full weights and serves its slice of the slot batch, and the
  fleet telemetry is reduced over the mesh's process group
  (``fleet/collect.py``).  ``nccl`` on the card, ``gloo`` when the caller
  asks for the CPU or for ``backend="gloo"`` (two ranks may then share one
  card: ``nccl`` refuses that).
* :func:`make_production_mesh` — the dry-run meshes, (16, 16) ``("data",
  "model")`` and (2, 16, 16) ``("pod", "data", "model")``: built when the
  world has those ranks; their shapes (:func:`production_mesh_shape`) are
  always available to the spec functions.
* :func:`param_shardings`, :func:`state_shardings`,
  :func:`batch_shardings`, :func:`cache_shardings` — partition specs
  (``launch/sharding.PartitionSpec``) over the port's param, train-state,
  batch and decode-cache trees, equal to the JAX package's specs of the
  same leaves.  The port keeps its layers as a list (``layers/{i}/...``,
  ``layers_enc``/``layers_dec`` for whisper) where JAX scan-stacks them:
  a port layer's spec is JAX's stacked spec without its leading layer
  axis.  The trees may hold tensors of any device; ``init_params(cfg,
  device="meta")`` and ``init_cache(..., device="meta")`` give full-size
  ones without allocating.
* :func:`spawn` — run a function on N ranks of a fresh world (spawned
  processes, a ``FileStore`` rendezvous in a temporary directory, a hard
  timeout after which every child is killed): the serve CLI's ``--fleet
  N``, ``examples/torch_fleet_serve.py`` and the tests use it.  Under
  ``torchrun`` the world comes from its environment instead.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import axes_for_path

from .sharding import MeshShape, PartitionSpec, axis_size, mesh_shape, param_spec

__all__ = ["make_fleet_mesh", "make_production_mesh", "production_mesh_shape",
           "param_shardings", "state_shardings", "batch_shardings", "cache_shardings",
           "tree_paths", "tree_unflatten", "init_world", "spawn", "default_backend"]

DEFAULT_TIMEOUT_S = 300.0


def default_backend(device) -> str:
    """``nccl`` for the card, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(rank: int, world_size: int, store_path: str, *, backend: str,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join a world of ``world_size`` ranks on a ``FileStore`` at
    ``store_path`` (every rank names the same file)."""
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _bind_device(device) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def make_fleet_mesh(n: Optional[int] = None, device="cuda", backend: Optional[str] = None):
    """The 1-D ``("data",)`` serving mesh over the current world
    (``torch.distributed.device_mesh.init_device_mesh``).

    Without an initialised world: under ``torchrun`` (``WORLD_SIZE`` and
    ``MASTER_ADDR`` set) the world is joined from the environment; for
    ``n`` of None or 1 a one-rank world is made on a ``FileStore`` in a
    temporary directory.  ``ValueError`` when the world does not have
    ``n`` ranks.  The backend is ``backend``, else ``nccl`` for the card
    and ``gloo`` for the CPU; a card rank binds card ``rank % count``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev_type = torch.device(device).type
    backend = backend or default_backend(device)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend)
        elif n in (None, 1):
            init_world(0, 1, os.path.join(tempfile.mkdtemp(prefix="repro_mesh_"), "store"),
                       backend=backend)
        else:
            raise ValueError(f"make_fleet_mesh({n}): no world is initialised; start the "
                             f"ranks with launch.mesh.spawn or torchrun")
    world = dist.get_world_size()
    n = n or world
    if world != n:
        raise ValueError(f"make_fleet_mesh({n}): the world has {world} ranks")
    _bind_device(device)
    return init_device_mesh(dev_type, (n,), mesh_dim_names=("data",))


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` for the 512-chip multi-pod dry run."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production ``DeviceMesh`` (:func:`production_mesh_shape`) over a
    world of exactly its ranks; ``ValueError`` otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = production_mesh_shape(multi_pod=multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != shape.size:
        raise ValueError(f"the production mesh {shape.shape} needs a world of {shape.size} "
                         f"ranks; this one has {world} (its shape alone: "
                         f"production_mesh_shape())")
    _bind_device(device)
    return init_device_mesh(torch.device(device).type, shape.sizes,
                            mesh_dim_names=shape.axis_names)


# ---------------------------------------------------------------------------
# the port's trees
# ---------------------------------------------------------------------------

def tree_paths(tree):
    """(paths, leaves) of a tree of dicts and lists, each path the
    '/'-joined keys and list indices, in insertion order; a spec is a
    leaf."""
    paths, leaves = [], []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)) and not isinstance(node, PartitionSpec):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            paths.append(prefix)
            leaves.append(node)

    walk(tree, "")
    return paths, leaves


def tree_unflatten(like, leaves: Sequence):
    """A tree shaped like ``like`` holding ``leaves`` in :func:`tree_paths`
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not isinstance(node, PartitionSpec):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def _layer_path(path: str) -> str:
    """A port parameter path as ``axes_for_path`` reads it: a layer list's
    ``layers/{i}/`` (``layers_enc``/``layers_dec`` for whisper) dropped, so
    the leaf is unstacked (module note)."""
    head, _, rest = path.partition("/")
    if head in ("layers", "layers_enc", "layers_dec") and rest:
        return rest.partition("/")[2]
    return path


def param_shardings(mesh, par, params_shape):
    """The spec tree of a param tree (``repro.launch.mesh.param_shardings``)."""
    paths, leaves = tree_paths(params_shape)
    specs = [param_spec(axes_for_path(_layer_path(p), len(leaf.shape)), mesh, par,
                        tuple(leaf.shape)) for p, leaf in zip(paths, leaves)]
    return tree_unflatten(params_shape, specs)


def state_shardings(mesh, par, state_shape):
    """Specs of a train state ``{params, opt: {step, m, v[, ef]}}``: the
    moments follow their parameters (ZeRO-style), the step is
    replicated."""
    ps = param_shardings(mesh, par, state_shape["params"])
    out = {"params": ps, "opt": {"step": PartitionSpec()}}
    for k in state_shape["opt"]:
        if k != "step":
            out["opt"][k] = ps
    return out


def _batch_axes(mesh):
    names = mesh_shape(mesh).axis_names
    axes = tuple(a for a in ("pod", "data") if a in names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _div(dim: int, mesh, ax) -> bool:
    size = axis_size(mesh, ax)
    return size > 0 and dim % size == 0


def batch_shardings(mesh, batch_specs):
    """An input batch: the leading (global batch) dim over pod + data, or
    replicated when it does not divide (a batch of 1)."""
    b = _batch_axes(mesh)
    paths, leaves = tree_paths(batch_specs)
    specs = []
    for leaf in leaves:
        parts = [None] * len(leaf.shape)
        if len(leaf.shape) >= 1 and _div(leaf.shape[0], mesh, b):
            parts[0] = b
        specs.append(PartitionSpec(*parts))
    return tree_unflatten(batch_specs, specs)


def cache_shardings(mesh, par, cache_shape, cfg: ModelConfig):
    """Decode-cache specs (``repro.launch.mesh.cache_shardings``) over the
    port's per-layer cache list, whose batch dim is dim 0 everywhere: K/V
    (and whisper's cross K/V ``xk``/``xv``) shard the batch over pod + data
    and the sequence over 'model'; with a batch that does not divide
    (long-context batch 1) the sequence shards over every axis, or over
    'model'; recurrent and SSM state shards its batch only."""
    b = _batch_axes(mesh)
    paths, leaves = tree_paths(cache_shape)
    specs = []
    for path, leaf in zip(paths, leaves):
        shp = tuple(leaf.shape)
        parts = [None] * len(shp)
        leafname = path.rsplit("/", 1)[-1]
        if leafname in ("k", "v", "xk", "xv"):
            if _div(shp[0], mesh, b):
                parts[0] = b
                if _div(shp[1], mesh, "model"):
                    parts[1] = "model"
            else:
                both = tuple(x for x in ((b if isinstance(b, tuple) else (b,)) + ("model",))
                             if x)
                if _div(shp[1], mesh, both):
                    parts[1] = both
                elif _div(shp[1], mesh, "model"):
                    parts[1] = "model"
        elif _div(shp[0], mesh, b):
            parts[0] = b
        specs.append(PartitionSpec(*parts))
    return tree_unflatten(cache_shape, specs)


# ---------------------------------------------------------------------------
# spawned worlds
# ---------------------------------------------------------------------------

def _rank_main(rank, n, store_path, backend, device, threads, timeout_s, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_world(rank, n, store_path, backend=backend, timeout_s=timeout_s)
        try:
            mesh = make_fleet_mesh(n, device=device, backend=backend)
            out = fn(rank, mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except (Exception, SystemExit):                 # reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, nprocs: int, *, args: tuple = (), device="cuda",
          backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
          threads: Optional[int] = None) -> list:
    """Run ``fn(rank, mesh, *args)`` on ``nprocs`` spawned ranks of a fresh
    world whose fleet mesh lies on ``device`` (module note); returns each
    rank's (picklable) result in rank order.  ``fn`` must be importable by
    name (a module-level function).  A rank that raises fails the world:
    ``RuntimeError`` with its traceback.  Past ``timeout_s`` every child
    is killed and ``TimeoutError`` raised; no child outlives the call."""
    import torch.multiprocessing as mp

    backend = backend or default_backend(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_world_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, os.path.join(tmp, "store"), backend, str(device),
                               threads, timeout_s, fn, args, results), daemon=True)
             for r in range(nprocs)]
    got: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {nprocs - len(got)} of {nprocs} ranks did not "
                                   f"finish within {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn: rank(s) {dead} died with exit codes "
                                       f"{[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(nprocs)]

"""Multi-pod dry run (``repro.launch.dryrun``): every (architecture x input
shape) cell on the production meshes, (16, 16) ``("data", "model")`` or
(2, 16, 16) ``("pod", "data", "model")``, for the roofline analysis
(``launch/roofline.py``).

JAX lowers and compiles each cell for 512 placeholder devices and reads
XLA's cost and memory analyses and the post-SPMD HLO.  The port is
multi-process SPMD and has no HLO: it runs **rank 0's step** of the cell on
a fake world of the mesh's ranks in one process (the ``fake`` process-group
backend, ``FakeStore``) under ``FakeTensorMode``, so nothing is allocated
and no device is touched, and it records what that step does:

* ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs a device
  runs (with a formula for ``aten._int_mm``, 2 M K N).  A fake run takes the
  plain PyTorch paths of the CPU, where the SWAPPER projection (``mxu``) is
  one integer matmul over the K-stacked limbs, counted as it runs; no
  kernel wrapper is reached;
* every op's bytes read and written (views excluded) give the bytes a
  device accesses, and the collectives it issues (``c10d`` ops, keyed as
  JAX's HLO kinds) their output bytes (``roofline.collective_bytes``);
* ``torch.distributed._tools.mem_tracker.MemTracker`` gives the peak a
  device holds, its inputs included.

The cell's step is what a rank runs: the train step ``make_train_step(cfg,
par, opt, mesh=)`` on the rank's blocks of the state and the global batch;
the model-sharded ``registry.prefill`` and ``decode_step`` on the rank's
blocks of the params and cache (``models/registry.py``).  The counter sees
every op that runs, so the full depth needs no extrapolation
(``--no-extrapolate``, ``cost_source="full"``); the CLI's default keeps
JAX's: the 1- and 2-period variants run and the per-period difference is
scaled to the period count (``cost_source="extrapolated_1p2p"``; FLOPs,
bytes, collectives and the peak alike, each linear in the depth).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out rows.jsonl]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import heapq
import json
import sys
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, LONG_CONTEXT_OK, SHAPES, ParallelConfig
from repro_torch.configs.base import AxPolicy
from repro_torch.quant.ax import weight_cache

from .mesh import cache_shardings, make_mesh, production_mesh_shape, tree_paths, \
    tree_unflatten
from .roofline import collective_bytes, roofline_report
from .sharding import MeshShape, axis_size, set_mesh_ctx

__all__ = ["skip_reason", "build_cell", "run_cell", "fake_world", "OpRecorder", "main"]

# the c10d ops of the port's collectives, as JAX's HLO names their kinds
# (any other c10d op keeps its own name)
_C10D_KINDS = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
               "_reduce_scatter_base_": "reduce-scatter", "alltoall_base_": "all-to-all"}
TOP_OPS = 2000                            # the largest single ops a recorder keeps


def skip_reason(arch: str, shape_name: str):
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return "long_500k needs sub-quadratic attention (pure full-attention arch; DESIGN.md §6)"
    return None


def _n_periods(cfg):
    if cfg.family == "encdec":
        return cfg.n_layers
    period = len(cfg.pattern) if cfg.pattern else 1
    return (cfg.n_layers - cfg.first_dense) // period


def _variant_cfg(cfg, k: int):
    """The same model with k pattern periods (the leading and trailing
    layers kept): the cost extrapolation's variants."""
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=k, n_enc_layers=k)
    period = len(cfg.pattern) if cfg.pattern else 1
    body = cfg.n_layers - cfg.first_dense
    rest = body - (body // period) * period
    return dataclasses.replace(cfg, n_layers=cfg.first_dense + k * period + rest)


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks in this process, this process its
    rank 0 (collectives return at once and move nothing); destroyed on
    exit.  ``ValueError`` inside an initialised world."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise ValueError("fake_world: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def _shape_str(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"{str(x.dtype).replace('torch.', '')}{list(x.shape)}"
    if isinstance(x, (list, tuple)):
        return "(" + ", ".join(_shape_str(v) for v in x if _nbytes(v)) + ")"
    return ""


class OpRecorder(TorchDispatchMode):
    """Every op a run dispatches (module note): ``bytes`` read and written by
    the ATen ops that are not views, ``kinds`` {op: [output bytes, count]}, the
    ``top`` largest single ops by output bytes, and ``collectives``, the
    ``(kind, output bytes)`` of each ``c10d`` op."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.kinds = {}
        self.top = []
        self.collectives = []
        self._n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "c10d":
            kind = _C10D_KINDS.get(name, name)
            self.collectives.append((kind, _nbytes(args[0])))
            self._note(kind, _nbytes(args[0]), _shape_str(args[0]))
            return out
        if func.namespace != "aten" or func.is_view:
            return out                   # metadata queries (prim), views: no traffic
        ob = _nbytes(out)
        self.bytes += ob + _nbytes(args) + _nbytes(kwargs)
        self._note(name, ob, _shape_str(out))
        return out

    def _note(self, name: str, nbytes: int, shape: str):
        k = self.kinds.setdefault(name, [0, 0])
        k[0] += nbytes
        k[1] += 1
        if nbytes:
            self._n += 1
            item = (nbytes, self._n, name, shape)
            if len(self.top) < TOP_OPS:
                heapq.heappush(self.top, item)
            elif item > self.top[0]:
                heapq.heapreplace(self.top, item)

    def largest(self):
        """The kept ops, largest first: [(bytes, op, shape)]."""
        return [(b, n, s) for b, _, n, s in sorted(self.top, reverse=True)]


_FORMULAS = []


def _register_formulas():
    """``aten._int_mm``'s FLOPs (2 M K N) for ``FlopCounterMode``, once."""
    if _FORMULAS:
        return
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.aten._int_mm)
    def _int_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
        return 2 * a_shape[0] * a_shape[1] * b_shape[1]

    _FORMULAS.append(_int_mm_flop)


def _local_shape(shape, spec, mesh):
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, ax in zip(shape, spec):
        n = axis_size(mesh, ax)
        if d % n:
            raise ValueError(f"a dim of {d} does not split over {n} ranks ({spec})")
        out.append(d // n)
    return tuple(out)


def _fakes(meta_tree, spec_tree, mesh):
    """Fake tensors of this rank's blocks of ``meta_tree``'s leaves under
    ``spec_tree`` (every leaf whole where ``spec_tree`` is None); call
    inside ``FakeTensorMode``."""
    paths, leaves = tree_paths(meta_tree)
    specs = tree_paths(spec_tree)[1] if spec_tree is not None else [()] * len(leaves)
    return tree_unflatten(meta_tree, [
        torch.empty(_local_shape(tuple(t.shape), s, mesh), dtype=t.dtype)
        for t, s in zip(leaves, specs)])


def build_cell(cfg, shape_name: str, mesh, par: ParallelConfig, ax: Optional[AxPolicy] = None):
    """(fn, make_args, cfg, shape): ``fn(*make_args())`` runs rank 0's step
    of the cell on fake tensors of its inputs, this rank's blocks (call both
    inside ``FakeTensorMode`` on a world of ``mesh``'s ranks).  The mesh's
    groups are made here, outside the fake mode."""
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, fresh_train_state, make_train_step
    from repro_torch.train import distributed as D

    from .parallel import mesh_groups, serve_param_specs

    if ax is not None:
        cfg = dataclasses.replace(cfg, ax=ax)
    if cfg.ax is not None:
        # the multiplier's tables are built from real values, once: here,
        # outside the fake mode
        from repro_torch.core.multipliers import get as get_mult
        from repro_torch.kernels.ax_matmul import route_of

        route_of(get_mult(cfg.ax.mult_name), torch.int8)
    shape = SHAPES[shape_name]
    specs = registry.input_specs(cfg, shape)

    if shape.kind == "train":
        opt = AdamWConfig()
        meta_state = fresh_train_state(cfg, opt, device="meta")
        s_specs = D.state_specs(cfg, opt, mesh, par)
        D.train_mesh(mesh, par).plans(cfg, opt)
        step = make_train_step(cfg, par, opt, mesh=mesh)
        return (step, lambda: (_fakes(meta_state, s_specs, mesh), _fakes(specs, None, mesh)),
                cfg, shape)

    meta_params = registry.init_params(cfg, device="meta")
    p_specs = serve_param_specs(mesh, par, meta_params)
    groups = mesh_groups(mesh, par)
    if groups.tp is not None:
        groups.kv_group(shape.global_batch)

    if shape.kind == "prefill":
        def fn(params, batch):
            with set_mesh_ctx(mesh, par), torch.inference_mode():
                return registry.prefill(params, batch, cfg, par,
                                        max_cache_len=shape.seq_len + 64)

        return (fn, lambda: (_fakes(meta_params, p_specs, mesh), _fakes(specs, None, mesh)),
                cfg, shape)

    c_specs = cache_shardings(mesh, par, specs["cache"], cfg)

    def fn(params, cache, tokens):
        with set_mesh_ctx(mesh, par), torch.inference_mode():
            return registry.decode_step(params, cache, tokens, shape.seq_len - 1, cfg, par)

    return (fn, lambda: (_fakes(meta_params, p_specs, mesh), _fakes(specs["cache"], c_specs, mesh),
                         _fakes(specs["tokens"], None, mesh)), cfg, shape)


def _run_stats(cfg, shape_name, mesh, par, ax):
    """One fake run of rank 0's step: its FLOPs, bytes, collectives, peak
    (its inputs included), recorder and wall."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    _register_formulas()
    t0 = time.perf_counter()
    fn, make_args, cfg2, shape = build_cell(cfg, shape_name, mesh, par, ax)
    rec = OpRecorder()
    with _own_caches(), weight_cache(False), FakeTensorMode():
        mt = MemTracker()
        with mt:
            args = make_args()
            with FlopCounterMode(display=False) as fc, rec:
                fn(*args)
        peak = max((v["Total"] for v in mt.get_tracker_snapshot("peak").values()), default=0)
    return dict(flops=float(fc.get_total_flops()), bytes=float(rec.bytes),
                coll=collective_bytes(rec.collectives), peak=float(peak), rec=rec, cfg=cfg2,
                shape=shape, wall=time.perf_counter() - t0)


@contextlib.contextmanager
def _own_caches():
    """The models' per-device constant caches (RoPE frequencies, sinusoid
    positions) emptied for a fake run and restored after it: a fake tensor
    made in one run must not reach another run, nor a real one (the weight
    cache is off in a fake run: each weight is cast and quantized once in
    a step either way)."""
    from repro_torch.models import layers

    saved = [(c, dict(c)) for c in (layers._ROPE, layers._SINUSOID)]
    for c, _ in saved:
        c.clear()
    try:
        yield
    finally:
        for c, old in saved:
            c.clear()
            c.update(old)


def _device_mesh(ms: MeshShape):
    """The ``DeviceMesh`` of ``ms`` over the (fake) world, on the CPU."""
    return make_mesh(ms.sizes, ms.axis_names, device="cpu")


def run_cell(arch: str, shape_name: str, multi_pod: bool, par: ParallelConfig,
             ax: Optional[AxPolicy] = None, verbose=True, extrapolate=True, mesh=None,
             cfg_patch: Optional[dict] = None, keep_recorder: bool = False):
    """One cell's row (JAX's keys; module note).  ``mesh``: a
    ``sharding.MeshShape`` (the production mesh of ``multi_pod`` when None),
    on whose ranks a fake world is made for the cell.  ``keep_recorder``
    adds the full run's ``OpRecorder`` under ``"recorder"`` (not JSON)."""
    ms = mesh if mesh is not None else production_mesh_shape(multi_pod=multi_pod)
    mesh_name = "x".join(str(s) for s in ms.sizes)
    reason = skip_reason(arch, shape_name)
    if reason:
        row = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skip",
               "reason": reason}
        if verbose:
            print(json.dumps(row), flush=True)
        return row
    cfg = ARCHS[arch]
    if cfg_patch:
        cfg = dataclasses.replace(cfg, **cfg_patch)
    P = _n_periods(cfg)
    t0 = time.perf_counter()
    with fake_world(ms.size):
        dm = _device_mesh(ms)
        if extrapolate and P > 1 and not keep_recorder:
            v1 = _run_stats(_variant_cfg(cfg, 1), shape_name, dm, par, ax)
            v2 = _run_stats(_variant_cfg(cfg, 2), shape_name, dm, par, ax)

            def lin(a, b):
                return a + (P - 1) * (b - a)

            flops, byts, peak = (lin(v1[k], v2[k]) for k in ("flops", "bytes", "peak"))
            coll = {k: int(lin(v1["coll"][k], v2["coll"][k])) for k in v2["coll"]}
            full = dict(v2, cfg=dataclasses.replace(cfg, ax=ax) if ax is not None else cfg)
            cost_src = "extrapolated_1p2p"
        else:
            full = _run_stats(cfg, shape_name, dm, par, ax)
            flops, byts, peak, coll = full["flops"], full["bytes"], full["peak"], full["coll"]
            cost_src = "full"
    wall = time.perf_counter() - t0
    rl = roofline_report(arch, shape_name, mesh_name, ms.size,
                         {"flops": flops, "bytes accessed": byts},
                         [(k, v) for k, v in coll.items() if k != "_total"], full["cfg"],
                         full["shape"], peak_bytes=peak)
    row = rl.row()
    row.update(status="ok", wall_s=round(wall, 2), cost_source=cost_src, n_periods=P,
               bytes_per_dev=byts,
               collectives={k: v for k, v in coll.items() if v and k != "_total"},
               memory={"memtracker_peak_bytes": int(peak), "peak_source": cost_src},
               ax=(ax.mult_name if ax else None))
    if verbose:
        print(json.dumps(row, default=float), flush=True)
    if keep_recorder:
        row["recorder"] = full["rec"]
    return row


def _parser() -> argparse.ArgumentParser:
    """The CLI's flags: JAX's (it takes no device: a dry run touches none)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--ax", action="store_true",
                    help="SWAPPER approximate-matmul mode (mxu backend)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--pad-vocab", type=int, default=1)
    ap.add_argument("--dp-only", action="store_true")
    ap.add_argument("--patch", default=None,
                    help="JSON dict of ModelConfig field overrides")
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--seq-shard", type=int, default=1)
    ap.add_argument("--remat", default="layer")
    ap.add_argument("--grad-accum", type=int, default=1)
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    # JAX's ParallelConfig defaults, given in full (the port's own defaults
    # are the one-card values)
    par = ParallelConfig(fsdp=bool(args.fsdp), seq_shard=bool(args.seq_shard), ep=True,
                         remat=args.remat, grad_accum=args.grad_accum, dp_only=args.dp_only)
    ax = AxPolicy(backend="mxu") if args.ax else None
    cfg_patch = dict(json.loads(args.patch)) if args.patch else {}
    if args.pad_vocab > 1:
        cfg_patch["pad_vocab_multiple"] = args.pad_vocab
    cfg_patch = cfg_patch or None

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    rows, fail = [], 0
    t0 = time.perf_counter()
    for a, s, mp in cells:
        try:
            rows.append(run_cell(a, s, mp, par, ax, cfg_patch=cfg_patch,
                                 extrapolate=not args.no_extrapolate))
        except Exception as e:                     # a failed cell is a row of its own
            fail += 1
            rows.append({"arch": a, "shape": s, "mesh": "2x16x16" if mp else "16x16",
                         "status": "error", "error": f"{type(e).__name__}: {e}",
                         "trace": traceback.format_exc()[-2000:]})
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r, default=float) + "\n")
    ok = sum(1 for r in rows if r["status"] == "ok")
    sk = sum(1 for r in rows if r["status"] == "skip")
    print(f"\n== dry-run: {ok} ok, {sk} skipped, {fail} failed, {len(rows)} cells "
          f"({'full' if args.no_extrapolate else 'extrapolated_1p2p'} cost, "
          f"{time.perf_counter() - t0:.1f} s) ==")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())

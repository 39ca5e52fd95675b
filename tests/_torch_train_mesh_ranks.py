"""Rank functions of ``tests/test_torch_train_mesh.py``, spawned by
``repro_torch.launch.mesh.spawn`` on the CPU.  Each runs on one rank of a
``gloo`` world, builds its train meshes with ``launch.mesh.make_mesh`` and
returns numpy results for the test process.  No JAX here: the JAX
package's states come in as its checkpoints (``train.load_tree``).
"""
import contextlib
import dataclasses
import os
import threading

import numpy as np
import torch

import repro_torch.configs as TC
from repro_torch import train
from repro_torch.configs.base import AxPolicy, ParallelConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.launch.mesh import make_mesh, tree_paths
from repro_torch.models import blocks
from repro_torch.train import distributed as D
from repro_torch.train.checkpoint import _block

LR, WARMUP = 3e-3, 2
B, S, FRAMES = 8, 16, 24


def config(arch, cfg_kw, n_layers=2):
    kw = dict(cfg_kw)
    ax = kw.pop("ax", None)
    return dataclasses.replace(TC.reduced(TC.ARCHS[arch]), n_layers=n_layers,
                               compute_dtype="float32",
                               ax=AxPolicy(backend=ax) if ax else None, **kw)


def opt_cfg():
    return train.AdamWConfig(lr=LR, warmup=WARMUP)


def mask_labels(batch):
    """Row r loses its first r labels (``tests/_torch_jax_gspmd.py``)."""
    labels = np.array(batch["labels"], copy=True)
    for r in range(labels.shape[0]):
        labels[r, :r] = -1
    return dict(batch, labels=labels)


def batches(cfg, steps, b=B):
    """The global batches of ``tests/_torch_jax_gspmd.py``."""
    stream = train.SyntheticStream(train.DataConfig(cfg.vocab, S, b, seed=1, mode="arith"))
    out = []
    for i in range(steps):
        bt = mask_labels(stream.next())
        if cfg.family == "encdec":
            rng = np.random.default_rng(100 + i)
            bt["frames"] = rng.standard_normal((b, FRAMES, cfg.d_model)).astype(np.float32)
        out.append(bt)
    return out


def flat(tree):
    paths, leaves = tree_paths(tree)
    return {p: v.detach().float().numpy() for p, v in zip(paths, leaves)}


def metrics_of(m):
    return {k: float(m[k]) for k in ("loss", "ce", "aux", "grad_norm")}


class DropCounter:
    """Counts the dispatch choices ``blocks._dispatch`` drops (past the
    capacity) on this rank."""

    def __init__(self):
        self.dropped = 0
        self.orig = blocks._dispatch

    def __enter__(self):
        def counted(flat_, topi, k, E, C):
            buf, slots, keeps = self.orig(flat_, topi, k, E, C)
            self.dropped += int((~keeps).sum())
            return buf, slots, keeps

        blocks._dispatch = counted
        return self

    def __exit__(self, *exc):
        blocks._dispatch = self.orig


def gspmd_rank(rank, _mesh, jax_root, jobs):
    """Each job of ``tests/_torch_jax_gspmd.py`` on this world: every step
    from JAX's state before it (the rank takes its blocks), the step's
    metrics and ``gather_state`` of the new blocks; rank 0 returns them,
    every rank its block index per leaf and its dropped dispatch choices."""
    out = {}
    for job in jobs:
        cfg = config(job["arch"], job.get("cfg", {}))
        par = ParallelConfig(**job["par"])
        mesh = make_mesh(job["shape"], job["axes"], device="cpu")
        step = train.make_train_step(cfg, par, opt_cfg(), mesh=mesh)
        specs = D.state_specs(cfg, opt_cfg(), mesh, par)
        d = os.path.join(jax_root, job["label"])
        res = {"steps": [], "dropped": 0}
        for i, bt in enumerate(batches(cfg, job["steps"])):
            tree, _ = train.load_tree(d, i)
            whole = train_state_from_jax(tree, cfg, device="cpu")
            local = D.local_state(whole, specs, mesh)
            with DropCounter() as dc:
                new, m = step(local, bt)
            res["dropped"] += dc.dropped
            back = train.gather_state(new, specs, mesh)
            res["steps"].append((metrics_of(m), flat(back) if rank == 0 else None,
                                 flat(whole["params"]) if rank == 0 else None))
        spec_of = dict(zip(*tree_paths(specs)))
        res["blocks"] = {p: [[s.start, s.stop] for s in _block(mesh, spec_of[p],
                                                                  tuple(x.shape))]
                         for p, x in zip(*tree_paths(whole))}
        res["whole_shapes"] = {p: list(x.shape) for p, x in zip(*tree_paths(whole))}
        again = train.gather_state(D.local_state(whole, specs, mesh), specs, mesh)
        res["roundtrip"] = all(torch.equal(a, b) for a, b in zip(tree_paths(whole)[1],
                                                                tree_paths(again)[1]))
        out[job["label"]] = res
    return out


def wait_for(path, timeout_s=240.0):
    """Block until ``path`` exists (the JAX subprocess writes it when a job
    is done)."""
    import time

    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout_s} s")
        time.sleep(0.2)


def jax_rank(rank, mesh, jax_root, jobs):
    """``gspmd_rank`` once each job's JAX outputs are on disk."""
    for job in jobs:
        wait_for(os.path.join(jax_root, job["label"], "DONE"))
    return gspmd_rank(rank, mesh, jax_root, jobs)


# the other seven families on two ranks: (mesh shape, axes, ParallelConfig)
FAMILY_MESHES = {
    "gemma3-27b": ((2,), ("data",), dict(dp_only=True, fsdp=True)),
    "starcoder2-15b": ((2, 1), ("data", "model"), dict(fsdp=True, seq_shard=True)),
    "qwen1.5-110b": ((1, 2), ("data", "model"), dict(dp_only=True)),
    "qwen2-vl-72b": ((2,), ("data",), dict(dp_only=True, fsdp=True)),
    "granite-moe-1b-a400m": ((1, 2), ("data", "model"), dict(dp_only=True, ep=True,
                                                             fsdp=True)),
    "recurrentgemma-2b": ((2, 1), ("data", "model"), dict(fsdp=True)),
    "mamba2-370m": ((2,), ("data",), dict(dp_only=True, fsdp=True, remat="layer")),
}


def family_rank(rank, _mesh, names):
    """Per family: one sharded step (f32, the exact path) and the port's
    one-device step from the same state on the same global batch; rank 0
    returns both steps' metrics, new parameters and the start."""
    out = {}
    for name in names:
        shape, axes, kw = FAMILY_MESHES[name]
        cfg = config(name, {})
        par = ParallelConfig(**dict(dict(remat="none"), **kw))
        mesh = make_mesh(shape, axes, device="cpu")
        whole = train.fresh_train_state(cfg, opt_cfg(), seed=0, device="cpu")
        bt = batches(cfg, 1)[0]
        one, m1 = train.make_train_step(cfg, ParallelConfig(remat="none"), opt_cfg())(whole, bt)
        specs = D.state_specs(cfg, opt_cfg(), mesh, par)
        new, m = train.make_train_step(cfg, par, opt_cfg(), mesh=mesh)(
            D.local_state(whole, specs, mesh), bt)
        back = train.gather_state(new, specs, mesh)
        out[name] = (metrics_of(m), metrics_of(m1),
                     *((flat(back["params"]), flat(one["params"]), flat(whole["params"]))
                       if rank == 0 else (None, None, None)))
    return out


def adaptive_rank(rank, _mesh, tile_rows, steps=2):
    """The adaptive step on ``("data",)`` = 2 (reduced qwen2, ``mxu``): its
    aggregated telemetry per step, this rank's solo records (the one-device
    adaptive step on its rows, the whole parameters), and the controller's
    swap triples after it observed the aggregated records."""
    from repro_torch import runtime as R
    from repro_torch.runtime.telemetry import records_to_host

    cfg = config("qwen2-72b", {"ax": "mxu"})
    par = ParallelConfig(dp_only=True, fsdp=True, remat="none")
    mesh = make_mesh((2,), ("data",), device="cpu")
    ctrl = R.AdaptiveController(R.SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                R.AdaptiveConfig(min_observe_steps=1, cooldown_steps=1,
                                                 tile_rows=tile_rows, drift_threshold=0.0),
                                device="cpu")
    opt = opt_cfg()
    whole = train.fresh_train_state(cfg, opt, seed=0, device="cpu")
    specs = D.state_specs(cfg, opt, mesh, par)
    local = D.local_state(whole, specs, mesh)
    step = train.make_train_step(cfg, par, opt, adaptive=True, tile_rows=tile_rows, mesh=mesh)
    solo = train.make_train_step(cfg, ParallelConfig(remat="none"), opt, adaptive=True,
                                 tile_rows=tile_rows)
    rows = slice(rank * B // 2, (rank + 1) * B // 2)
    out = []
    for bt in batches(cfg, steps):
        dyn = ctrl.dyn_tree()
        whole_now = train.gather_state(local, specs, mesh)
        _, ms = solo(whole_now, {k: v[rows] for k, v in bt.items()}, dyn)
        local, m = step(local, bt, dyn)
        fleet = records_to_host(m["ax_telemetry"])
        ctrl.observe(fleet)
        out.append((fleet, records_to_host(ms["ax_telemetry"]),
                    {k: v.numpy() for k, v in ctrl.dyn_tree().items()}))
    return out


def supervised_rank(rank, _mesh, ckpt_root, n_steps=6, crash_at=3):
    """``run_supervised`` of the sharded step (reduced qwen2, one layer,
    ``("data",)`` = 2 with FSDP): uninterrupted, and with a crash at step
    ``crash_at`` after the step-2 checkpoint; each run's final parameters
    gathered, and its log."""
    from repro_torch.train import FaultConfig, SimulatedFailure, run_supervised

    cfg = config("qwen2-72b", {}, n_layers=1)
    par = ParallelConfig(dp_only=True, fsdp=True, remat="none")
    mesh = make_mesh((2,), ("data",), device="cpu")
    opt = train.AdamWConfig(lr=1e-3, warmup=2)
    specs = D.state_specs(cfg, opt, mesh, par)
    step = train.make_train_step(cfg, par, opt, mesh=mesh)

    def make_state():
        return D.local_state(train.fresh_train_state(cfg, opt, seed=0, device="cpu"), specs,
                             mesh)

    fired = []

    def chaos(i):
        if i == crash_at and not fired:
            fired.append(i)
            raise SimulatedFailure("rank lost")

    out = {}
    for label, hook in (("ref", None), ("chaos", chaos)):
        stream = train.SyntheticStream(train.DataConfig(cfg.vocab, S, 4, seed=1, mode="arith"))
        state, log = run_supervised(make_state, step, stream, n_steps,
                                    FaultConfig(ckpt_dir=os.path.join(ckpt_root, label),
                                                ckpt_every=2),
                                    chaos=hook, sharding_tree=specs, mesh=mesh)
        out[label] = (flat(train.gather_state(state, specs, mesh)["params"]), log,
                      int(state["opt"]["step"]))
    return out


def refusal_rank(rank, _mesh):
    """A microbatch of the global batch that does not divide over the batch
    shards raises ``ValueError``."""
    cfg = config("qwen2-72b", {}, n_layers=1)
    par = ParallelConfig(dp_only=True, remat="none", grad_accum=4)
    mesh = make_mesh((2,), ("data",), device="cpu")
    specs = D.state_specs(cfg, opt_cfg(), mesh, par)
    state = D.local_state(train.fresh_train_state(cfg, opt_cfg(), seed=0, device="cpu"),
                          specs, mesh)
    step = train.make_train_step(cfg, par, opt_cfg(), mesh=mesh)
    try:
        step(state, batches(cfg, 1, b=4)[0])
    except ValueError as e:
        return str(e)
    return None


@contextlib.contextmanager
def backward_on_a_thread():
    """Every ``torch.autograd.grad`` run on a thread of its own, as autograd
    runs a backward of card tensors on its device thread: the thread-local
    mesh context of the step is not installed there."""
    real = torch.autograd.grad

    def grad(*a, **kw):
        box = {}

        def run():
            try:
                box["out"] = real(*a, **kw)
            except BaseException as e:          # re-raised on the caller's thread
                box["err"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    torch.autograd.grad = grad
    try:
        yield
    finally:
        torch.autograd.grad = real


def remat_rank(rank, _mesh):
    """deepseek-moe (``mxu``, dropping ``C_loc``) on ``("data", "model")`` =
    (1, 2) with ``dp_only`` + ``ep``: one step with ``remat="layer"``, whose
    recomputed layers run the expert all-to-all and the aux all-reduce in
    the backward, its backward on another thread (``backward_on_a_thread``),
    and the ``remat="none"`` step from the same state; rank 0 returns both
    steps' metrics and new parameters, and the start."""
    cfg = config("deepseek-moe-16b", {"ax": "mxu", "moe_capacity": 1.0})
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    opt = opt_cfg()
    whole = train.fresh_train_state(cfg, opt, seed=0, device="cpu")
    bt = batches(cfg, 1)[0]
    out = {}
    for remat in ("none", "layer"):
        par = ParallelConfig(dp_only=True, ep=True, fsdp=True, remat=remat)
        specs = D.state_specs(cfg, opt, mesh, par)
        with backward_on_a_thread():
            new, m = train.make_train_step(cfg, par, opt, mesh=mesh)(
                D.local_state(whole, specs, mesh), bt)
        back = train.gather_state(new, specs, mesh)
        out[remat] = (metrics_of(m), flat(back["params"]) if rank == 0 else None)
    return out, flat(whole["params"]) if rank == 0 else None


def jobs_rank(rank, mesh, jobs):
    """Several rank functions of this module in one world: ``jobs`` is a
    list of (name, args); returns their results in order."""
    return [globals()[name](rank, mesh, *args) for name, args in jobs]

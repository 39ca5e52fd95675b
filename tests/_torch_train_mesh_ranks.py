"""Rank functions of ``tests/test_torch_train_mesh.py``, spawned by
``repro_torch.launch.mesh.spawn`` on the CPU.  Each runs on one rank of a
``gloo`` world, builds its train meshes with ``launch.mesh.make_mesh`` and
returns numpy results for the test process.  No JAX here: the JAX
package's states come in as its checkpoints (``train.load_tree``).
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

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
ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
# PERF.md section 2's train bounds: loss, ce, aux and grad norm relative, and
# each parameter leaf's update (|d_port - d_jax| / |d_jax|)
TOL_REL, TOL_UPDATE = 1e-4, 0.1


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


def start_jax(jax_root, jobs, tmp, log_name="jax.log"):
    """``tests/_torch_jax_gspmd.py`` on ``jobs`` in a subprocess writing under
    ``jax_root``: (the process, its log file in ``tmp``)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    log = os.path.join(tmp, log_name)
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_jax_gspmd.py"),
                                 jax_root, json.dumps(jobs)], env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    return proc, log


def rel(a, b):
    return abs(a - b) / abs(b) if b else abs(a)


def update_gaps(new, ref, start):
    """|(new - start) - (ref - start)| / |ref - start| per parameter leaf."""
    gaps = {}
    for p, v in ref.items():
        da, db = new[p] - start[p], v - start[p]
        gaps[p] = float(np.linalg.norm(da - db) / max(np.linalg.norm(db), 1e-30))
    return gaps


def within(metrics, ref_metrics, params, ref_params, start):
    """(metric gaps, worst update gap) and whether both meet the bounds."""
    gaps = {k: rel(metrics[k], ref_metrics[k]) for k in ("loss", "ce", "aux", "grad_norm")}
    upd = max(update_gaps(params, ref_params, start).values())
    return gaps, upd, max(gaps.values()) <= TOL_REL and upd <= TOL_UPDATE


def jax_params(d, step, cfg):
    tree, _ = train.load_tree(d, step)
    return flat(train_state_from_jax(tree, cfg, device="cpu")["params"])


def hold_to_jax(job, d, r0):
    """Each step of ``gspmd_rank``'s rank-0 result ``r0`` against JAX's
    sharded step in ``d`` (its loss, ``ce``, global ``aux``, grad norm and
    every leaf's update); where JAX's own sharding tipped an int8 code (its
    one-device step, ``job["one"]``, disagrees with its sharded step), the
    port's step is held to the one-device step instead."""
    cfg = config(job["arch"], job.get("cfg", {}))
    jm = json.load(open(os.path.join(d, "metrics.json")))
    assert len(r0["steps"]) == job["steps"]
    for i, (m, params, start) in enumerate(r0["steps"]):
        new = {p[len("params/"):]: v for p, v in params.items() if p.startswith("params/")}
        if job["arch"] in ("deepseek-moe-16b", "granite-moe-1b-a400m"):
            assert m["aux"] > 0.1
        gaps, upd, ok = within(m, jm[i], new, jax_params(d, i + 1, cfg), start)
        if ok:
            continue
        assert job.get("one"), (i, gaps, upd)
        j1 = json.load(open(os.path.join(d, "one_metrics.json")))[i]
        one = jax_params(os.path.join(d, "one"), i + 1, cfg)
        _, _, jax_ok = within(jm[i], j1, jax_params(d, i + 1, cfg), one, start)
        gaps1, upd1, ok1 = within(m, j1, new, one, start)
        assert not jax_ok and ok1, (i, gaps, upd, gaps1, upd1)


def check_shards(d, ranks):
    """Each rank's block of every state leaf is the index JAX's
    ``state_shardings`` gives the device at its mesh position (a port
    layer's leaf against JAX's stacked leaf without its layer axis), and
    ``gather_state`` of the blocks of JAX's state is JAX's state bit for
    bit."""
    shards = json.load(open(os.path.join(d, "shards.json")))
    assert all(r["roundtrip"] for r in ranks)
    checked = 0
    for jpath, per_dev in shards.items():
        parts = jpath.split("/")
        stacks = [i for i, s in enumerate(parts) if s in ("layers", "layers_enc", "layers_dec")]
        drop = 0
        if stacks:
            k = stacks[0]
            suffix = parts[k + 2:] if parts[k] == "layers" else parts[k + 1:]
            prefix, drop = parts[:k + 1], 1
        elif any(s.startswith(("lead", "rest")) for s in parts):
            k = next(i for i, s in enumerate(parts) if s.startswith(("lead", "rest")))
            prefix, suffix = parts[:k] + ["layers"], parts[k + 1:]
        else:
            prefix, suffix = parts, []
        for rank, r in enumerate(ranks):
            want = per_dev[rank][drop:]
            matches = [p for p in r["blocks"] if p.split("/")[:len(prefix)] == prefix and
                       p.split("/")[len(prefix) + (1 if suffix else 0):] == suffix]
            assert matches, jpath
            for p in matches:
                whole = r["whole_shapes"][p]
                got = r["blocks"][p]
                assert len(got) == len(want), (jpath, p)
                for (a, b), (ja, jb), n in zip(got, want, whole):
                    assert (a, b) == (ja, n if jb is None else jb), (jpath, p, rank, got, want)
                checked += 1
    assert checked >= len(shards)


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


# tests/test_torch_train_tp.py's checks against the one-device step: the
# three families JAX's GSPMD jobs leave out, and the MoE whose experts' ff
# splits over token shards that span "model" (seq_shard without ep) at a
# capacity that drops nothing (per-shard and global capacities then agree)
FAMILY_TP_MESHES = {
    "starcoder2-15b": ((1, 2), ("data", "model"), dict(seq_shard=True)),
    "qwen1.5-110b": ((1, 2), ("data", "model"), dict(fsdp=True)),
    "qwen2-vl-72b": ((1, 2), ("data", "model"), dict(seq_shard=True, remat="layer")),
    "deepseek-moe-16b": ((1, 2), ("data", "model"), dict(seq_shard=True)),
}
FAMILY_CFG = {"deepseek-moe-16b": {"moe_capacity": 4.0}}


def family_rank(rank, _mesh, names, table="FAMILY_MESHES"):
    """Per family: one sharded step (f32, the exact path) on its mesh of
    ``table`` and the port's one-device step from the same state on the
    same global batch; rank 0 returns both steps' metrics, new parameters
    and the start."""
    out = {}
    for name in names:
        shape, axes, kw = globals()[table][name]
        cfg = config(name, FAMILY_CFG.get(name, {}))
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


# ---------------------------------------------------------------------------
# tensor and sequence parallelism over "model" (tests/test_torch_train_tp.py)
# ---------------------------------------------------------------------------

def _tp(n, seq):
    """The ``TensorParallel`` of a ``("data", "model")`` = (1, n) mesh."""
    mesh = make_mesh((1, n), ("data", "model"), device="cpu")
    return D.train_mesh(mesh, ParallelConfig(seq_shard=seq, remat="none")).tp


# (label, backend, multiplier) of the K-split projection cases: route T
# (separable) through every backend, route C through the two that take it
KSPLIT_POLICIES = [("kernel_T", "kernel", "mul8s_trunc0_4"), ("mxu_T", "mxu", "mul8s_trunc0_4"),
                   ("emul_T", "emul", "mul8s_trunc0_4"), ("kernel_C", "kernel", "mul8s_drum4_4"),
                   ("emul_C", "emul", "mul8s_drum4_4")]
KB, KS, KK, KN = 2, 8, 96, 40


def _records_np(sc):
    from repro_torch.runtime.telemetry import records_to_host

    return records_to_host(sc.collected())


def ksplit_rank(rank, _mesh, n):
    """The SWAPPER projection split over K (``quant.ax``, row-parallel) and
    over its output columns (column-parallel) on ``n`` model ranks, against
    the one-rank call on the whole operands (run on every rank): per policy,
    static and ``dyn`` (a triple; a row-tile grid with tile records, the
    kernel's tile histogram for ``kernel``), with and without ``seq_shard``.
    Returns, per case, whether the outputs are bit-equal, whether the
    records are, and the largest gap of the straight-through gradients;
    under ``"codes"``, whether the weight cache's codes of a K block
    (``weight_codes(tp=)``) are the rows of the whole weight's codes with
    its column scales."""
    from repro_torch.quant.ax import ax_dense, ax_dense_dyn, weight_codes
    from repro_torch.runtime.scope import ax_scope

    gen = torch.Generator().manual_seed(11)
    x = torch.randn((KB, KS, KK), generator=gen) * 2.0
    w = torch.randn((KK, KN), generator=gen) * 0.3
    gy = torch.randn((KB, KS, KN), generator=gen)
    tp = _tp(n, False)
    k0, k1 = tp.block(KK)
    with torch.no_grad():
        (q1, s1), (qk, sk) = weight_codes(w, torch.float32), weight_codes(w[k0:k1].clone(),
                                                                            torch.float32, tp=tp)
    out = {"codes": torch.equal(qk, q1[k0:k1]) and torch.equal(sk, s1)}
    for seq in (False, True):
        tp = _tp(n, seq)
        k0, k1 = tp.block(KK)
        c0, c1 = tp.block(KN)
        s0, s1 = tp.block(KS)
        for label, backend, mult in KSPLIT_POLICIES:
            pol = AxPolicy(backend=backend, mult_name=mult, swap_bit=2, swap_value=1)
            grid = torch.tensor([[[1, 2, 1]], [[0, 4, 0]]], dtype=torch.int32)
            for mode, dyn in (("static", None), ("triple", torch.tensor([1, 3, 0],
                                                                        dtype=torch.int32)),
                              ("grid", grid)):
                hist = backend == "kernel" and mode == "grid"

                def call(xa, wa, tp_=None, role=None):
                    xa = xa.detach().requires_grad_(True)
                    wa = wa.detach().requires_grad_(True)
                    if dyn is None:
                        y = ax_dense(xa, wa, pol, tp=tp_ if role == "row" else None)
                        rec = {}
                    else:
                        with ax_scope({"mlp": dyn}, collect=True,
                                      tile_rows=2 if dyn.dim() == 3 else 0,
                                      kernel_hist=hist) as sc:
                            y = ax_dense_dyn(xa, wa, pol, dyn, scope=sc, target="mlp", tp=tp_,
                                             tp_role=role)
                        rec = _records_np(sc)
                    return y, rec, xa, wa

                y1, rec1, xa1, wa1 = call(x, w)
                g1 = torch.autograd.grad(y1, [xa1, wa1], gy)
                # row-parallel: x and w split over K
                yr, recr, xar, war = call(x[..., k0:k1], w[k0:k1], tp, "row")
                gyr = gy[:, s0:s1] if seq else gy / n    # the rank's share of the gradient
                gr = torch.autograd.grad(yr, [xar, war], gyr)
                want = y1[:, s0:s1] if seq else y1
                # column-parallel: w split over its columns
                yc, recc, xac, wac = call(x, w[:, c0:c1], tp, "col")
                gc = torch.autograd.grad(yc, [xac, wac], gy[..., c0:c1])
                gx_c = tp.all_reduce_(gc[0])
                gaps = [(gr[0] - g1[0][..., k0:k1]).abs().max(),
                        (gr[1] - g1[1][k0:k1]).abs().max(),
                        (gx_c - g1[0]).abs().max(), (gc[1] - g1[1][:, c0:c1]).abs().max()]
                out[(seq, label, mode)] = dict(
                    row=torch.equal(yr, want), col=torch.equal(yc, y1[..., c0:c1]),
                    records=same_records(rec1, recr) and same_records(rec1, recc),
                    n_records=len(rec1), grad_gap=float(max(gaps)))
    return out


def same_records(a, b):
    return sorted(a) == sorted(b) and all(
        sorted(a[t]) == sorted(b[t]) and all(np.array_equal(a[t][k], b[t][k]) and
                                             a[t][k].dtype == b[t][k].dtype for k in a[t])
        for t in a)


def tp_adaptive_rank(rank, _mesh, tile_rows, seq, steps=2):
    """The adaptive step (reduced qwen2, ``mxu``) on ``("data", "model")`` =
    (2, 2) with tensor parallelism (``seq_shard`` as given): per step its
    aggregated records, this rank's batch shard's one-rank records (the
    one-device adaptive step on its rows), and the controller's swap
    triples after it observed the aggregated records."""
    from repro_torch import runtime as R
    from repro_torch.runtime.telemetry import records_to_host

    cfg = config("qwen2-72b", {"ax": "mxu"})
    par = ParallelConfig(seq_shard=seq, fsdp=True, remat="none")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
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
    d = rank // 2
    rows = slice(d * B // 2, (d + 1) * B // 2)
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


def tp_remat_rank(rank, _mesh):
    """deepseek-moe (``mxu``, dropping capacity) on ``("data", "model")`` =
    (1, 2) with tensor and sequence parallelism and ``ep``: one step with
    ``remat="layer"``, its backward on another thread
    (:func:`backward_on_a_thread`), whose recomputed layers repeat the
    seq gathers, the K-split reductions, the expert all-to-all and the aux
    all-reduce, and the ``remat="none"`` step from the same state."""
    cfg = config("deepseek-moe-16b", {"ax": "mxu", "moe_capacity": 1.0})
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    opt = opt_cfg()
    whole = train.fresh_train_state(cfg, opt, seed=0, device="cpu")
    bt = batches(cfg, 1)[0]
    out = {}
    for remat in ("none", "layer"):
        par = ParallelConfig(seq_shard=True, ep=True, fsdp=True, remat=remat)
        specs = D.state_specs(cfg, opt, mesh, par)
        with backward_on_a_thread():
            new, m = train.make_train_step(cfg, par, opt, mesh=mesh)(
                D.local_state(whole, specs, mesh), bt)
        back = train.gather_state(new, specs, mesh)
        out[remat] = (metrics_of(m), flat(back["params"]) if rank == 0 else None)
    return out, flat(whole["params"]) if rank == 0 else None


def tp_supervised_rank(rank, _mesh, ckpt_root, n_steps=6, crash_at=3):
    """``run_supervised`` of the sharded step with tensor and sequence
    parallelism (reduced qwen2, one layer, ``mxu``, ``("data", "model")`` =
    (1, 2)): uninterrupted, and with a crash at step ``crash_at`` after the
    step-2 checkpoint (written whole, restored onto the TP blocks)."""
    from repro_torch.train import FaultConfig, SimulatedFailure, run_supervised

    cfg = config("qwen2-72b", {"ax": "mxu"}, n_layers=1)
    par = ParallelConfig(seq_shard=True, fsdp=True, remat="none")
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
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


def tp_refusal_rank(rank, _mesh):
    """Under ``seq_shard`` a sequence that does not divide over the model
    ranks raises ``ValueError``."""
    cfg = config("qwen2-72b", {}, n_layers=1)
    par = ParallelConfig(seq_shard=True, remat="none")
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    specs = D.state_specs(cfg, opt_cfg(), mesh, par)
    state = D.local_state(train.fresh_train_state(cfg, opt_cfg(), seed=0, device="cpu"),
                          specs, mesh)
    bt = {k: v[:, :S - 1] for k, v in batches(cfg, 1)[0].items()}
    try:
        train.make_train_step(cfg, par, opt_cfg(), mesh=mesh)(state, bt)
    except ValueError as e:
        return str(e)
    return None

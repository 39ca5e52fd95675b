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
    """The reduced ``arch`` at ``n_layers``, f32 compute unless ``cfg_kw``
    names a ``compute_dtype``."""
    kw = dict(dict(compute_dtype="float32"), **cfg_kw)
    ax = kw.pop("ax", None)
    return dataclasses.replace(TC.reduced(TC.ARCHS[arch]), n_layers=n_layers,
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
    every rank its block index per leaf, its dropped dispatch choices and,
    per step, ``D.replicas_apart`` of the new blocks (the replicated
    leaves, moments included, whose copies differ; the leaves checked)."""
    out = {}
    for job in jobs:
        cfg = config(job["arch"], job.get("cfg", {}))
        par = ParallelConfig(**job["par"])
        mesh = make_mesh(job["shape"], job["axes"], device="cpu")
        step = train.make_train_step(cfg, par, opt_cfg(), mesh=mesh)
        specs = D.state_specs(cfg, opt_cfg(), mesh, par)
        d = os.path.join(jax_root, job["label"])
        res = {"steps": [], "dropped": 0, "replicas": []}
        for i, bt in enumerate(batches(cfg, job["steps"])):
            tree, _ = train.load_tree(d, i)
            whole = train_state_from_jax(tree, cfg, device="cpu")
            local = D.local_state(whole, specs, mesh)
            with DropCounter() as dc:
                new, m = step(local, bt)
            res["dropped"] += dc.dropped
            res["replicas"].append(D.replicas_apart(new, specs, mesh))
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


@contextlib.contextmanager
def recording_sums():
    """While open, on this rank: each float SUM over ranks the port runs
    (``launch.parallel``: a reduce-scatter, an all-to-all of the parts; an
    all-reduce, ``rank_order_sum``'s all-gather of the parts) as (dtype
    name, the shape a rank contributes, whether
    ``TensorParallel.input_grad`` made it, whether a backward did)."""
    import traceback

    import torch.distributed as dist

    seen = []
    saved = dist.all_to_all_single, dist.all_gather_into_tensor

    def wrap(f, kind):
        def call(out, inp, *a, **kw):
            names = [fr.name for fr in traceback.extract_stack()]
            if inp.is_floating_point() and names[-2] == kind:
                seen.append((str(inp.dtype).replace("torch.", ""), tuple(inp.shape),
                             "input_grad" in names, "backward" in names))
            return f(out, inp, *a, **kw)
        return call

    dist.all_to_all_single = wrap(saved[0], "_reduce_scatter")
    dist.all_gather_into_tensor = wrap(saved[1], "rank_order_sum")
    try:
        yield seen
    finally:
        dist.all_to_all_single, dist.all_gather_into_tensor = saved


def sums_rank(rank, mesh, jax_root, jobs):
    """``jax_rank``, and the float sums over ranks of its steps
    (:func:`recording_sums`)."""
    with recording_sums() as seen:
        out = jax_rank(rank, mesh, jax_root, jobs)
    return out, seen


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


def replica_rank(rank, _mesh):
    """``D.replicas_apart`` after one step of the reduced qwen2 on
    ``("data", "model")`` = (2, 2) with ``fsdp`` (f32, exact), then again
    with one element of two replicated leaves moved on rank 1 (by one ulp,
    or by 1 for the step count): the first leaf whole on every rank and the
    first parameter sharded over ``"model"`` only, whose copies lie on the
    two batch shards of a model rank (ranks 1 and 3).  Returns
    (the step's result, the moved result, the two paths)."""
    cfg = config("qwen2-72b", {})
    par = ParallelConfig(fsdp=True, remat="none")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    opt = opt_cfg()
    specs = D.state_specs(cfg, opt, mesh, par)
    state = D.local_state(train.fresh_train_state(cfg, opt, seed=0, device="cpu"), specs,
                          mesh)
    new, _ = train.make_train_step(cfg, par, opt, mesh=mesh)(state, batches(cfg, 1)[0])
    clean = D.replicas_apart(new, specs, mesh)
    paths, leaves = tree_paths(new)
    spec_of = dict(zip(*tree_paths(specs)))
    whole = next(p for p in paths if not any(spec_of[p]))
    on_model = next(p for p in paths if p.startswith("params/")
                    and tuple(ax for ax in spec_of[p] if ax) == ("model",))
    if rank == 1:
        for p, x in zip(paths, leaves):
            if p in (whole, on_model):
                flat_ = x.view(-1)
                flat_[0] = (torch.nextafter(flat_[0], torch.tensor(float("inf")))
                            if x.is_floating_point() else flat_[0] + 1)
    return clean, D.replicas_apart(new, specs, mesh), (whole, on_model)


def card_default_rank(rank, _mesh):
    """``tests/test_torch_gpu.py``'s four-card check, one ``nccl`` rank a
    card: ``chip_smoke.py``'s collective probe (values checked), then one
    step of the reduced deepseek-moe (f32, exact, a capacity that drops
    nothing) at JAX's default layout on ``("data", "model")`` = (2, 2)
    (``fsdp``, ``seq_shard``, ``ep``, ``remat="layer"``) from the seeded
    state, and the one-card step from the same state on this rank's card.
    Returns the probe, both steps' metrics, ``D.replicas_apart`` of the new
    blocks and (rank 0) the gathered, one-card and start parameters."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    dev = torch.device("cuda", torch.cuda.current_device())
    probe = chip_smoke._train_probe(dev)
    cfg = config("deepseek-moe-16b", {})
    par = ParallelConfig(fsdp=True, seq_shard=True, ep=True, remat="layer")
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda")
    opt = opt_cfg()
    whole = train.fresh_train_state(cfg, opt, seed=0, device=dev)
    bt = batches(cfg, 1)[0]
    specs = D.state_specs(cfg, opt, mesh, par)
    new, m = train.make_train_step(cfg, par, opt, mesh=mesh)(D.local_state(whole, specs, mesh),
                                                               bt)
    replicas = D.replicas_apart(new, specs, mesh)
    back = train.gather_state(new, specs, mesh)
    one, m1 = train.make_train_step(cfg, ParallelConfig(remat="none"), opt)(whole, bt)

    def host(tree):
        paths, leaves = tree_paths(tree)
        return {p: v.detach().float().cpu().numpy() for p, v in zip(paths, leaves)}

    return dict(device=str(dev), probe=probe, metrics=metrics_of(m), one_metrics=metrics_of(m1),
                replicas=replicas,
                params=(host(back["params"]), host(one["params"]), host(whole["params"]))
                if rank == 0 else None)


# ---------------------------------------------------------------------------
# the per-layer gathers against the whole-step gather
# (tests/test_torch_train_gather.py, tests/test_torch_train_init.py)
# ---------------------------------------------------------------------------

# chip_smoke.py's train layouts (a)-(e) on four ranks: label -> (mesh shape,
# axes, ParallelConfig fields)
GATHER_LAYOUTS = {
    "a": ((4,), ("data",), dict(dp_only=True, fsdp=True)),
    "b": ((1, 4), ("data", "model"), dict(dp_only=True, ep=True)),
    "c": ((1, 4), ("data", "model"), dict(ep=True)),
    "d": ((1, 4), ("data", "model"), dict(seq_shard=True, ep=True)),
    "e": ((2, 2), ("data", "model"), dict(fsdp=True, seq_shard=True, ep=True)),
}


def whole_gather_step(cfg, par, opt, mesh):
    """The sharded step with the whole-step gather (non-adaptive): every
    parameter block gathered whole over its plan's axes once before the
    first microbatch, the models given the whole tree, the whole gradients
    accumulated over the microbatches and reduce-scattered to the blocks
    once after the last.  The oracle of the per-layer gathers."""
    from repro_torch.launch.mesh import tree_unflatten
    from repro_torch.launch.sharding import set_mesh_ctx
    from repro_torch.models import train_loss
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.train_step import _check_tp, _detach, _to_device

    tm = D.train_mesh(mesh, par)
    tm.plans(cfg, opt)

    def step(state, batch):
        with set_mesh_ctx(mesh, par, groups=tm):
            params = state["params"]
            paths, blocks_ = tree_paths(params)
            plans = [tm.plans(cfg, opt)[p] for p in paths]
            batch = _to_device(batch, blocks_[0].device)
            k = par.grad_accum
            B_ = next(iter(batch.values())).shape[0]
            _, index, n = tm.batch
            m = B_ // k // n
            if tm.tp is not None:
                _check_tp(cfg, batch, tm.tp)
            live = [x.detach().requires_grad_(True) for x in blocks_]
            with torch.enable_grad():
                gathered = [D.gather_leaf(x, plan.gather) for x, plan in zip(live, plans)]
            full = [g.detach().requires_grad_(True) for g in gathered]
            full_tree = tree_unflatten(params, full)
            acc, term_sum, metrics = None, None, {}
            for j in range(k):
                lo = j * (B_ // k) + index * m
                mb = {name: v[lo:lo + m] for name, v in batch.items()}
                with torch.enable_grad():
                    term, metrics = train_loss(full_tree, mb, cfg, par)
                    g = torch.autograd.grad(term, full, allow_unused=True)
                g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(full, g)]
                if k > 1:
                    g = [gi.to(torch.float32) for gi in g]
                    acc = g if acc is None else [a + b for a, b in zip(acc, g)]
                else:
                    acc = g
                term_sum = term.detach() if term_sum is None else term_sum + term.detach()
            idx = [i for i, plan in enumerate(plans) if plan.gather]
            if idx:
                back = torch.autograd.grad([gathered[i] for i in idx], [live[i] for i in idx],
                                           grad_outputs=[acc[i] for i in idx])
                for i, b in zip(idx, back):
                    acc[i] = b
            del live, gathered, full, full_tree, g
            with torch.no_grad():
                grads = tm.reduce_grads(acc, plans)
                del acc
                if k > 1:
                    grads = [g / k for g in grads]
                group = tm.world_group
                if k > 1:
                    vals = D.all_reduce_sum(term_sum.reshape(1), group)
                    loss = vals[0] / k
                    out = {"ce": loss, "aux": torch.zeros_like(loss)}
                else:
                    vals = D.all_reduce_sum(torch.stack([term_sum, metrics["ce"].detach(),
                                                         metrics["aux"].detach()]), group)
                    loss = vals[0]
                    out = dict(metrics, ce=vals[1], aux=vals[2])
            new_params, new_opt, opt_metrics = adamw_update(
                tree_unflatten(params, grads), state["opt"], params, opt,
                replicas=[p.replicas for p in plans], group=tm.world_group)
            return ({"params": new_params, "opt": new_opt},
                    dict(_detach(out), loss=loss, **opt_metrics))

    return step


def gather_rank(rank, _mesh, jobs):
    """Per job ``(name, arch, cfg fields, layout, ParallelConfig fields)``
    on this world of four: one step of the per-layer gathers
    (``make_train_step(mesh=)``) and one of :func:`whole_gather_step` from
    the same ``init_train_blocks`` state on the same global batch, each
    backward on a thread of its own (:func:`backward_on_a_thread`).  Per
    job: whether every leaf of the new blocks (moments and step included)
    and every metric are bit-equal, the metrics of both, and rank 0's new
    blocks of both and the start as numpy; and ``D.replicas_apart`` of the
    new blocks."""
    from repro_torch.train import init_train_blocks

    out = {}
    for name, arch, cfg_kw, layout, par_kw in jobs:
        shape, axes, kw = GATHER_LAYOUTS[layout]
        cfg = config(arch, cfg_kw)
        par = ParallelConfig(**dict(kw, **par_kw))
        mesh = make_mesh(shape, axes, device="cpu")
        opt = opt_cfg()
        specs = D.state_specs(cfg, opt, mesh, par)
        start = init_train_blocks(cfg, opt, mesh, par, seed=2, device="cpu")
        bt = batches(cfg, 1)[0]
        with backward_on_a_thread():
            new, m = train.make_train_step(cfg, par, opt, mesh=mesh)(start, bt)
            old, m_old = whole_gather_step(cfg, par, opt, mesh)(start, bt)
        pa, la = tree_paths(new)
        pb, lb = tree_paths(old)
        same = pa == pb and all(torch.equal(a, b) for a, b in zip(la, lb))
        out[name] = dict(
            bits=same and all(torch.equal(m[k], m_old[k]) for k in m_old),
            metrics=metrics_of(m), old_metrics=metrics_of(m_old),
            params=(flat(new["params"]), flat(old["params"]), flat(start["params"]))
            if rank == 0 else None,
            replicas=D.replicas_apart(new, specs, mesh))
    return out


def train_init_rank(rank, _mesh, archs, chunk):
    """Per config of ``archs`` and layout of :data:`GATHER_LAYOUTS` (JAX's
    layout on (e)): ``init_train_blocks`` against ``local_state(
    init_train_state(init_blocks(cfg)))`` (the paths whose leaves differ in
    shape, dtype or bits), the largest tensor (elements) any op of
    ``init_train_blocks`` made off ``meta`` with ``layers.CHUNK`` at
    ``chunk``, the rank's largest block and the largest whole leaf."""
    from repro_torch.models import init_blocks, layers
    from repro_torch.train import init_train_blocks, init_train_state

    from _torch_serve_tp_ranks import _Made

    opt = opt_cfg()
    out = {}
    for arch in archs:
        cfg = TC.reduced(TC.ARCHS[arch])
        whole = init_train_state(init_blocks(cfg, seed=4, device="cpu"), opt)
        for layout, (shape, axes, kw) in GATHER_LAYOUTS.items():
            par = ParallelConfig(**kw)
            mesh = make_mesh(shape, axes, device="cpu")
            want = D.local_state(whole, D.state_specs(cfg, opt, mesh, par), mesh)
            made, saved = _Made(), layers.CHUNK
            layers.CHUNK = chunk
            try:
                with made:
                    got = init_train_blocks(cfg, opt, mesh, par, seed=4, device="cpu")
            finally:
                layers.CHUNK = saved
            pa, la = tree_paths(got)
            pb, lb = tree_paths(want)
            bad = [p for p, a, b in zip(pa, la, lb)
                   if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b)]
            out[(arch, layout)] = dict(
                bad=bad if pa == pb else ["<paths differ>"], made=made.largest,
                largest_block=max(t.numel() for t in la),
                largest_leaf=max(t.numel() for t in tree_paths(whole)[1]))
    return out


# ---------------------------------------------------------------------------
# checkpoints of a sharded state (tests/test_torch_ckpt_blocks.py)
# ---------------------------------------------------------------------------

# a4, c4 and JAX's default layout on (2, 2) of GATHER_LAYOUTS; qwen2's AdamW
# keeps bf16 moments (with an f32 error feedback), so its files hold bf16 leaves
CKPT_LAYOUTS = ("a", "c", "e")
CKPT_OPT = {"qwen2-72b": dict(compress="bf16"), "deepseek-moe-16b": {}}
CKPT_EXTRA = {"train_step": 1, "data": {"step": 1}}


@contextlib.contextmanager
def watching_saves(slow_s=0.0):
    """While open, on this rank: the elements each ``dist.gather`` gathers
    (the root's list, else the tensor), the count of all-gathers (the
    whole-state gather's collective) and of ``checkpoint.gather_state``
    calls, and the most leaves the checkpoint's writer queue held; each
    leaf's write slowed by ``slow_s`` so that the gathers run ahead of the
    writer."""
    import queue as queue_lib
    import time

    import torch.distributed as dist

    from repro_torch.train import checkpoint as C

    seen = {"gathers": [], "all_gathers": 0, "gather_state": 0, "queue_most": 0,
            "queue_bound": []}
    saved = (dist.gather, dist.all_gather, dist.all_gather_into_tensor, C.gather_state,
             C.queue.Queue, C._NpzWriter.add)

    def gather(tensor, gather_list=None, *a, **kw):
        seen["gathers"].append(sum(t.numel() for t in gather_list) if gather_list
                               else tensor.numel())
        return saved[0](tensor, gather_list, *a, **kw)

    def counted(i, key):
        def call(*a, **kw):
            seen[key] += 1
            return saved[i](*a, **kw)
        return call

    class Queue(queue_lib.Queue):
        def __init__(self, maxsize=0):
            seen["queue_bound"].append(maxsize)
            super().__init__(maxsize)

        def _put(self, item):
            super()._put(item)
            seen["queue_most"] = max(seen["queue_most"], self._qsize())

    def add(self, *a):
        time.sleep(slow_s)
        return saved[5](self, *a)

    dist.gather, dist.all_gather = gather, counted(1, "all_gathers")
    dist.all_gather_into_tensor = counted(2, "all_gathers")
    C.gather_state, C.queue.Queue, C._NpzWriter.add = counted(3, "gather_state"), Queue, add
    try:
        yield seen
    finally:
        (dist.gather, dist.all_gather, dist.all_gather_into_tensor, C.gather_state,
         C.queue.Queue, C._NpzWriter.add) = saved


def _bits_np(t):
    """A leaf's bits as numpy (bf16 as its 16-bit pattern)."""
    t = t.detach()
    return (t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16
            else t.numpy())


def _same_bits(got, want, rank) -> bool:
    """Whether ``_whole_on_rank0``'s (array, dtype name) is ``want``'s bits
    on rank 0 (None on the other ranks)."""
    if rank:
        return got is None
    return got[0].dtype == _bits_np(want).dtype and np.array_equal(got[0], _bits_np(want))


def _apart(got, want):
    """The paths of the tree ``got`` whose leaves differ from ``want``'s in
    shape, dtype or bits."""
    pa, la = tree_paths(got)
    pb, lb = tree_paths(want)
    if pa != pb:
        return ["<paths differ>"]
    return [p for p, a, b in zip(pa, la, lb)
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b)]


def ckpt_rank(rank, _mesh, root, archs, layouts=CKPT_LAYOUTS):
    """Per config of ``archs`` and layout of ``layouts`` (``GATHER_LAYOUTS``):
    one sharded step from the counter-addressed init, then the state saved
    by rank 0 whole (``root/<arch>/<layout>/whole``) and by ``np.savez``
    of its arrays (``.../savez.npz``), by the sharded ``save``
    (``.../blocks``) and by ``AsyncCheckpointer.save_async``
    (``.../async``), the sharded saves watched (:func:`watching_saves`,
    each leaf's write slowed by 10 ms).  Then each layout's blocks file
    restored onto every layout, and by rank 0 whole in this process: the
    paths whose leaves differ from the whole state's blocks (bound 0).
    Returns per (arch, layout) the watch, the whole leaves' element counts
    in file order and the restores' differing paths."""
    import torch.distributed as dist

    from repro_torch.train import checkpoint as C
    from repro_torch.train import init_train_blocks

    out = {}
    for arch in archs:
        opt = train.AdamWConfig(lr=LR, warmup=WARMUP, **CKPT_OPT[arch])
        cfg = config(arch, {})
        bt = batches(cfg, 1)[0]
        runs = {}
        for layout in layouts:
            shape, axes, kw = GATHER_LAYOUTS[layout]
            par = ParallelConfig(**kw)
            mesh = make_mesh(shape, axes, device="cpu")
            specs = D.state_specs(cfg, opt, mesh, par)
            state, _ = train.make_train_step(cfg, par, opt, mesh=mesh)(
                init_train_blocks(cfg, opt, mesh, par, seed=2, device="cpu"), bt)
            whole = train.gather_state(state, specs, mesh)
            d = os.path.join(root, arch, layout)
            if rank == 0:
                train.save(os.path.join(d, "whole"), 1, whole, extra=CKPT_EXTRA)
                arrays = dict(zip(tree_paths(whole)[0], map(_bits_np, tree_paths(whole)[1])))
                np.savez(os.path.join(d, "savez.npz"),
                         **{f"a{i}": arrays[p] for i, p in enumerate(sorted(arrays))})
            with watching_saves(slow_s=0.01) as seen:
                train.save(os.path.join(d, "blocks"), 1, state, extra=CKPT_EXTRA,
                           sharding_tree=specs, mesh=mesh)
                saver = train.AsyncCheckpointer()
                saver.save_async(os.path.join(d, "async"), 1, state, extra=CKPT_EXTRA,
                                 sharding_tree=specs, mesh=mesh)
                saver.wait()
            dist.barrier()
            flat_specs = dict(zip(*tree_paths(specs)))
            # the gathers through a staging buffer, as rank 0 copies blocks off a card
            stage = torch.empty(max(x.numel() * x.element_size() for x in tree_paths(state)[1]),
                                dtype=torch.uint8)
            staged = [p for p, x, w in zip(*tree_paths(state), tree_paths(whole)[1])
                      if flat_specs[p] is not None and any(flat_specs[p]) and
                      not _same_bits(C._whole_on_rank0(x, flat_specs[p], mesh, stage), w, rank)]
            paths, leaves = tree_paths(whole)
            order = sorted(range(len(paths)), key=paths.__getitem__)
            runs[layout] = (mesh, specs, state, whole)
            out[(arch, layout)] = dict(
                seen=seen, staged_apart=staged, sizes=[leaves[i].numel() for i in order],
                sharded_sizes=[leaves[i].numel() for i in order
                               if flat_specs[paths[i]] is not None
                               and any(flat_specs[paths[i]])],
                restores={})
        for src in layouts:
            f = os.path.join(root, arch, src, "blocks")
            whole = runs[src][3]
            for dst in layouts:
                mesh, specs, like, _ = runs[dst]
                got, extra = train.restore(f, 1, like, device="cpu", sharding_tree=specs,
                                           mesh=mesh)
                out[(arch, src)]["restores"][dst] = (
                    _apart(got, D.local_state(whole, specs, mesh)), extra == CKPT_EXTRA)
            if rank == 0:
                got, extra = train.restore(f, 1, whole, device="cpu")
                out[(arch, src)]["restores"]["one"] = (_apart(got, whole),
                                                       extra == CKPT_EXTRA)
    return out


def ckpt_supervised_rank(rank, _mesh, ckpt_root, n_steps=6, crash_at=3):
    """``run_supervised`` of the sharded step on four ranks (the reduced
    qwen2, one layer, JAX's default layout on (2, 2)): uninterrupted, and
    with a crash at step ``crash_at`` after the step-2 checkpoint, each
    watched (:func:`watching_saves`); each run's final parameters gathered,
    its log and its watch."""
    from repro_torch.train import FaultConfig, SimulatedFailure, init_train_blocks, \
        run_supervised

    cfg = config("qwen2-72b", {}, n_layers=1)
    shape, axes, kw = GATHER_LAYOUTS["e"]
    par = ParallelConfig(**kw)
    mesh = make_mesh(shape, axes, device="cpu")
    opt = train.AdamWConfig(lr=1e-3, warmup=2)
    specs = D.state_specs(cfg, opt, mesh, par)
    step = train.make_train_step(cfg, par, opt, mesh=mesh)
    fired = []

    def chaos(i):
        if i == crash_at and not fired:
            fired.append(i)
            raise SimulatedFailure("rank lost")

    out = {}
    for label, hook in (("ref", None), ("chaos", chaos)):
        stream = train.SyntheticStream(train.DataConfig(cfg.vocab, S, 4, seed=1, mode="arith"))
        with watching_saves() as seen:
            state, log = run_supervised(
                lambda: init_train_blocks(cfg, opt, mesh, par, seed=0, device="cpu"), step,
                stream, n_steps, FaultConfig(ckpt_dir=os.path.join(ckpt_root, label),
                                             ckpt_every=2),
                chaos=hook, sharding_tree=specs, mesh=mesh)
        out[label] = (flat(train.gather_state(state, specs, mesh)["params"]), log,
                      int(state["opt"]["step"]), dict(seen))
    return out


def ckpt_failure_rank(rank, _mesh, root):
    """A sharded ``save_async`` whose third leaf's write raises ``OSError``
    (the reduced qwen2, one layer, layout e): what ``wait`` raises on this
    rank (None where nothing), and the files left in the directory."""
    import torch.distributed as dist

    from repro_torch.train import checkpoint as C
    from repro_torch.train import init_train_blocks

    cfg = config("qwen2-72b", {}, n_layers=1)
    shape, axes, kw = GATHER_LAYOUTS["e"]
    par = ParallelConfig(**kw)
    mesh = make_mesh(shape, axes, device="cpu")
    opt = opt_cfg()
    state = init_train_blocks(cfg, opt, mesh, par, seed=0, device="cpu")
    real, calls = C._NpzWriter.add, []

    def add(self, *a):
        calls.append(a[0])
        if len(calls) == 3:
            raise OSError("disk full")
        return real(self, *a)

    C._NpzWriter.add = add
    saver, raised = train.AsyncCheckpointer(), None
    try:
        saver.save_async(root, 1, state, extra=CKPT_EXTRA,
                         sharding_tree=D.state_specs(cfg, opt, mesh, par), mesh=mesh)
        try:
            saver.wait()
        except OSError as e:
            raised = str(e)
    finally:
        C._NpzWriter.add = real
    dist.barrier()
    return raised, sorted(os.listdir(root)) if os.path.isdir(root) else []

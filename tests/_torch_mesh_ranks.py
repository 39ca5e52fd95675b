"""Rank functions of the mesh tests (``tests/test_torch_mesh.py`` and
``tests/test_torch_fleet_mesh.py``), spawned by
``repro_torch.launch.mesh.spawn`` on the CPU.  Each runs on one rank of a
``gloo`` world and returns numpy results for the test process to hold
against JAX and the single-process paths.  No JAX here: a rank loads the
port only.
"""
import copy
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.configs as TC
import repro_torch.runtime as R
from repro_torch.configs.base import AxPolicy, ParallelConfig
from repro_torch.core import SwapConfig
from repro_torch.fleet import BatcherConfig, ContinuousBatcher, Request
from repro_torch.fleet import collect
from repro_torch.kernels import _build
from repro_torch.launch.sharding import axis_size, current_rules, set_mesh_ctx
from repro_torch.models import init_params, prefill
from repro_torch.serve import ServeConfig, generate, token_step
from repro_torch.serve import graph as G

B, S, T = 8, 12, 6


def qwen_cfg():
    return dataclasses.replace(TC.reduced(TC.ARCHS["qwen2-72b"]), n_layers=2,
                               ax=AxPolicy(backend="mxu"))


def starcoder_cfg():
    """Reduced starcoder2 (the gelu MLP with biases, GQA), 2 layers,
    ``mxu``, f32 compute: the configuration held to JAX's serve."""
    return dataclasses.replace(TC.reduced(TC.ARCHS["starcoder2-15b"]), n_layers=2,
                               compute_dtype="float32", ax=AxPolicy(backend="mxu"))


CONFIGS = {"qwen2-72b": qwen_cfg, "starcoder2-15b": starcoder_cfg}


def model(arch="qwen2-72b", np_params=None):
    """(cfg, params) of a reduced config on the CPU: the port's seeded
    init, or ``np_params``, the JAX package's numpy tree of the same config
    (``convert.params_from_jax``)."""
    from repro_torch.convert import params_from_jax

    cfg = CONFIGS[arch]()
    if np_params is None:
        return cfg, init_params(cfg, seed=0, device="cpu")
    return cfg, params_from_jax(np_params, cfg, device="cpu")


def prompts(cfg, b=B, s=S):
    return torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (b, s)))


def controller(cfg, tile_rows=0, device="cpu"):
    """A controller whose detector never fires (the policy stays put)."""
    return R.AdaptiveController(R.SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                R.AdaptiveConfig(min_observe_steps=10 ** 6,
                                                 tile_rows=tile_rows), device=device)


def recording(ctrl):
    """``ctrl``, its observed host records appended to the returned list."""
    seen = []
    observe = ctrl.observe

    def rec(records):
        seen.append(copy.deepcopy(records))
        return observe(records)

    ctrl.observe = rec
    return seen


def stats(ctrl):
    return {t: (int(s.stats.n), int(s.stats.sum_abs), int(s.stats.max_abs),
                int(s.stats.count_neq)) for t, s in ctrl.telemetry.targets.items()}


def block(rank, n, b=B):
    k = b // n
    return slice(rank * k, (rank + 1) * k)


def serve_rank(rank, mesh, token_loop=True, modes=(0, 2), arch="qwen2-72b", np_params=None):
    """generate(mesh=) in scalar and tile mode (``modes``: tile rows)
    beside this rank's solo run of its block; a policy update;
    token_step(mesh=) over the same decode.  ``arch``, ``np_params``: the
    model (:func:`model`)."""
    n = mesh.size()
    cfg, params = model(arch, np_params)
    toks = prompts(cfg)
    out = {}
    for tile_rows in modes:
        c = controller(cfg, tile_rows)
        recs = recording(c)
        got = generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=T),
                       adaptive=c, mesh=mesh)
        c1 = controller(cfg, tile_rows)
        recs1 = recording(c1)
        solo = generate(params, {"tokens": toks[block(rank, n)]}, cfg,
                        ServeConfig(max_new_tokens=T), adaptive=c1)
        out[tile_rows] = dict(tokens=got.numpy(), records=list(recs), stats=stats(c),
                              solo_tokens=solo.numpy(), solo_records=recs1,
                              solo_stats=stats(c1))
        if tile_rows == 0:
            scalar = c
    # a policy update is a value: no new program, no kernel build
    programs, nvcc = dict(G.captures_by_kind()), _build.NVCC_RUNS["count"]
    scalar.policy.set_config("mlp", SwapConfig("B", 5, 1))
    updated = generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=T),
                       adaptive=scalar, mesh=mesh)
    out["update"] = dict(tokens=updated.numpy(), captures=G.captures_by_kind() == programs,
                         nvcc=_build.NVCC_RUNS["count"] - nvcc,
                         programs=len(G._PROGRAMS))
    if token_loop:
        out["token"] = token_loop_rank(rank, mesh, cfg, params, toks,
                                       out[0]["tokens"][:, 0])
    return out


def token_loop_rank(rank, mesh, cfg, params, toks, first):
    """``token_step(mesh=)`` over the decode ``generate`` runs: this rank's
    block prefilled, the global per-slot vectors, T - 1 steps."""
    n = mesh.size()
    c = controller(cfg)
    with torch.inference_mode():
        _, cache = prefill(params, {"tokens": toks[block(rank, n)]}, cfg,
                           max_cache_len=S + T + 1)
    tok = torch.from_numpy(np.asarray(first, np.int64))
    pos = torch.full((B,), S, dtype=torch.int64)
    active = torch.ones(B, dtype=torch.bool)
    rows, recs = [tok.numpy()], []
    for _ in range(T - 1):
        tok, cache, rec = token_step(params, cache, tok, pos, active, cfg, adaptive=c,
                                     gate=True, mesh=mesh)
        recs.append(R.telemetry.records_to_host(rec))
        rows.append(tok.numpy())
        pos = pos + 1
    return dict(tokens=np.stack(rows, 1), records=recs)


def batcher_rank(rank, mesh, reqs, configs, arch="qwen2-72b", np_params=None):
    """A mesh batcher per BatcherConfig keyword set over the same requests:
    {label: ({rid: tokens}, {rid: finish}, stats)}."""
    cfg, params = model(arch, np_params)
    return {label: drain(params, cfg, reqs, kw, mesh) for label, kw in configs.items()}


def drain(params, cfg, reqs, kw, mesh=None):
    """One batcher's drain of ``reqs`` ((tokens, max_new) pairs); ``kw``
    is a BatcherConfig's keywords and ``deadlines``, {rid: deadline_s}.
    Returns ({rid: tokens}, {rid: finish}, stats)."""
    kw = dict(kw)
    deadlines = kw.pop("deadlines", {})
    bat = ContinuousBatcher(params, cfg, BatcherConfig(**kw), adaptive=controller(cfg),
                            mesh=mesh)
    for rid, (tokens, max_new) in enumerate(reqs):
        bat.submit(Request(rid, np.asarray(tokens, np.int32), max_new=max_new,
                           deadline_s=deadlines.get(rid)))
    done = bat.run()
    return ({c.rid: c.tokens.tolist() for c in done}, {c.rid: c.finish for c in done},
            dict(bat.stats))


# ---------------------------------------------------------------------------
# MoE per token shard, checkpoints, the elastic resume, failing worlds
# ---------------------------------------------------------------------------

def moe_rank(rank, mesh, np_params, x, cfg_kw):
    """This rank's moe_apply of its rows of ``x`` under the mesh context,
    and the global-capacity call on all of ``x`` (no context)."""
    from repro_torch.convert import _map, _tensor
    from repro_torch.models import blocks as TB

    cfg = dataclasses.replace(TC.reduced(TC.ARCHS["deepseek-moe-16b"]), **cfg_kw)
    p = _map(np_params, lambda a: _tensor(a, "cpu"))
    n = mesh.size()
    rows = block(rank, n, x.shape[0])
    with set_mesh_ctx(mesh, ParallelConfig()) as rules:
        shards = axis_size(mesh, rules["batch"])
        y, _ = TB.moe_apply(p, torch.from_numpy(x[rows]), cfg)
    outside = current_rules()
    y_global, _ = TB.moe_apply(p, torch.from_numpy(x), cfg)
    return shards, outside, y.numpy(), y_global.numpy()[rows]


def restore_rank(rank, mesh, ckpt_dir, step):
    """restore(sharding_tree=) of a one-process checkpoint onto this rank,
    and gather_state back."""
    from repro_torch import train
    from repro_torch.launch.mesh import state_shardings, tree_paths, tree_unflatten
    from repro_torch.train.checkpoint import _block

    cfg = qwen_cfg()
    whole = train.fresh_train_state(cfg, train.AdamWConfig(), device="meta")
    tree = state_shardings(mesh, ParallelConfig(dp_only=True, fsdp=True), whole)
    _, leaves = tree_paths(whole)
    specs = tree_paths(tree)[1]

    def local_like(leaf, spec):
        if not any(spec):
            return leaf
        idx = _block(mesh, spec, tuple(leaf.shape))
        return torch.empty(tuple(sl.stop - sl.start for sl in idx), device="meta")

    like = tree_unflatten(whole, [local_like(l, s) for l, s in zip(leaves, specs)])
    local, extra = train.restore(ckpt_dir, step, like, device="cpu", sharding_tree=tree,
                                 mesh=mesh)
    back = train.gather_state(local, tree, mesh)
    flat = lambda t: {p: v.float().numpy() for p, v in zip(*tree_paths(t))}
    n_sharded = sum(1 for s in specs if any(s))
    return flat(local), flat(back), n_sharded, extra


class CountStream:
    """A data stream of the step index, with the state a checkpoint keeps."""

    def __init__(self):
        self.i = 0

    def next(self):
        self.i += 1
        return float(self.i)

    def state(self):
        return {"i": self.i}

    def restore(self, st):
        self.i = int(st["i"])


def toy_state(rows=8, cols=6):
    w = torch.arange(rows * cols, dtype=torch.float32).reshape(rows, cols) / 7.0
    return {"w": w, "b": torch.linspace(-1, 1, cols)}


def toy_step(state, batch):
    return {"w": state["w"] * 0.5 + batch, "b": state["b"] + batch}, {"loss": 0.0}


class CrashOnce:
    """Raises ``SimulatedFailure`` at step ``at``, once."""

    def __init__(self, at):
        self.at, self.fired = at, False

    def __call__(self, step):
        from repro_torch.train import SimulatedFailure

        if step == self.at and not self.fired:
            self.fired = True
            raise SimulatedFailure(f"step {step}")


def elastic_rank(rank, mesh, ckpt_dir, n_steps, crash_at):
    """run_supervised onto the mesh from a one-process checkpoint: the
    state's rows shard over 'data', a crash is survived."""
    from repro_torch.launch.sharding import PartitionSpec as P
    from repro_torch.train import FaultConfig, run_supervised

    n = mesh.size()
    tree = {"w": P("data", None), "b": P()}

    def make_state():
        st = toy_state()
        return {"w": st["w"][block(rank, n, 8)].clone(), "b": st["b"]}

    state, log = run_supervised(make_state, toy_step, CountStream(), n_steps,
                                FaultConfig(ckpt_dir=ckpt_dir, ckpt_every=2),
                                chaos=CrashOnce(crash_at), sharding_tree=tree, mesh=mesh)
    return {k: v.numpy() for k, v in state.items()}, log


def fail_rank(rank, mesh):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()                      # rank 0 waits for a peer that is gone


def sleep_rank(rank, mesh, seconds):
    time.sleep(seconds)
    return rank


def mesh_rank(rank, mesh):
    """The mesh as a rank sees it, one aggregate of each field class, and
    the sharded summarizer over the mesh (tile mode) beside this rank's
    own summary of its operands."""
    group, index, n = collect.batch_group(mesh)
    rec = {"t": {"n": torch.tensor([rank + 1]), "err_max": torch.tensor([10 * rank]),
                 "a_smp": torch.full((1, 3), rank)}}
    agg = collect.aggregate_records(rec, mesh)
    g = torch.Generator().manual_seed(100 + rank)
    a = torch.randint(-127, 128, (6, 64), generator=g).to(torch.int8)
    b = torch.randint(-127, 128, (64, 32), generator=torch.Generator().manual_seed(7)).to(
        torch.int8)
    dyn = torch.tensor([1, 3, 0], dtype=torch.int32)
    fleet = collect.make_sharded_summarizer("mul8s_drum3_4", mesh, target="mlp",
                                            tile_rows=2)(a, b, dyn)
    own = collect.make_sharded_summarizer("mul8s_drum3_4", None, target="mlp",
                                          tile_rows=2)(a, b, dyn)
    return (tuple(mesh.mesh_dim_names), tuple(mesh.shape), index, n, dist.get_backend(group),
            {k: v.tolist() for k, v in agg["t"].items()},
            R.telemetry.records_to_host(fleet), R.telemetry.records_to_host(own))


def card_serve_rank(rank, mesh):
    """On the card (the gpu tests): generate(mesh=) of the whole batch and
    this rank's solo serve of its block, tokens and records; the decode
    runs as CUDA graphs."""
    dev = torch.device("cuda", torch.cuda.current_device())
    n = mesh.size()
    cfg = qwen_cfg()
    params = init_params(cfg, seed=0, device=dev)
    toks = prompts(cfg)
    c, c1 = controller(cfg, device=dev), controller(cfg, device=dev)
    recs, recs1 = recording(c), recording(c1)
    stats_ = {}
    got = generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=T), adaptive=c,
                   mesh=mesh, stats=stats_)
    solo = generate(params, {"tokens": toks[block(rank, n)]}, cfg,
                    ServeConfig(max_new_tokens=T), adaptive=c1)
    return dict(tokens=got.cpu().numpy(), records=list(recs), solo_tokens=solo.cpu().numpy(),
                solo_records=list(recs1), path=stats_["path"], device=str(dev))


def jobs_rank(rank, mesh, jobs):
    """Several rank functions of this module in one world: ``jobs`` is a
    list of (name, args); returns their results in order."""
    return [globals()[name](rank, mesh, *args) for name, args in jobs]

"""Rank functions of ``tests/test_torch_serve_tp.py``, spawned by
``repro_torch.launch.mesh.spawn`` on the CPU.  Each runs on one rank of a
``gloo`` world, builds its meshes with ``launch.mesh.make_mesh`` and returns
numpy results for the test process.  No JAX here: the JAX package's params
and inputs come in as the files of ``tests/_torch_jax_serve.py``.
"""
import dataclasses
import os

import numpy as np
import torch

import repro_torch.configs as TC
from repro_torch import train
from repro_torch.configs.base import AxPolicy, ParallelConfig
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import cache_shardings, make_mesh, tree_paths
from repro_torch.launch.parallel import mesh_groups, serve_params
from repro_torch.launch.sharding import current_tp, set_mesh_ctx
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.layers import decode_attention_split
from repro_torch.serve import ServeConfig, generate, prefill_one, token_step
from repro_torch.train.checkpoint import _block

FRAMES = 24
TIMEOUT = 300


def config(arch, cfg_kw):
    """``tests/_torch_jax_serve.py``'s reduced config, as the port's."""
    kw = dict(cfg_kw)
    ax = kw.pop("ax", None)
    return dataclasses.replace(TC.reduced(TC.ARCHS[arch]), n_layers=2, compute_dtype="float32",
                               ax=AxPolicy(backend=ax) if ax else None, **kw)


def wait_for(path, timeout_s=240.0):
    import time

    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout_s} s")
        time.sleep(0.2)


def _batch(inp):
    return {k: torch.from_numpy(inp[k]).long() if k in ("tokens", "pos") else
            torch.from_numpy(inp[k]) for k in ("tokens", "embeds", "pos", "frames") if k in inp}


def _np(t):
    return t.detach().float().numpy()


def serve_loop(params, cfg, job, inp, par=None):
    """The prefill and the teacher-forced decode steps of a job (the JAX
    helper's), under whatever mesh context is installed: (logits, cache)."""
    S, L = job["S"], job["L"]
    slots = bool(job.get("slots"))
    lens = torch.from_numpy(inp["lens"]).long() if slots else None
    with torch.inference_mode():
        lg, cache = prefill(params, _batch(inp), cfg, par, max_cache_len=L, prompt_lens=lens)
        out = [_np(lg)]
        for i in range(job["steps"]):
            tok = torch.from_numpy(inp["teacher"][:, i:i + 1]).long()
            if slots:
                lg, cache = decode_step(params, cache, tok,
                                        torch.from_numpy(inp["positions"][i]).long(), cfg, par,
                                        write_mask=torch.from_numpy(inp["masks"][i]))
            else:
                lg, cache = decode_step(params, cache, tok, S + i, cfg, par)
            out.append(_np(lg))
    return out, cache


def cache_blocks(cache, cfg, job, mesh, par):
    """{path: (this rank's index of the whole leaf as [lo, hi] per dim, the
    block)} under ``launch.mesh.cache_shardings`` of the whole cache."""
    whole = init_cache(cfg, job["B"], job["L"], device="meta",
                       enc_len=FRAMES if cfg.family == "encdec" else 0)
    specs = dict(zip(*tree_paths(cache_shardings(mesh, par, whole, cfg))))
    out = {}
    for (p, blk), (_, w) in zip(zip(*tree_paths(cache)), zip(*tree_paths(whole))):
        idx = _block(mesh, specs[p], tuple(w.shape))
        assert tuple(s.stop - s.start for s in idx) == tuple(blk.shape), (p, idx, blk.shape)
        out[p] = ([[s.start, s.stop] for s in idx], _np(blk))
    return out


def serve_rank(rank, _mesh, jax_root, jobs):
    """Each job on this world once its JAX params and inputs are on disk: the
    rank's blocks of JAX's params (``serve_params``), the prefill and the
    decode steps under ``set_mesh_ctx``; this rank's rows of the logits and
    its cache blocks.  A job with ``one`` also serves its prompts with
    ``generate(par=)``, and rank 0 runs the prefill, the decode steps and the
    serve on one process (the port's own, the whole weights)."""
    out = {}
    for job in jobs:
        d = os.path.join(jax_root, job["label"])
        wait_for(os.path.join(d, "INPUTS"))
        cfg = config(job["arch"], job.get("cfg", {}))
        par = ParallelConfig(**job["par"])
        tree, _ = train.load_tree(os.path.join(d, "params"), 0)
        whole = params_from_jax(tree, cfg, device="cpu")
        inp = dict(np.load(os.path.join(d, "inputs.npz")))
        mesh = make_mesh(job["shape"], job["axes"], device="cpu")
        local = serve_params(whole, mesh, par)
        with set_mesh_ctx(mesh, par):
            logits, cache = serve_loop(local, cfg, job, inp, par)
        res = {"logits": logits, "rows": list(mesh_groups(mesh, par).rows(job["B"])),
               "cache": cache_blocks(cache, cfg, job, mesh, par)}
        if job.get("one"):
            scfg = ServeConfig(max_new_tokens=job["steps"] + 1)
            prompts = _batch(inp)
            with set_mesh_ctx(mesh, par):
                res["tokens"] = generate(local, prompts, cfg, scfg, par=par,
                                         max_cache_len=job["L"]).numpy()
            if rank == 0:
                res["one_tokens"] = generate(whole, prompts, cfg, scfg,
                                             max_cache_len=job["L"]).numpy()
                one_logits, one_cache = serve_loop(whole, cfg, job, inp)
                res["one"] = (one_logits, {p: _np(v) for p, v in zip(*tree_paths(one_cache))})
        out[job["label"]] = res
    return out


def combine_rank(rank, _mesh, cases):
    """``layers.decode_attention_split`` over the world's ranks, called as
    the sharded decode step calls it: each case ``(B, L, KV, H, hd, window,
    seed)`` builds the same seeded whole cache, query and positions on every
    rank, takes the rank's block of the cache's sequence and combines over
    the world; a windowed case's cache is a ring of ``L`` rows, its query at
    the last row and ``min(ci + 1, L)`` rows filled.  Returns the results."""
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    out = []
    for B, L, KV, H, hd, window, seed in cases:
        rng = np.random.default_rng(seed)
        q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(np.float32))
        k = torch.from_numpy(rng.standard_normal((B, L, KV, hd)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((B, L, KV, hd)).astype(np.float32))
        ci = torch.from_numpy(rng.integers(0, 2 * L, B))
        kv_len = torch.clamp(ci + 1, max=L)
        q_pos = torch.full_like(ci, L - 1) if window else ci
        b = L // n
        got = decode_attention_split(q, k[:, r * b:(r + 1) * b], v[:, r * b:(r + 1) * b], q_pos,
                                     kv_len, lo=r * b, group=dist.group.WORLD)
        out.append(got.numpy())
    return out


def refusal_rank(rank, fleet_mesh):
    """The refusals of the model-sharded serve and what carries no tensor
    parallelism, on a world of 4: {check: ValueError message or a bool}."""
    res = {}
    res["fleet mesh: no tp"] = _tp_under(fleet_mesh, ParallelConfig()) is None
    dp = make_mesh((1, 4), ("data", "model"), device="cpu")
    res["dp_only: no tp"] = _tp_under(dp, ParallelConfig(dp_only=True)) is None
    res["(2, 2): tp"] = _tp_under(make_mesh((2, 2), ("data", "model"), device="cpu"),
                                  ParallelConfig()) is not None
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    par = ParallelConfig(seq_shard=True, remat="none")
    cfg = config("qwen2-72b", {})
    local = serve_params(init_params(cfg, seed=0, device="cpu"), mesh, par)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 16)))
    ssd = dataclasses.replace(config("mamba2-370m", {}), d_model=96)
    ssd_local = serve_params(init_params(ssd, seed=0, device="cpu"), mesh, par)
    scfg = ServeConfig(max_new_tokens=2)
    cases = {
        "cache sequence": lambda: prefill(local, {"tokens": toks}, cfg, par, max_cache_len=26),
        "prompt under seq_shard": lambda: prefill(local, {"tokens": toks[:, :15]}, cfg, par,
                                                  max_cache_len=24),
        "SSD heads": lambda: prefill(ssd_local, {"tokens": toks}, ssd, par, max_cache_len=24),
        "adaptive": lambda: generate(local, {"tokens": toks}, cfg, scfg, par=par,
                                     adaptive=object()),
        "fleet mesh": lambda: generate(local, {"tokens": toks}, cfg, scfg, par=par,
                                       adaptive=object(), mesh=fleet_mesh),
        "token_step": lambda: token_step(local, [], toks[:, 0], toks[:, 0],
                                         torch.ones(4, dtype=torch.bool), cfg),
        "prefill_one": lambda: prefill_one(local, toks[:1], 16, cfg, max_cache_len=24),
    }
    for name, fn in cases.items():
        with set_mesh_ctx(mesh, par):
            try:
                with torch.inference_mode():
                    fn()
                res[name] = None
            except ValueError as e:
                res[name] = str(e)
    return res


def _tp_under(mesh, par):
    with set_mesh_ctx(mesh, par):
        return current_tp()


def jobs_rank(rank, mesh, jobs):
    """Several rank functions of this module in one world: ``jobs`` is a
    list of (function name, args); returns their results in order."""
    return [globals()[name](rank, mesh, *args) for name, args in jobs]

"""Rank functions of ``tests/test_torch_serve_tp.py``, spawned by
``repro_torch.launch.mesh.spawn`` on the CPU.  Each runs on one rank of a
``gloo`` world, builds its meshes with ``launch.mesh.make_mesh`` and returns
numpy results for the test process.  No JAX here: the JAX package's params
and inputs come in as the files of ``tests/_torch_jax_serve.py``.
"""
import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.configs as TC
from repro_torch import train
from repro_torch.configs.base import AxPolicy, ParallelConfig
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import drift_hook
from repro_torch.launch.mesh import cache_shardings, make_mesh, tree_paths
from repro_torch.launch.parallel import mesh_groups, serve_params
from repro_torch.launch.sharding import current_tp, set_mesh_ctx
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.layers import decode_attention_split
from repro_torch.fleet.scheduler import ContinuousBatcher
from repro_torch.serve import ServeConfig, generate, prefill_one, splice_slot, token_step
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
    ctrl, _ = _controller(config("qwen2-72b", {"ax": "kernel"}), {}, 0)
    wcfg = config("whisper-base", {"ax": "kernel"})
    wlocal = serve_params(init_params(wcfg, seed=0, device="cpu"), mesh, par)
    frames = torch.zeros((4, FRAMES, wcfg.d_model))
    cases = {
        "cache sequence": lambda: prefill(local, {"tokens": toks}, cfg, par, max_cache_len=26),
        "prompt under seq_shard": lambda: prefill(local, {"tokens": toks[:, :15]}, cfg, par,
                                                  max_cache_len=24),
        "SSD heads": lambda: prefill(ssd_local, {"tokens": toks}, ssd, par, max_cache_len=24),
        "fleet mesh": lambda: generate(local, {"tokens": toks}, cfg, scfg, par=par,
                                       adaptive=ctrl, mesh=fleet_mesh),
        "batcher on a fleet mesh": lambda: ContinuousBatcher(local, cfg, adaptive=ctrl,
                                                             mesh=fleet_mesh, par=par),
        "generate as a CUDA graph": lambda: _as_card(lambda: generate(
            local, {"tokens": toks}, cfg, scfg, par=par, adaptive=ctrl)),
        "token_step as a CUDA graph": lambda: _as_card(lambda: token_step(
            local, [], toks[:, 0], toks[:, 0], torch.ones(4, dtype=torch.bool), cfg, par)),
        "adaptive whisper": lambda: generate(wlocal, {"frames": frames, "tokens": toks[:, :4]},
                                             wcfg, scfg, par=par, adaptive=ctrl),
        "splice of another layout": lambda: splice_slot(
            prefill(local, {"tokens": toks}, cfg, par, max_cache_len=32)[1],
            prefill_one(local, toks[:1], 16, cfg, par, max_cache_len=24, rows=4)[1], 0),
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


def _as_card(fn):
    """``fn`` with the engine's graph switch as the card sets it (CUDA graphs
    wherever they are asked for)."""
    from repro_torch.serve import engine

    use = engine._use_graphs
    engine._use_graphs = lambda device, enabled: enabled
    try:
        return fn()
    finally:
        engine._use_graphs = use


def _tp_under(mesh, par):
    with set_mesh_ctx(mesh, par):
        return current_tp()


def jobs_rank(rank, mesh, jobs):
    """Several rank functions of this module in one world: ``jobs`` is a
    list of (function name, args); returns their results in order."""
    return [globals()[name](rank, mesh, *args) for name, args in jobs]


# ---------------------------------------------------------------------------
# adaptive serving of a model-sharded model (tests/test_torch_serve_tp_adaptive.py)
# ---------------------------------------------------------------------------

def _controller(cfg, ctrl_kw, tile_rows, store=None):
    """An adaptive controller on the CPU whose observed records are kept
    (host numpy, as the controller took them)."""
    import repro_torch.runtime as TR

    ctrl = TR.AdaptiveController(TR.SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                 TR.AdaptiveConfig(tile_rows=tile_rows, **ctrl_kw),
                                 store=store, device="cpu")
    seen = []
    observe = ctrl.observe

    def recording(records):
        seen.append({t: {k: np.array(v) for k, v in rec.items()} for t, rec in records.items()})
        return observe(records)

    ctrl.observe = recording
    return ctrl, seen


def _events(ctrl):
    """Re-tunes, tile re-tunes and the policy JSON, as the JAX helper
    writes them (``tests/_torch_jax_serve_adaptive.py``)."""
    short = (lambda c: None if c is None else c.short())
    return {"retunes": [[e.step, e.target, short(e.old), short(e.new), float(e.old_score),
                         float(e.new_score)] for e in ctrl.retunes],
            "tile_retunes": [[e.step, e.target, np.asarray(e.grid).tolist(), float(e.new_score)]
                             for e in ctrl.tile_retunes],
            "policy": ctrl.policy.to_json()}


def _run(tokens, seen, ctrl):
    return dict(_events(ctrl), tokens=np.asarray(tokens), records=seen)


def _adapt_job(job):
    d = job["dir"]
    wait_for(os.path.join(d, "INPUTS"))
    cfg = config(job["arch"], job.get("cfg", {}))
    tree, _ = train.load_tree(os.path.join(d, "params"), 0)
    return cfg, params_from_jax(tree, cfg, device="cpu"), dict(np.load(os.path.join(d,
                                                                                    "inputs.npz")))


def adapt_rank(rank, _mesh, jobs):
    """Each job's adaptive serves on this world once its JAX params and
    inputs are on disk, under ``set_mesh_ctx`` with the rank's blocks of the
    params: ``generate(par=, adaptive=, param_hook=drift_hook(...))`` per
    mode, the fused adaptive serves of the modes in ``fused`` (three
    generations, the drift after the first), the teacher-forced steps of ``teacher`` under
    the job's fixed grid.  Then the one-process teacher-forced runs with
    the whole weights, spread over the ranks (each on one rank, under
    ``"one"``)."""
    out, refs = {}, []
    for job in jobs:
        cfg, whole, inp = _adapt_job(job)
        par = ParallelConfig(**job["par"])
        mesh = make_mesh(job["shape"], job["axes"], device="cpu")
        local = serve_params(whole, mesh, par)
        at, scale = job["drift"]
        res = out[job["label"]] = {}
        for tr in job["modes"]:
            ctrl, seen = _controller(cfg, job["ctrl"], tr)
            with set_mesh_ctx(mesh, par):
                toks = generate(local, _prompts(inp), cfg, ServeConfig(max_new_tokens=job["new"]),
                                par=par, adaptive=ctrl, param_hook=drift_hook(at, scale),
                                max_cache_len=job["L"])
            res[f"gen{tr}"] = _run(toks, seen, ctrl)
            if tr in job.get("fused", ()):
                with set_mesh_ctx(mesh, par):
                    res[f"fused{tr}"] = _fused(local, cfg, job, inp, tr, par)
        if job.get("teacher"):
            with set_mesh_ctx(mesh, par):
                res["teacher"] = _teacher(local, cfg, job, inp, par)
            res["teacher"]["rows"] = list(mesh_groups(mesh, par).rows(job["B"]))
            refs.append((job, cfg, whole, inp))
    for i, (job, cfg, whole, inp) in enumerate(refs):
        if i % dist.get_world_size() == rank:
            out[job["label"]]["one"] = {"teacher": _teacher(whole, cfg, job, inp, None)}
    return out


def _prompts(inp):
    return {"tokens": torch.from_numpy(inp["tokens"]).long()}


def _fused(params, cfg, job, inp, tr, par):
    """Three fused adaptive generations with one controller, the drift hook's
    params after the first (the last one's tokens)."""
    from repro_torch.launch.serve import drift_hook

    ctrl, seen = _controller(cfg, job["ctrl"], tr)
    moved = drift_hook(0, job["drift"][1])(0, params)
    for p in (params, moved, moved):
        toks = generate(p, _prompts(inp), cfg, ServeConfig(max_new_tokens=job["new"]), par=par,
                        adaptive=ctrl, max_cache_len=job["L"])
    return _run(toks, seen, ctrl)


def _teacher(params, cfg, job, inp, par):
    """The prefill and teacher-forced decode steps under the job's fixed
    grid (its first triple in scalar mode): logits and each step's
    records."""
    import repro_torch.runtime as TR

    tr = max(job["modes"])
    grid = torch.from_numpy(inp["grid"] if tr else inp["grid"][0, 0])
    dyn = {t: grid for t in cfg.ax.targets}
    logits, recs = [], []
    with torch.inference_mode():
        lg, cache = prefill(params, _prompts(inp), cfg, par, max_cache_len=job["L"])
        logits.append(_np(lg))
        for i in range(job["teacher"]):
            tok = torch.from_numpy(inp["teacher"][:, i:i + 1]).long()
            with TR.ax_scope(dyn, collect=True, tile_rows=tr) as sc:
                lg, cache = decode_step(params, cache, tok, job["S"] + i, cfg, par)
            logits.append(_np(lg))
            recs.append({t: {k: v.numpy() for k, v in r.items()}
                         for t, r in sc.collected().items()})
    return dict(logits=logits, records=recs)


def batcher_rank(rank, _mesh, job):
    """Two token-mode ``ContinuousBatcher(adaptive=, par=)`` drains under
    ``set_mesh_ctx`` with the rank's blocks of the params, the second of
    the drift hook's drifted blocks, with one controller (as the JAX
    helper's); rank 0 alone holds the policy store.  Returns each request's
    tokens, the re-tunes, the observed steps, every reading of the
    batchers' clocks, each rank's slot rows and the store's version; and
    under ``"wave"`` the same of one wave-mode drain (``"wave_one"``: on
    rank 0, one process with the whole weights)."""
    from repro_torch.fleet import BatcherConfig, ContinuousBatcher, PolicyStore, Request

    cfg, whole, inp = _adapt_job(job)
    par = ParallelConfig(**job["par"])
    mesh = make_mesh(job["shape"], job["axes"], device="cpu")
    local = serve_params(whole, mesh, par)
    bk = job["batcher"]
    store = PolicyStore(os.path.join(job["dir"], "store")) if rank == 0 else None
    ctrl, _ = _controller(cfg, job["ctrl"], 0, store=store)
    if store is not None:
        ctrl.resume_from_store()
    readings, tokens = [], {}
    with set_mesh_ctx(mesh, par):
        drains = [local, drift_hook(0, job["drift"][1])(0, local)]
    for j, params in enumerate(drains):
        with set_mesh_ctx(mesh, par):
            bat = ContinuousBatcher(params, cfg, BatcherConfig(
                n_slots=bk["slots"], prompt_buckets=tuple(bk["buckets"]),
                new_token_bucket=bk["new"], token_granular=True), adaptive=ctrl, par=par)
        clock = bat.clock
        bat.clock = lambda clock=clock: readings.append(clock()) or readings[-1]
        for i in range(bk["n"]):
            bat.submit(Request(100 * j + i, inp[f"req{i}"].copy(), int(inp["budgets"][i])))
        tokens.update({str(c.rid): [int(t) for t in c.tokens] for c in bat.run()})
    out = dict(_events(ctrl), tokens=tokens, steps=int(ctrl.step), clock=readings,
               rows=[bat._row0, bat.rows],
               versions=None if store is None else store.current_version())
    # a wave-mode drain of the params with a controller of its own, and on
    # rank 0 the same on one process with the whole weights
    for name, params, ctx in (("wave", local, lambda: set_mesh_ctx(mesh, par)),
                              ("wave_one", whole, contextlib.nullcontext)):
        if name == "wave_one" and rank:
            continue
        ctrl, _ = _controller(cfg, job["ctrl"], 0)
        with ctx():
            bat = ContinuousBatcher(params, cfg, BatcherConfig(
                n_slots=bk["slots"], prompt_buckets=tuple(bk["buckets"]),
                new_token_bucket=bk["new"]), adaptive=ctrl, par=par)
        for i in range(bk["n"]):
            bat.submit(Request(i, inp[f"req{i}"].copy(), int(inp["budgets"][i])))
        done = bat.run()
        out[name] = dict(_events(ctrl), tokens={str(c.rid): [int(t) for t in c.tokens]
                                                for c in done},
                         waves={str(c.rid): int(c.wave) for c in done}, steps=int(ctrl.step))
    return out


def token_rank(rank, _mesh, job):
    """``prefill_one(par=)``, ``splice_slot`` and ``token_step(par=,
    adaptive=)`` under ``set_mesh_ctx`` against the same calls on one
    process with the whole weights: two requests prefilled over the slot
    count and spliced, then observed token steps; returns the first tokens,
    each step's tokens and records, and the rank's cache block with its
    index in the whole slot cache."""
    cfg = config(job["arch"], job.get("cfg", {}))
    whole = init_params(cfg, seed=0, device="cpu")
    par = ParallelConfig(**job["par"])
    mesh = make_mesh(job["shape"], job["axes"], device="cpu")
    local = serve_params(whole, mesh, par)
    B, L, S = job["B"], job["L"], job["S"]
    rng = np.random.default_rng(7)
    reqs = [rng.integers(0, cfg.vocab, n) for n in (S - 3, S)]
    out = {}
    for name, params, ctx in (("sharded", local, lambda: set_mesh_ctx(mesh, par)),
                              ("one", whole, contextlib.nullcontext)):
        ctrl, _ = _controller(cfg, job["ctrl"], job["tile_rows"])
        with ctx(), torch.inference_mode():
            if name == "sharded":
                lo, hi = mesh_groups(mesh, par).rows(B)
                cache = _slot_block(cfg, B, L, mesh, par)
            else:
                lo, hi = 0, B
                cache = init_cache(cfg, B, L, device="cpu")
            firsts = []
            tok = np.zeros(B, np.int64)
            pos = np.zeros(B, np.int64)
            for slot, r in zip((1, B - 1), reqs):
                padded = np.concatenate([r, np.full(S - len(r), r[-1])])[None]
                first, fresh = prefill_one(params, padded, len(r), cfg, par, max_cache_len=L,
                                           rows=B)
                firsts.append(int(first[0]))
                if lo <= slot < hi:
                    splice_slot(cache, fresh, slot - lo)
                tok[slot], pos[slot] = int(first[0]), len(r)
            active = torch.zeros(B, dtype=torch.bool)
            active[[1, B - 1]] = True
            steps = []
            for i in range(job["steps"]):
                t, cache, rec = token_step(params, cache, torch.from_numpy(tok),
                                           torch.from_numpy(pos), active, cfg, par,
                                           adaptive=ctrl, cuda_graphs=False)
                steps.append((t.numpy().copy(), {k: {f: v.numpy().copy() for f, v in r.items()}
                                                 for k, r in rec.items()}))
                tok, pos = t.numpy().astype(np.int64), pos + active.numpy()
        out[name] = dict(firsts=firsts, steps=steps,
                         cache={p: _np(v) for p, v in zip(*tree_paths(cache))})
    specs = dict(zip(*tree_paths(cache_shardings(
        mesh, par, init_cache(cfg, B, L, device="meta"), cfg))))
    out["index"] = {p: [[s.start, s.stop] for s in _block(mesh, specs[p], v.shape)]
                    for p, v in out["one"]["cache"].items()}
    return out


def _slot_block(cfg, B, L, mesh, par):
    """This rank's block of an empty slot cache of ``B`` slots."""
    whole = init_cache(cfg, B, L, device="meta")
    specs = tree_paths(cache_shardings(mesh, par, whole, cfg))[1]
    from repro_torch.launch.mesh import tree_unflatten

    return tree_unflatten(whole, [torch.zeros([s.stop - s.start for s in _block(mesh, sp, l.shape)],
                                              dtype=l.dtype)
                                  for sp, l in zip(specs, tree_paths(whole)[1])])


def drift_rank(rank, _mesh, job):
    """``drift_hook`` on the rank's blocks under ``set_mesh_ctx``: the
    drifted blocks with their indices in the whole leaves (a config whose
    ``ff`` blocks start at odd rows)."""
    from repro_torch.launch.serve import drift_hook

    cfg = config(job["arch"], job.get("cfg", {}))
    whole = init_params(cfg, seed=0, device="cpu")
    par = ParallelConfig(**job["par"])
    mesh = make_mesh(job["shape"], job["axes"], device="cpu")
    local = serve_params(whole, mesh, par)
    with set_mesh_ctx(mesh, par):
        moved = drift_hook(0, job["scale"])(0, local)
        try:
            drift_hook(0, job["scale"])(0, whole)      # whole weights: no noted blocks
            refused = None
        except ValueError as e:
            refused = str(e)
    from repro_torch.launch.parallel import serve_param_specs

    specs = dict(zip(*tree_paths(serve_param_specs(mesh, par, whole))))
    out = {}
    for p, v in zip(*tree_paths(moved)):
        w = dict(zip(*tree_paths(whole)))[p]
        out[p] = ([[s.start, s.stop] for s in _block(mesh, specs[p], tuple(w.shape))], _np(v))
    return dict(blocks=out, refused=refused)


def card_adapt_rank(rank, _mesh, prompts):
    """The tp adapt phase's smallest case on one of two ``gloo`` ranks
    sharing the card (``tests/test_torch_gpu.py``): the reduced qwen2 (bf16,
    ``mxu``) under ``set_mesh_ctx`` of ``("data", "model")`` = (1, 2),
    ``chip_smoke._tpa_serves``' drift serves and token drains; returns
    their results (numpy)."""
    import chip_smoke

    cfg = card_adapt_config()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh((1, 2), ("data", "model"), device="cuda", backend="gloo")
    par = ParallelConfig(fsdp=True, seq_shard=True, ep=True)
    local = serve_params(init_params(cfg, seed=0, device=dev), mesh, par)
    with set_mesh_ctx(mesh, par):
        return chip_smoke._tpa_serves(local, cfg, prompts.to(dev), dev, par)


def card_adapt_config():
    """The reduced qwen2 of ``card_adapt_rank``: 2 layers, bf16, ``mxu``."""
    return dataclasses.replace(TC.reduced(TC.ARCHS["qwen2-72b"]), n_layers=2,
                               ax=AxPolicy(backend="mxu"))


# (backend, mult, B, S, K, N, tile_rows, seed) of ``row_split_rank``: a batch
# of 6 over 2 ranks ([0, 3) and [3, 6)); at S = 3, 18 rows in 4 tiles of 5,
# tile 1 ([5, 10)) straddling the ranks, the head and each tile's head
# sampled from both
ROW_SPLIT = [("kernel", "mul8s_drum3_4", 6, 3, 256, 40, 4, 7),
             ("mxu", "mul8s_trunc0_4", 6, 3, 256, 40, 4, 8),
             ("emul", "mul8s_drum3_4", 6, 1, 512, 24, 4, 9)]


def row_split_rank(rank, fleet_mesh, cases):
    """One projection of a batch split over the world's ranks, as a batch
    shard of the model-sharded serve runs it: each case ``(backend, mult,
    B, S, K, N, tile_rows, seed)`` builds the same seeded (B, S, K)
    activations, (K, N) weight and (tile_rows, 1, 3) grid on every rank,
    then ``ax_dense_dyn`` in an observed tile-mode scope (with the grid
    kernel's histogram where the backend is ``kernel``) of the whole batch
    and of this rank's rows (``rows=``).  Returns per case whether the
    rank's outputs equal its rows of the whole's and its records the
    whole's (field by field), and the grid kernel's launches of the rank's
    call, on the world's device (the card or the CPU)."""
    from repro_torch.kernels.ax_matmul import LAUNCHES
    from repro_torch.quant.ax import ax_dense_dyn
    from repro_torch.runtime.scope import ax_scope

    dev = (torch.device("cuda", torch.cuda.current_device())
           if fleet_mesh.device_type == "cuda" else torch.device("cpu"))
    n, r = dist.get_world_size(), dist.get_rank()
    out = []
    for backend, mult, B, S, K, N, tile_rows, seed in cases:
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal((B, S, K)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(dev)
        grid = torch.from_numpy(np.stack([rng.integers(0, 2, tile_rows), rng.integers(0, 8, tile_rows),
                                          rng.integers(0, 2, tile_rows)], -1)[:, None]
                                .astype(np.int32)).to(dev)
        pol = AxPolicy(mult_name=mult, backend=backend)
        hist = backend == "kernel"

        def call(xs, rows):
            with ax_scope({}, collect=True, tile_rows=tile_rows, kernel_hist=hist) as sc:
                y = ax_dense_dyn(xs, w, pol, grid, scope=sc, target="attn_qkv", rows=rows)
            return y, sc.collected()

        whole, want = call(x, None)
        lo, hi = r * (B // n), (r + 1) * (B // n)
        grids0 = LAUNCHES["ax_matmul_grid"]
        y, got = call(x[lo:hi], (lo, hi, B, dist.group.WORLD))
        launches = LAUNCHES["ax_matmul_grid"] - grids0
        same = sorted(got) == sorted(want) and all(
            sorted(got[t]) == sorted(want[t]) and all(
                got[t][k].shape == want[t][k].shape and torch.equal(got[t][k], want[t][k])
                for k in want[t]) for t in want)
        out.append(dict(rows=bool(torch.equal(y, whole[lo:hi])), records=bool(same),
                        targets=sorted(got), launches=launches))
    return out


# ---------------------------------------------------------------------------
# float sums in rank order, the graph predicate, the host copies of a step
# (tests/test_torch_serve_tp_order.py)
# ---------------------------------------------------------------------------

def order_inputs(case):
    """A combine case's seeded whole cache, query and positions (numpy):
    ``(B, L, KV, H, hd, dtype, seed)``; ``L`` rows split over the ranks."""
    B, L, KV, H, hd, dtype, seed = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, H, hd), (B, L, KV, hd), (B, L, KV, hd)))
    ci = rng.integers(0, 2 * L, B)
    return q, k, v, ci, np.minimum(ci + 1, L)


def order_rank(rank, _fleet, cases):
    """On a world of 4: each combine case through ``decode_attention_split``
    over the K/V group of a ``("data", "model")`` = (1, 4) mesh, called as
    the sharded decode step calls it (the rank's block of the cache's
    sequence); the graph predicate and the program key's part of the
    context under ``gloo`` and with every group reporting ``nccl``
    (``dist.get_backend`` replaced); and the ``torch.tensor`` calls on host
    lists during a second observed adaptive token step at (2, 2), the first
    one run before the count."""
    from repro_torch.serve import engine

    out = {"combine": []}
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    par = ParallelConfig(fsdp=True, seq_shard=True, ep=True)
    for case in cases:
        B, L, KV, H, hd, dtype, _ = case
        q, k, v, ci, kv_len = (torch.from_numpy(a) for a in order_inputs(case))
        q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
        group, index, n = mesh_groups(mesh, par).kv_group(B)
        b = L // n
        got = decode_attention_split(q, k[:, index * b:(index + 1) * b],
                                     v[:, index * b:(index + 1) * b], ci, kv_len,
                                     lo=index * b, group=group)
        out["combine"].append(got.float().numpy())
    cfg = config("qwen2-72b", {"ax": "kernel"})
    local = serve_params(init_params(cfg, seed=0, device="cpu"), mesh, par)
    mesh22 = make_mesh((2, 2), ("data", "model"), device="cpu")
    with set_mesh_ctx(mesh, par):
        out["backend"] = dist.get_backend()
        out["graphs gloo"] = engine.model_sharded_graphs()
        out["sig"] = repr(engine._mesh_sig(4))
        out["sig again"] = repr(engine._mesh_sig(4))
        real = dist.get_backend
        dist.get_backend = lambda group=None: "nccl"
        try:
            out["graphs nccl"] = engine.model_sharded_graphs()
            bat = ContinuousBatcher(local, cfg, adaptive=_controller(cfg, {}, 0)[0], par=par)
            out["batcher graphs nccl"] = bat._engine_kw().get("cuda_graphs")
        finally:
            dist.get_backend = real
        bat = ContinuousBatcher(local, cfg, adaptive=_controller(cfg, {}, 0)[0], par=par)
        out["batcher graphs gloo"] = bat._engine_kw().get("cuda_graphs")
    with set_mesh_ctx(mesh22, par):
        out["sig 22"] = repr(engine._mesh_sig(4))
    out["host lists"] = _host_lists_in_a_step(cfg, mesh22, par)
    return out


def _host_lists_in_a_step(cfg, mesh, par):
    """The ``torch.tensor`` calls on a host list or tuple during the second
    of two observed adaptive token steps (tile mode, 2 row tiles) under
    ``set_mesh_ctx`` of ``mesh``: the reduced qwen2's 4 query heads over 2
    model ranks split its one kv head's group, and the batch of 4 splits
    over ``"data"`` (the records' gathered rows)."""
    local = serve_params(init_params(cfg, seed=0, device="cpu"), mesh, par)
    ctrl, _ = _controller(cfg, {}, 2)
    B, L = 4, 24
    calls = []
    real = torch.tensor

    def counting(data, *a, **kw):
        if isinstance(data, (list, tuple)):
            calls.append(repr(data)[:60])
        return real(data, *a, **kw)

    with set_mesh_ctx(mesh, par), torch.inference_mode():
        cache = _slot_block(cfg, B, L, mesh, par)
        tok = torch.arange(B, dtype=torch.int64)
        pos = torch.full((B,), 3, dtype=torch.int64)
        active = torch.ones(B, dtype=torch.bool)
        for i in range(2):
            if i == 1:
                torch.tensor = counting
            try:
                tok, cache, rec = token_step(local, cache, tok, pos + i, active, cfg, par,
                                             adaptive=ctrl, cuda_graphs=False)
            finally:
                torch.tensor = real
    return dict(calls=calls, records=sorted(rec))


def card_graph_rank(rank, _mesh, prompts):
    """The tp graph phase's smallest case on one of four ``nccl`` ranks, one
    card each (``tests/test_torch_gpu.py``): the reduced qwen2 (bf16,
    ``mxu``) under ``set_mesh_ctx`` of ``("data", "model")`` = (1, 4), the
    static serve and the fused adaptive serve in scalar and tile mode (2
    row tiles), each twice, eager and then as CUDA graphs; returns each
    serve's tokens, the records its controller observed and the graph
    captures of each serve (numpy and plain values)."""
    from repro_torch.serve import engine
    from repro_torch.serve import graph as G

    cfg = card_adapt_config()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh((1, 4), ("data", "model"), device="cuda", backend="nccl")
    par = ParallelConfig(fsdp=True, seq_shard=True, ep=True)
    local = serve_params(init_params(cfg, seed=0, device=dev), mesh, par)
    out = {"device": str(dev)}
    for mode in ("eager", "graph"):
        use = engine._use_graphs
        if mode == "eager":
            engine._use_graphs = lambda device, enabled: False
        try:
            res = {}
            for name, tr in (("static", None), ("scalar", 0), ("tile", 2)):
                ctrl, seen = (None, []) if tr is None else _controller(cfg, {}, tr)
                caps, toks = [], []
                for _ in range(2):
                    c0 = sum(G.captures_by_kind().values())
                    with set_mesh_ctx(mesh, par):
                        toks.append(generate(local, {"tokens": prompts.to(dev)}, cfg,
                                             ServeConfig(max_new_tokens=8), par=par,
                                             adaptive=ctrl, max_cache_len=48).cpu().numpy())
                    caps.append(sum(G.captures_by_kind().values()) - c0)
                res[name] = dict(tokens=toks, captures=caps, records=seen)
        finally:
            engine._use_graphs = use
        out[mode] = res
    G.clear_programs()
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# rank-local weights (tests/test_torch_serve_init.py)
# ---------------------------------------------------------------------------

INIT_FAMILIES = ("qwen2-72b", "qwen2-vl-72b", "gemma3-27b", "deepseek-moe-16b",
                 "recurrentgemma-2b", "mamba2-370m", "whisper-base")
INIT_PARS = {"jax": dict(fsdp=True, seq_shard=True, ep=True), "dp_only": dict(dp_only=True),
             "seq_shard": dict(seq_shard=True)}
INIT_CHUNK = 4096                 # layers.CHUNK in the size check: several chunks a block


class _Made(TorchDispatchMode):
    """The largest tensor (in elements) any op makes off the ``meta`` device."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if torch.is_tensor(t) and t.device.type != "meta":
                self.largest = max(self.largest, t.numel())
        return out


def init_config(arch):
    """The reduced config of ``arch`` (its 4 layers; whisper 2 + 4)."""
    return TC.reduced(TC.ARCHS[arch])


def _same_blocks(got, want, groups):
    """Paths whose blocks differ in bits, and those whose noted offsets do."""
    bad, starts = [], []
    for (p, g), (_, w) in zip(zip(*tree_paths(got)), zip(*tree_paths(want))):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            bad.append(p)
        s = groups.block_starts(g)
        if s is None or s != groups.block_starts(w):
            starts.append(p)
    return bad, starts


def init_blocks_rank(rank, _mesh, shape, archs, pars):
    """Per config and layout (a ``ParallelConfig`` of ``pars``) on a
    ``("data", "model")`` mesh of ``shape``: this rank's
    ``init_serve_params`` against ``serve_params(init_blocks(cfg))`` (bits
    and the noted offsets), or both refusals; under JAX's default layout
    also the largest tensor ``init_serve_params`` made (``layers.CHUNK`` at
    ``INIT_CHUNK``) beside the rank's largest block and the largest whole
    leaf (elements)."""
    from repro_torch.launch.parallel import init_serve_params
    from repro_torch.models import init_blocks, layers

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = {}
    for arch in archs:
        cfg = init_config(arch)
        whole = init_blocks(cfg, device="cpu")
        for name, kw in pars.items():
            par = ParallelConfig(**kw)
            res = {}
            try:
                want = serve_params(whole, mesh, par)
            except ValueError as e:
                want = res["want_refused"] = str(e)
            made, chunk = _Made(), layers.CHUNK
            layers.CHUNK = INIT_CHUNK
            try:
                with made:
                    got = init_serve_params(cfg, mesh, par, device="cpu")
            except ValueError as e:
                got = res["got_refused"] = str(e)
            finally:
                layers.CHUNK = chunk
            if not isinstance(got, str) and not isinstance(want, str):
                res["bad"], res["starts"] = _same_blocks(got, want, mesh_groups(mesh, par))
                res["made"] = made.largest
                res["largest_block"] = max(t.numel() for t in tree_paths(got)[1])
                res["largest_leaf"] = max(t.numel() for t in tree_paths(whole)[1])
            out[(arch, name)] = res
    return out


def init_serve_rank(rank, _mesh, shape):
    """The reduced qwen2 (2 layers, ``mxu``) under JAX's default layout on a
    ``("data", "model")`` mesh of ``shape``, served from this rank's
    ``init_serve_params`` and from ``serve_params(init_blocks(cfg))``: the
    prefill's and 3 teacher-forced decode steps' logits (this rank's rows),
    a greedy ``generate`` and a drift serve (``drift_hook(1, 0.05)``) each,
    as numpy."""
    from repro_torch.launch.parallel import init_serve_params
    from repro_torch.models import init_blocks

    cfg = dataclasses.replace(init_config("qwen2-72b"), n_layers=2, ax=AxPolicy(backend="mxu"))
    par = ParallelConfig(**INIT_PARS["jax"])
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    job = dict(B=4, S=8, L=16, steps=3)
    rng = np.random.default_rng(11)
    inp = dict(tokens=rng.integers(0, cfg.vocab, (4, 8)),
               teacher=rng.integers(0, cfg.vocab, (4, 3)))
    prompts = {"tokens": torch.from_numpy(inp["tokens"])}
    scfg = ServeConfig(max_new_tokens=4)
    out = {}
    for name, params in (("init", init_serve_params(cfg, mesh, par, seed=3, device="cpu")),
                         ("whole", serve_params(init_blocks(cfg, seed=3, device="cpu"), mesh,
                                                par))):
        with set_mesh_ctx(mesh, par):
            logits, _ = serve_loop(params, cfg, job, inp, par)
            tokens = generate(params, prompts, cfg, scfg, par=par, max_cache_len=16).numpy()
            drift = generate(params, prompts, cfg, scfg, par=par, max_cache_len=16,
                             param_hook=drift_hook(1, 0.05)).numpy()
        out[name] = dict(logits=logits, tokens=tokens, drift=drift)
    return out


def init_convert_rank(rank, _mesh, shape, np_trees):
    """``convert.serve_params_from_jax`` of each JAX param tree against
    ``serve_params(params_from_jax(...))`` under JAX's default layout on a
    ``("data", "model")`` mesh of ``shape``: (paths apart in bits, paths
    whose noted offsets differ) per config."""
    from repro_torch.convert import serve_params_from_jax

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    par = ParallelConfig(**INIT_PARS["jax"])
    out = {}
    for arch, tree in np_trees.items():
        cfg = init_config(arch)
        got = serve_params_from_jax(tree, cfg, mesh, par, device="cpu")
        want = serve_params(params_from_jax(tree, cfg, device="cpu"), mesh, par)
        out[arch] = _same_blocks(got, want, mesh_groups(mesh, par))
    return out

"""The JAX package's own adaptive serve of a model-sharded model (GSPMD),
run as a subprocess for ``tests/test_torch_serve_tp_adaptive.py``.

    python tests/_torch_jax_serve_adaptive.py OUT_DIR JOBS_JSON

As ``tests/_torch_jax_serve.py``: the file sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu`` before it imports JAX, builds each mesh directly
(``jax.sharding.Mesh``, whose axes are ``Auto``), places the params by
``param_shardings`` and runs the package's entry points under
``set_mesh_ctx``.

Each job (a dict: ``label``, ``arch``, ``shape``, ``axes``, ``par``,
``cfg``, ``B``, ``S``, ``L`` the cache length, ``new`` the tokens per
serve, ``ctrl`` the ``AdaptiveConfig`` fields, ``modes`` the tile rows of
its serves (0: scalar mode), ``drift`` the hook's ``(step, scale)``, and
optionally ``teacher`` (steps), ``fused`` (modes) and ``batcher``) writes to
``OUT_DIR/<label>/``: first, for every job before any runs, its params as a
package checkpoint (``params/step_0``) and its inputs (``inputs.npz``;
``INPUTS`` marks them written); then

* ``gen{t}.npz`` / ``gen{t}.json`` for each mode ``t``: ``generate(par=,
  adaptive=, param_hook=_drift_hook(...))``'s tokens, every record the
  controller observed (``{step}|{target}|{field}``), its re-tunes and tile
  re-tunes and its final policy JSON;
* for each mode ``t`` in ``fused``, ``fused{t}.npz`` / ``.json``: the same of three fused
  adaptive serves (no hook) with one controller, the first of the params,
  the others of the hook's drifted params (the last one's tokens);
* with ``teacher``, ``teacher.npz``: the prefill's and each teacher-forced
  decode step's logits under a fixed dynamic policy (``inputs["grid"]``,
  tile mode at its rows) and each step's records;
* with ``batcher``, ``batcher.json``: two token-mode
  ``ContinuousBatcher(adaptive=, par=)`` drains with one controller, the
  second of the hook's drifted params: each request's tokens, the re-tunes
  and the controller's observed steps; ``wave.json``: the same of one
  wave-mode drain of the params, with each request's wave; and
  ``wave_one.json``: that wave drain on one device (the params unplaced, no
  mesh context, no ``par``), once as the batcher runs it (``fused``: each
  wave one fused adaptive scan) and once with each wave's ``generate`` on
  the package's stepwise loop (``stepwise``: the batcher's ``ServeConfig``
  made with ``fused=False``, the package's own oracle of its fused paths);

and ``DONE``.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.fleet.scheduler as JS  # noqa: E402
import repro.models as JM  # noqa: E402
import repro.runtime as JR  # noqa: E402
import repro.train as JT  # noqa: E402
from repro.configs.base import AxPolicy  # noqa: E402
from repro.fleet import BatcherConfig, ContinuousBatcher, Request  # noqa: E402
from repro.launch.mesh import cache_shardings, param_shardings  # noqa: E402
from repro.launch.serve import _drift_hook  # noqa: E402
from repro.launch.sharding import set_mesh_ctx  # noqa: E402
from repro.serve.engine import ServeConfig, generate  # noqa: E402


def config(arch, cfg_kw):
    kw = dict(cfg_kw)
    ax = kw.pop("ax", None)
    return dataclasses.replace(JC.reduced(JC.ARCHS[arch]), n_layers=2, compute_dtype="float32",
                               ax=AxPolicy(backend=ax) if ax else None, **kw)


def inputs(job, cfg):
    """The job's seeded inputs, as numpy arrays: prompts, teacher tokens, a
    tile grid of the largest mode's rows (a triple per row tile) and the
    batcher's requests."""
    rng = np.random.default_rng(job.get("seed", 3))
    out = {"tokens": rng.integers(0, cfg.vocab, (job["B"], job["S"])).astype(np.int32),
           "teacher": rng.integers(0, cfg.vocab, (job["B"], job.get("teacher", 1)))
           .astype(np.int32)}
    triples = np.asarray([[1, 2, 0], [0, 5, 1], [1, 3, 1], [1, 6, 0]], np.int32)
    gm = max(job["modes"])
    out["grid"] = triples[np.arange(max(gm, 1)) % len(triples)][:, None, :]
    bat = job.get("batcher")
    if bat:
        lens = rng.integers(2, max(bat["buckets"]) + 1, bat["n"])
        for i, n in enumerate(lens):
            out[f"req{i}"] = rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
        out["budgets"] = rng.integers(2, bat["new"] + 1, bat["n"]).astype(np.int32)
    return out


def controller(cfg, ctrl_kw, tile_rows):
    ctrl = JR.AdaptiveController(JR.SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                 cfg=JR.AdaptiveConfig(tile_rows=tile_rows, **ctrl_kw))
    seen = []
    observe = ctrl.observe

    def recording(records):
        seen.append(jax.tree.map(np.array, records))
        return observe(records)

    ctrl.observe = recording
    return ctrl, seen


def events(ctrl):
    short = (lambda c: None if c is None else c.short())
    return {"retunes": [[e.step, e.target, short(e.old), short(e.new), float(e.old_score),
                         float(e.new_score)] for e in ctrl.retunes],
            "tile_retunes": [[e.step, e.target, np.asarray(e.grid).tolist(), float(e.new_score)]
                             for e in ctrl.tile_retunes],
            "policy": ctrl.policy.to_json()}


def save_run(d, name, tokens, seen, ctrl):
    flat = {"tokens": np.asarray(tokens)}
    for i, rec in enumerate(seen):
        for t, fields in rec.items():
            for k, v in fields.items():
                flat[f"{i}|{t}|{k}"] = np.asarray(v)
    np.savez(os.path.join(d, f"{name}.npz"), **flat)
    with open(os.path.join(d, f"{name}.json"), "w") as f:
        json.dump(dict(events(ctrl), n_records=len(seen)), f)


def teacher(job, cfg, params, inp, mesh, par):
    """Prefill and teacher-forced decode steps under a fixed dynamic policy
    (the job's grid in tile mode, its first triple in scalar mode)."""
    tr = max(job["modes"])
    dyn = {t: jnp.asarray(inp["grid"] if tr else inp["grid"][0, 0]) for t in cfg.ax.targets}
    dec_par = dataclasses.replace(par, scan_layers=False)

    def step(p, c, tok, i):
        with set_mesh_ctx(mesh, par):
            with JR.ax_scope(dyn, collect=True, tile_rows=tr) as sc:
                logits, cache = JM.decode_step(p, c, tok, i, cfg, dec_par)
                return logits, cache, sc.collected()

    def pre(p, b):
        with set_mesh_ctx(mesh, par):
            return JM.prefill(p, b, cfg, par, max_cache_len=job["L"])

    logits, cache = jax.jit(pre)(params, {"tokens": jnp.asarray(inp["tokens"])})
    out = {"l0": np.asarray(logits)}
    c_sh = cache_shardings(mesh, par, cache, cfg)
    jstep = jax.jit(step)
    for i in range(job["teacher"]):
        cache = jax.device_put(cache, c_sh)
        lg, cache, rec = jstep(params, cache, jnp.asarray(inp["teacher"][:, i:i + 1]),
                               jnp.int32(job["S"] + i))
        out[f"l{i + 1}"] = np.asarray(lg)
        for t, fields in jax.device_get(rec).items():
            for k, v in fields.items():
                out[f"{i}|{t}|{k}"] = np.asarray(v)
    return out


def batcher(job, cfg, drains, inp, par, ctrl_kw, token=True, stepwise=False):
    """One drain of every request per param tree in ``drains``, each on a
    batcher of its own, with one controller (rids of drain j offset by
    100 j).  ``stepwise``: every ``generate`` of the batcher on the
    package's stepwise loop (its ``ServeConfig`` made with ``fused=False``)."""
    bat_kw = job["batcher"]
    ctrl, _ = controller(cfg, ctrl_kw, 0)
    tokens = {}
    scfg = JS.ServeConfig
    if stepwise:
        JS.ServeConfig = lambda **kw: scfg(**dict(kw, fused=False))
    try:
        done = _drains(bat_kw, cfg, drains, inp, par, ctrl, token, tokens)
    finally:
        JS.ServeConfig = scfg
    return dict(events(ctrl), tokens=tokens, steps=int(ctrl.step),
                waves={str(c.rid): int(c.wave) for c in done})


def _drains(bat_kw, cfg, drains, inp, par, ctrl, token, tokens):
    for j, params in enumerate(drains):
        bat = ContinuousBatcher(params, cfg, BatcherConfig(
            n_slots=bat_kw["slots"], prompt_buckets=tuple(bat_kw["buckets"]),
            new_token_bucket=bat_kw["new"], token_granular=token), adaptive=ctrl, par=par)
        for i in range(bat_kw["n"]):
            bat.submit(Request(100 * j + i, inp[f"req{i}"].copy(), int(inp["budgets"][i])))
        done = bat.run()
        tokens.update({str(c.rid): [int(t) for t in c.tokens] for c in done})
    return done


def main(out_root, jobs):
    assert len(jax.devices()) == 4, jax.devices()
    made = []
    for job in jobs:
        d = os.path.join(out_root, job["label"])
        os.makedirs(d, exist_ok=True)
        cfg = config(job["arch"], job.get("cfg", {}))
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        JT.save(os.path.join(d, "params"), 0, jax.device_get(params))
        inp = inputs(job, cfg)
        np.savez(os.path.join(d, "inputs.npz"), **inp)
        with open(os.path.join(d, "INPUTS"), "w") as f:
            f.write("ok")
        made.append((job, d, cfg, params, inp))
    for job, d, cfg, params, inp in made:
        par = JC.ParallelConfig(**job["par"])
        n = int(np.prod(job["shape"]))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(tuple(job["shape"])),
                    tuple(job["axes"]))
        placed = jax.device_put(params, param_shardings(mesh, par, params))
        prompts = {"tokens": jnp.asarray(inp["tokens"])}
        at, scale = job["drift"]
        for tr in job["modes"]:
            ctrl, seen = controller(cfg, job["ctrl"], tr)
            with set_mesh_ctx(mesh, par):
                toks = generate(placed, prompts, cfg, ServeConfig(max_new_tokens=job["new"]),
                                par=par, adaptive=ctrl, param_hook=_drift_hook(at, scale),
                                max_cache_len=job["L"])
            save_run(d, f"gen{tr}", toks, seen, ctrl)
            if tr in job.get("fused", ()):
                ctrl, seen = controller(cfg, job["ctrl"], tr)
                moved = _drift_hook(0, scale)(0, placed)
                for gen_params in (placed, moved, moved):
                    with set_mesh_ctx(mesh, par):
                        toks = generate(gen_params, prompts, cfg,
                                        ServeConfig(max_new_tokens=job["new"]), par=par,
                                        adaptive=ctrl, max_cache_len=job["L"])
                save_run(d, f"fused{tr}", toks, seen, ctrl)
        if job.get("teacher"):
            np.savez(os.path.join(d, "teacher.npz"),
                     **teacher(job, cfg, placed, inp, mesh, par))
        if job.get("batcher"):
            with set_mesh_ctx(mesh, par):
                res = batcher(job, cfg, [placed, _drift_hook(0, scale)(0, placed)], inp, par,
                              job["ctrl"])
            with open(os.path.join(d, "batcher.json"), "w") as f:
                json.dump(res, f)
            with set_mesh_ctx(mesh, par):
                res = batcher(job, cfg, [placed], inp, par, job["ctrl"], token=False)
            with open(os.path.join(d, "wave.json"), "w") as f:
                json.dump(res, f)
            one = {mode: batcher(job, cfg, [params], inp, None, job["ctrl"], token=False,
                                 stepwise=mode == "stepwise")
                   for mode in ("fused", "stepwise")}
            with open(os.path.join(d, "wave_one.json"), "w") as f:
                json.dump(one, f)
        with open(os.path.join(d, "DONE"), "w") as f:
            f.write("ok")


if __name__ == "__main__":
    main(sys.argv[1], json.loads(sys.argv[2]))

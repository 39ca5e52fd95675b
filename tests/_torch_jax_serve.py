"""The JAX package's own model-sharded prefill and decode step (GSPMD), run
as a subprocess for ``tests/test_torch_serve_tp.py``.

    python tests/_torch_jax_serve.py OUT_DIR JOBS_JSON

As ``tests/_torch_jax_gspmd.py`` does for the train step: the device count
of JAX is fixed when JAX first initialises, so this file runs alone, sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu`` before it imports JAX, and builds each mesh directly
(``jax.sharding.Mesh``, whose axes are ``Auto``).  As
``repro.launch.dryrun.build_cell`` does, it places the params by
``param_shardings``, the batch by ``batch_shardings`` and the cache by
``cache_shardings``, and jits ``registry.prefill`` and
``registry.decode_step`` under ``set_mesh_ctx``.

Each job (a dict: ``label``, ``arch``, ``shape``, ``axes``, ``par``,
``cfg``, ``B``, ``S``, ``L`` the cache length, ``steps``, ``slots``)
writes to ``OUT_DIR/<label>/``: first, for every job before any is
compiled, its params as a package checkpoint (``params/step_0``) and its
inputs (``inputs.npz``: the prompt batch, the teacher tokens, the decode
positions and, with ``slots``, the prompt lengths and the write masks;
``INPUTS`` marks them written); then the sharded run's logits
(``sharded.npz``: the prefill's and each decode step's) and its cache after
the last step (``sharded_cache/step_0``), the same of the one-device run
(``one.npz``, ``one_cache``) from the same inputs, and ``DONE``.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.models as JM  # noqa: E402
import repro.train as JT  # noqa: E402
from repro.configs.base import AxPolicy  # noqa: E402
from repro.launch.mesh import batch_shardings, cache_shardings, param_shardings  # noqa: E402
from repro.launch.sharding import set_mesh_ctx  # noqa: E402

FRAMES = 24


def config(arch, cfg_kw):
    kw = dict(cfg_kw)
    ax = kw.pop("ax", None)
    return dataclasses.replace(JC.reduced(JC.ARCHS[arch]), n_layers=2, compute_dtype="float32",
                               ax=AxPolicy(backend=ax) if ax else None, **kw)


def inputs(job, cfg):
    """The job's seeded inputs (module note), as numpy arrays."""
    B, S, steps = job["B"], job["S"], job["steps"]
    rng = np.random.default_rng(job.get("seed", 3))
    out = {}
    if cfg.family == "vlm":
        out["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        t = np.arange(S)
        out["pos"] = np.broadcast_to(np.stack([t, t // 4, t % 4], -1)[None],
                                     (B, S, 3)).astype(np.int32).copy()
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)
    out["teacher"] = rng.integers(0, cfg.vocab, (B, steps)).astype(np.int32)
    if job.get("slots"):
        lens = np.array([S - (3 * b) % 7 for b in range(B)], np.int32)
        out["lens"] = lens
        out["positions"] = np.stack([lens + i for i in range(steps)]).astype(np.int32)
        masks = np.ones((steps, B), bool)
        masks[1, 1::3] = False               # rows whose write step 1 drops
        out["masks"] = masks
    return out


def _batch(inp):
    return {k: inp[k] for k in ("tokens", "embeds", "pos", "frames") if k in inp}


def run(job, cfg, params, inp, mesh, par):
    """Prefill and the decode steps; on ``mesh`` jitted under set_mesh_ctx with
    the package's shardings, else on one device.  Returns (logits, cache)."""
    L, steps, S, B = job["L"], job["steps"], job["S"], job["B"]
    slots = bool(job.get("slots"))
    batch = _batch(inp)
    extra = (jnp.asarray(inp["lens"]),) if slots else ()

    def ctx():
        return set_mesh_ctx(mesh, par) if mesh is not None else contextlib.nullcontext()

    def pre(p, b, *lens):
        with ctx():
            return JM.prefill(p, b, cfg, par, max_cache_len=L,
                              **({"prompt_lens": lens[0]} if lens else {}))

    def dec(p, c, t, ci, *wm):
        with ctx():
            return JM.decode_step(p, c, t, ci, cfg, par,
                                  **({"write_mask": wm[0]} if wm else {}))

    if mesh is None:
        jpre, jdec = jax.jit(pre), jax.jit(dec)
    else:
        def sds(shape):
            return jax.ShapeDtypeStruct(shape, jnp.int32)

        p_sh = param_shardings(mesh, par, params)
        b_sh = batch_shardings(mesh, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                      for k, v in batch.items()})
        vec = batch_shardings(mesh, {"v": sds((B,))})["v"]
        jpre = jax.jit(pre, in_shardings=(p_sh, b_sh) + ((vec,) if slots else ()))
        c_sh = cache_shardings(mesh, par, jax.eval_shape(pre, params, batch, *extra)[1], cfg)
        t_sh = batch_shardings(mesh, {"t": sds((B, 1))})["t"]
        ci_sh = vec if slots else NamedSharding(mesh, P())
        jdec = jax.jit(dec, in_shardings=(p_sh, c_sh, t_sh, ci_sh) + ((vec,) if slots else ()))
    logits, cache = jpre(params, batch, *extra)
    out = [np.asarray(logits)]
    for i in range(steps):
        if mesh is not None:              # the decode step's cache placement
            cache = jax.device_put(cache, c_sh)
        t = jnp.asarray(inp["teacher"][:, i:i + 1])
        if slots:
            lg, cache = jdec(params, cache, t, jnp.asarray(inp["positions"][i]),
                             jnp.asarray(inp["masks"][i]))
        else:
            lg, cache = jdec(params, cache, t, jnp.int32(S + i))
        out.append(np.asarray(lg))
    return out, jax.device_get(cache)


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
        for name, m in (("sharded", mesh), ("one", None)):
            logits, cache = run(job, cfg, params, inp, m, par)
            np.savez(os.path.join(d, f"{name}.npz"),
                     **{f"l{i}": x for i, x in enumerate(logits)})
            JT.save(os.path.join(d, f"{name}_cache"), 0, cache)
        with open(os.path.join(d, "DONE"), "w") as f:
            f.write("ok")


if __name__ == "__main__":
    main(sys.argv[1], json.loads(sys.argv[2]))

"""The JAX package's own sharded train step (GSPMD), run as a subprocess for
``tests/test_torch_train_mesh.py``.

    python tests/_torch_jax_gspmd.py OUT_DIR JOBS_JSON

The device count of JAX is fixed when JAX first initialises, and a pytest
worker may already hold a one-device JAX: so this file runs alone, sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu`` before it imports JAX, and builds each mesh directly
(``jax.sharding.Mesh``, whose axes are ``Auto``; ``jax.make_mesh`` gives
``Explicit`` axes, on which the package's ``with_sharding_constraint``
raises).  As ``repro.launch.dryrun.build_cell`` does, it places the state
by ``state_shardings`` and the batch by ``batch_shardings`` and jits the
step under ``set_mesh_ctx``.

Each job (a dict: ``label``, ``arch``, ``shape``, ``axes``, ``par``,
``cfg``, ``steps``) writes to ``OUT_DIR/<label>/``: the train state before
each step and after the last as the package's checkpoints
(``step_{i}.npz``/``.json``), ``metrics.json`` (loss, ce, aux, grad_norm
per step) and ``shards.json`` (per state leaf, each device's index of the
leaf in mesh order).  Each step starts from the state the previous one
returned.  With ``one`` set, beside it the same step on one device
(``jax.jit`` of the unsharded step) from the same state:
``one/step_{i+1}`` and ``one_metrics.json``, so a test can tell a
difference that JAX's own sharding makes (an int8 code that the sharded
reductions round across) from one of the port.
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
import repro.models as JM  # noqa: E402
import repro.train as JT  # noqa: E402
from repro.configs.base import AxPolicy  # noqa: E402
from repro.launch.mesh import batch_shardings, state_shardings, tree_paths  # noqa: E402
from repro.launch.sharding import set_mesh_ctx  # noqa: E402

LR, WARMUP = 3e-3, 2
B, S, FRAMES = 8, 16, 24


def config(arch, cfg_kw):
    kw = dict(cfg_kw)
    ax = kw.pop("ax", None)
    return dataclasses.replace(JC.reduced(JC.ARCHS[arch]), n_layers=2, compute_dtype="float32",
                               ax=AxPolicy(backend=ax) if ax else None, **kw)


def mask_labels(batch):
    """Row r loses its first r labels (-1): the ranks' blocks then hold
    different counts of real labels."""
    labels = np.array(batch["labels"], copy=True)
    for r in range(labels.shape[0]):
        labels[r, :r] = -1
    return dict(batch, labels=labels)


def batches(cfg, steps):
    """The step's global batches: the synthetic stream (seed 1, arith), its
    labels masked (``mask_labels``), and for the encoder-decoder seeded
    f32 frames."""
    stream = JT.SyntheticStream(JT.DataConfig(cfg.vocab, S, B, seed=1, mode="arith"))
    out = []
    for i in range(steps):
        b = mask_labels(stream.next())
        if cfg.family == "encdec":
            rng = np.random.default_rng(100 + i)
            b["frames"] = rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _index(idx):
    return [[s.start or 0, s.stop] if isinstance(s, slice) else s for s in idx]


def run(job, out_dir):
    cfg = config(job["arch"], job.get("cfg", {}))
    par = JC.ParallelConfig(**job["par"])
    shape, axes = tuple(job["shape"]), tuple(job["axes"])
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    opt = JT.AdamWConfig(lr=LR, warmup=WARMUP)
    state = JT.init_train_state(JM.init_params(jax.random.PRNGKey(0), cfg), opt)
    s_sh = state_shardings(mesh, par, state)
    bs = batches(cfg, job["steps"])
    b_sh = batch_shardings(mesh, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                  for k, v in bs[0].items()})
    step = JT.make_train_step(cfg, par, opt)

    def fn(s, b):
        with set_mesh_ctx(mesh, par):
            return step(s, b)

    jfn = jax.jit(fn, in_shardings=(s_sh, b_sh))
    one = jax.jit(JT.make_train_step(cfg, par, opt)) if job.get("one") else None
    state = jax.device_put(state, s_sh)
    paths, leaves, _ = tree_paths(state)
    shards = {}
    for p, leaf in zip(paths, leaves):
        by_dev = {d.id: _index(i) for d, i in leaf.sharding.devices_indices_map(
            leaf.shape).items()}
        shards[p] = [by_dev[d.id] for d in mesh.devices.flat]
    metrics, one_metrics = [], []
    JT.save(out_dir, 0, jax.device_get(state))
    for i, b in enumerate(bs):
        if one is not None:
            s1, m1 = one(jax.device_get(state), {k: jnp.asarray(v) for k, v in b.items()})
            one_metrics.append({k: float(m1[k]) for k in ("loss", "ce", "aux", "grad_norm")})
            JT.save(os.path.join(out_dir, "one"), i + 1, jax.device_get(s1))
        state, m = jfn(state, jax.device_put({k: jnp.asarray(v) for k, v in b.items()}, b_sh))
        metrics.append({k: float(m[k]) for k in ("loss", "ce", "aux", "grad_norm")})
        JT.save(out_dir, i + 1, jax.device_get(state))
    for name, ms in (("metrics.json", metrics), ("one_metrics.json", one_metrics)):
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(ms, f)
    with open(os.path.join(out_dir, "shards.json"), "w") as f:
        json.dump(shards, f)


def main(out_root, jobs):
    assert len(jax.devices()) == 4, jax.devices()
    for job in jobs:
        out_dir = os.path.join(out_root, job["label"])
        os.makedirs(out_dir, exist_ok=True)
        run(job, out_dir)
        with open(os.path.join(out_dir, "DONE"), "w") as f:
            f.write("ok")


if __name__ == "__main__":
    main(sys.argv[1], json.loads(sys.argv[2]))

"""bf16 compute split over ``"model"`` in the port's sharded train step,
beside the JAX package's own GSPMD step in bf16 on the same mesh.

In bf16 each model rank rounds its partial sums to bf16 before they add,
so a step split over ``"model"`` is not its one-device step bit for bit,
and the port's one-device bf16 step is not JAX's either (each rounds in
its own places).  So the split step is held to its own one-device step,
and JAX's GSPMD step to JAX's, by the same bounds: the split moves each
system's step by the same order.  These readings set the bounds that
``chip_smoke.py``'s train wide phase holds qwen2-72b's bf16 layout (e) to.

The reduced qwen2 (2 layers, ``mxu``) on (2, 2) at JAX's default layout
(``fsdp``, ``seq_shard``, ``ep``, ``remat="layer"``), one step from JAX's
initial state on ``_torch_train_mesh_ranks``' global batch of 8 x 16:
JAX's sharded step (``tests/_torch_jax_gspmd.py``, a subprocess) and
JAX's one-device step, the port's step in a spawned ``gloo`` world of 4
ranks and the port's one-device step.  Bounds: loss and ``ce`` within
``RK.TOL_REL``, grad norm within ``TOL_SPLIT`` (``chip_smoke.py``'s
``TOL_TRAIN_STEP_FLIP``), every leaf's first moment (the clipped
gradient) within ``RK.TOL_UPDATE``.  Measured: the port's split step
1.5e-7 (loss), 5.1e-4 (grad norm) and 0.0245 (first moment) from its
one-device step, JAX's 6.1e-5, 6.4e-5 and 0.0296 from JAX's; the port's
split step's loss and grad norm 4.1e-4 and 5.1e-4 from JAX's GSPMD step.

The parameters' update is not held: AdamW's first step is lr times the
gradient's sign, and k's bias, whose exact gradient is zero (a constant
added to every key's score), gets the sign of its rounding, which any two
bf16 steps toss.  That both systems' split steps move it past
``RK.TOL_UPDATE`` is checked.
"""
import json
import os
import tempfile

import numpy as np
import pytest

import _torch_train_mesh_ranks as RK
from repro_torch import train
from repro_torch.configs.base import ParallelConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.launch.mesh import spawn

TOL_SPLIT = 1e-2
JOB = {"label": "qwen2_default_22_bf16", "arch": "qwen2-72b", "shape": [2, 2],
       "axes": ["data", "model"],
       "par": dict(fsdp=True, seq_shard=True, ep=True, remat="layer"),
       "cfg": {"ax": "mxu", "compute_dtype": "bfloat16"}, "steps": 1, "one": True}


def _state(d, step, cfg):
    """(parameters, first moments) of JAX's state ``step`` in ``d``, flat."""
    tree, _ = train.load_tree(d, step)
    st = train_state_from_jax(tree, cfg, device="cpu")
    return RK.flat(st["params"]), RK.flat(st["opt"]["m"])


def _under(flat, prefix):
    return {p[len(prefix):]: v for p, v in flat.items() if p.startswith(prefix)}


@pytest.fixture(scope="module")
def steps():
    """{"port", "port_one", "jax", "jax_one"}: (metrics, parameters, first
    moments) after the step, with "start" (the parameters before it) and
    "replicas" (each rank's ``D.replicas_apart`` after the port's step)."""
    tmp = tempfile.mkdtemp(prefix="train_bf16_")
    root = os.path.join(tmp, "jax")
    proc, log = RK.start_jax(root, [JOB], tmp)
    try:
        four = spawn(RK.jobs_rank, 4, args=([("jax_rank", (root, [JOB]))],), device="cpu",
                     timeout_s=RK.TIMEOUT, threads=1)
        assert proc.wait(timeout=RK.TIMEOUT) == 0, open(log).read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
    d = os.path.join(root, JOB["label"])
    cfg = RK.config(JOB["arch"], JOB["cfg"])
    m, state, start = four[0][0][JOB["label"]]["steps"][0]
    tree, _ = train.load_tree(d, 0)
    one, m1 = train.make_train_step(cfg, ParallelConfig(remat="none"), RK.opt_cfg())(
        train_state_from_jax(tree, cfg, device="cpu"), RK.batches(cfg, 1)[0])
    jm = json.load(open(os.path.join(d, "metrics.json")))[0]
    j1 = json.load(open(os.path.join(d, "one_metrics.json")))[0]
    return dict(port=(m, _under(state, "params/"), _under(state, "opt/m/")),
                port_one=(RK.metrics_of(m1), RK.flat(one["params"]),
                          RK.flat(one["opt"]["m"])),
                jax=(jm,) + _state(d, 1, cfg), jax_one=(j1,) + _state(os.path.join(d, "one"), 1,
                                                                     cfg),
                start=start, replicas=[r[0][JOB["label"]]["replicas"] for r in four])


def _moment_gaps(a, b):
    return {p: float(np.linalg.norm(a[p] - v) / max(np.linalg.norm(v), 1e-30))
            for p, v in b.items()}


@pytest.mark.parametrize("split, one", [("port", "port_one"), ("jax", "jax_one")])
def test_bf16_split_step_stays_near_its_one_device_step(steps, split, one):
    (m, _, mom), (m1, _, mom1) = steps[split], steps[one]
    for k in ("loss", "ce"):
        assert RK.rel(m[k], m1[k]) <= RK.TOL_REL, (k, m[k], m1[k])
    assert RK.rel(m["grad_norm"], m1["grad_norm"]) <= TOL_SPLIT, (m, m1)
    gaps = _moment_gaps(mom, mom1)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= RK.TOL_UPDATE, (worst, gaps[worst])


def test_bf16_split_step_metrics_near_jax_gspmd(steps):
    m, jm = steps["port"][0], steps["jax"][0]
    for k in ("loss", "ce", "grad_norm"):
        assert RK.rel(m[k], jm[k]) <= TOL_SPLIT, (k, m[k], jm[k])


@pytest.mark.parametrize("split, one", [("port", "port_one"), ("jax", "jax_one")])
def test_bf16_split_tosses_the_sign_of_k_bias_update(steps, split, one):
    gaps = RK.update_gaps(steps[split][1], steps[one][1], steps["start"])
    k_bias = {p: g for p, g in gaps.items() if p.endswith("attn/k/b")}
    assert k_bias and max(k_bias.values()) > RK.TOL_UPDATE, k_bias


def test_bf16_split_replicated_leaves_stay_bit_equal_across_ranks(steps):
    for rank, reps in enumerate(steps["replicas"]):
        for apart, checked in reps:
            assert checked > 0 and apart == [], (rank, apart)

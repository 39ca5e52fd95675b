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
JAX's sharded step (``tests/_torch_jax_gspmd.py``, a subprocess, with the
all-reduces of its compiled HLO) and JAX's one-device step, the port's
step in a spawned ``gloo`` world of 4 ranks (with its float sums over
ranks, ``RK.recording_sums``) and the port's one-device step.  Bounds: loss
and ``ce`` within ``RK.TOL_REL``, grad norm within ``TOL_SPLIT``
(``chip_smoke.py``'s ``TOL_TRAIN_STEP_FLIP``), every leaf's first moment
(the clipped gradient) within ``RK.TOL_UPDATE``.  Measured: the port's
split step 1.5e-7 (loss), 1.37e-4 (grad norm) and 0.0238 (first moment)
from its one-device step, JAX's 6.1e-5, 6.4e-5 and 0.0296 from JAX's; the
port's split step's loss and grad norm 4.1e-4 and 1.16e-3 from JAX's GSPMD
step (the two one-device steps are 3.4e-4 and 9.6e-4 apart).

Where the sums over ``"model"`` round.  JAX's compiled step all-reduces
the straight-through input gradient of each column-parallel approximate
projection (the FFN's in and gate) in f32, (B/2, S, D) elements, and
casts the sum to bf16; its only bf16 sum of that size is the head's (bf16
in the partitioned HLO, which XLA's CPU backend promotes to an f32 sum).
The port once cast each rank's part to bf16 and reduce-scattered the
bf16 parts, and read 5.1e-4 in grad norm, eight times JAX's: it now sums
every column-parallel projection's input gradient in f32
(``TensorParallel.input_grad``) and keeps bf16 only for the head's, and
its split moves the grad norm at most ``SPLIT_VS_JAX`` times as far as
JAX's split moves JAX's.

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
SPLIT_VS_JAX = 3
JOB = {"label": "qwen2_default_22_bf16", "arch": "qwen2-72b", "shape": [2, 2],
       "axes": ["data", "model"],
       "par": dict(fsdp=True, seq_shard=True, ep=True, remat="layer"),
       "cfg": {"ax": "mxu", "compute_dtype": "bfloat16"}, "steps": 1, "one": True,
       "hlo": True}


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
    moments) after the step, with "start" (the parameters before it),
    "replicas" (each rank's ``D.replicas_apart`` after the port's step),
    "sums" (rank 0's float sums over ranks) and "hlo" (JAX's compiled
    all-reduces)."""
    tmp = tempfile.mkdtemp(prefix="train_bf16_")
    root = os.path.join(tmp, "jax")
    proc, log = RK.start_jax(root, [JOB], tmp)
    try:
        four = spawn(RK.jobs_rank, 4, args=([("sums_rank", (root, [JOB]))],), device="cpu",
                     timeout_s=RK.TIMEOUT, threads=1)
        assert proc.wait(timeout=RK.TIMEOUT) == 0, open(log).read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
    d = os.path.join(root, JOB["label"])
    cfg = RK.config(JOB["arch"], JOB["cfg"])
    m, state, start = four[0][0][0][JOB["label"]]["steps"][0]
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
                start=start, replicas=[r[0][0][JOB["label"]]["replicas"] for r in four],
                sums=four[0][0][1], hlo=json.load(open(os.path.join(d, "collectives.json"))))


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


def test_bf16_split_sums_input_gradients_in_f32_where_jax_does(steps):
    B, D = 8, 128                                     # the global batch, the reduced width
    resid = (16, B // 2, D)       # a (B/2, S, D) gradient reduce-scattered over seq (dim 0)
    jax_resid = [(o["operands"], o["promoted"]) for o in steps["hlo"]
                 if any(n == [B // 2, 16, D] for _, n in o["operands"])]
    jax_f32 = sum(dt == "f32" and n == [B // 2, 16, D] for ops, promoted in jax_resid
                  if not promoted for dt, n in ops)
    jax_bf16 = sum(n == [B // 2, 16, D] for ops, promoted in jax_resid if promoted
                   for _, n in ops)
    assert jax_f32 >= 2 and jax_bf16 == 1, jax_resid
    back = [(dt, via) for dt, n, via, bwd in steps["sums"] if bwd and n == resid]
    assert all(dt == "float32" for dt, via in back if via), back
    assert sum(via for _, via in back) >= jax_f32, back
    assert [dt for dt, via in back if not via] == ["bfloat16"] * jax_bf16, back


def test_bf16_split_grad_norm_moves_no_further_than_jax_gspmd(steps):
    port = RK.rel(steps["port"][0]["grad_norm"], steps["port_one"][0]["grad_norm"])
    jax_ = RK.rel(steps["jax"][0]["grad_norm"], steps["jax_one"][0]["grad_norm"])
    assert port <= SPLIT_VS_JAX * jax_, (port, jax_)

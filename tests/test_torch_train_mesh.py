"""The port's sharded train step (``train_step.make_train_step(mesh=)``,
``train/distributed.py``) held to the JAX package's own sharded step: JAX's
``make_train_step`` jitted under ``set_mesh_ctx`` on a directly built
``Mesh`` of 4 forced host devices, the state placed by ``state_shardings``
(``tests/_torch_jax_gspmd.py``, a subprocess), and the port's step in
spawned ``gloo`` worlds of 4 and 2 ranks (``tests/_torch_train_mesh_ranks.py``).

Reduced configs at 2 layers, f32 compute, a global batch of 8 x 16 whose
row r has its first r labels masked (the ranks' blocks hold different
label counts), 2 AdamW steps; each port step starts from JAX's state
before it (its blocks under the specs), as ``tests/test_torch_train.py``
holds the one-device step:

* ``qwen2_fsdp4``: qwen2 through the SWAPPER projection (``mxu``),
  ``("data",)`` = 4 with ``dp_only`` + ``fsdp`` (JAX's rules name
  ``"model"`` for heads/ff/vocab, so a ``("data",)`` mesh needs
  ``dp_only``);
* ``qwen2_pod221``: qwen2 on ``("pod", "data", "model")`` = (2, 2, 1),
  two batch axes, ``fsdp`` + ``seq_shard``, ``grad_accum = 2``;
* ``ds_14`` / ``ds_22``: deepseek-moe (``mxu``) on ``("data", "model")`` =
  (1, 4) and (2, 2) with ``dp_only`` + ``ep`` + ``fsdp``, ``remat="layer"``,
  at ``moe_capacity = 1.0``: each token shard's capacity ``C_loc`` = 8
  drops 62-82 choices a rank over the 2 steps, on both sides per shard;
* ``whisper2``: whisper on ``("data",)`` = 2 (``dp_only`` + ``fsdp``).

Bounds (``PERF.md`` §2's train bounds): loss, ``ce``, ``aux`` and grad
norm within ``TOL_REL = 1e-4`` relative, every parameter leaf's update
within ``TOL_UPDATE = 0.1`` of JAX's (|d_port - d_jax| / |d_jax|).
Measured: 1.2e-7 and 2.3e-4 (deepseek), 1.6e-7 and 5.0e-3 (the exact
qwen2 with two batch axes), 2.4e-7 and 1.4e-4 (whisper), 7.7e-8 and
3.5e-3 (``qwen2_fsdp4``'s second step).  One exception, shown rather than
loosened: on ``qwen2_fsdp4``'s first step JAX's sharded step and JAX's
own one-device step from the same state differ by 7.1e-5 in the loss and
1.0e-3 in the grad norm (an int8 code that the sharded reductions round
across); there the port's step equals JAX's one-device step within the
bounds.

Against the port's own one-device step (held to JAX in
``tests/test_torch_train.py``), on 2 ranks: the other seven families one
step each on the exact path (measured 2.1e-7 and 2.7e-5); the adaptive
step, whose aggregated records equal ``combine_records`` of the ranks'
solo records bit for bit and whose controllers agree; ``run_supervised``
with a crash, within 1e-5 of the uninterrupted sharded run.  After every
step of every job each replicated leaf, the AdamW moments included, is
bit-equal on the ranks that hold it.
"""
import os
import tempfile

import numpy as np
import pytest

import _torch_train_mesh_ranks as RK
from repro.runtime.telemetry import combine_records as j_combine
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch.mesh import spawn
from repro_torch.launch.sharding import MeshShape
from repro_torch.runtime.telemetry import combine_records as t_combine
from repro_torch.train.train_step import check_parallel

TIMEOUT = RK.TIMEOUT
TOL_RESTART = 1e-5

JOBS = [
    {"label": "whisper2", "arch": "whisper-base", "shape": [2], "axes": ["data"],
     "par": {"fsdp": True, "dp_only": True, "remat": "none"}, "steps": 2},
    {"label": "qwen2_fsdp4", "arch": "qwen2-72b", "shape": [4], "axes": ["data"],
     "par": {"fsdp": True, "dp_only": True, "remat": "none"}, "cfg": {"ax": "mxu"},
     "steps": 2, "one": True},
    {"label": "qwen2_pod221", "arch": "qwen2-72b", "shape": [2, 2, 1],
     "axes": ["pod", "data", "model"],
     "par": {"fsdp": True, "seq_shard": True, "remat": "none", "grad_accum": 2}, "steps": 2},
    {"label": "ds_14", "arch": "deepseek-moe-16b", "shape": [1, 4], "axes": ["data", "model"],
     "par": {"fsdp": True, "dp_only": True, "ep": True, "remat": "layer"},
     "cfg": {"ax": "mxu", "moe_capacity": 1.0}, "steps": 2},
    {"label": "ds_22", "arch": "deepseek-moe-16b", "shape": [2, 2], "axes": ["data", "model"],
     "par": {"fsdp": True, "dp_only": True, "ep": True, "remat": "layer"},
     "cfg": {"ax": "mxu", "moe_capacity": 1.0}, "steps": 2},
]
LABELS = [j["label"] for j in JOBS]
FOUR = [j for j in JOBS if int(np.prod(j["shape"])) == 4]
TWO = [j for j in JOBS if int(np.prod(j["shape"])) == 2]


def _world(n, jobs):
    return spawn(RK.jobs_rank, n, args=(jobs,), device="cpu", timeout_s=TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def runs():
    """JAX's sharded steps in a subprocess while a 2-rank world runs (its
    whisper job waits for JAX's files), then a 4-rank world."""
    tmp = tempfile.mkdtemp(prefix="train_mesh_")
    jax_root = os.path.join(tmp, "jax")
    proc, log = RK.start_jax(jax_root, JOBS, tmp)
    try:
        two = _world(2, [("jax_rank", (jax_root, TWO)),
                         ("family_rank", (list(RK.FAMILY_MESHES),)),
                         ("adaptive_rank", (0,)), ("adaptive_rank", (2,)),
                         ("supervised_rank", (os.path.join(tmp, "ckpt"),)),
                         ("refusal_rank", ()), ("remat_rank", ())])
        assert proc.wait(timeout=TIMEOUT) == 0, open(log).read()[-3000:]
        four = _world(4, [("gspmd_rank", (jax_root, FOUR))])
    finally:
        if proc.poll() is None:
            proc.kill()
    gspmd = {}
    for rank_results in (two, four):
        for label in rank_results[0][0]:
            gspmd[label] = [r[0][label] for r in rank_results]
    return dict(jax_root=jax_root, gspmd=gspmd, families=two[0][1],
                adaptive={0: [r[2] for r in two], 2: [r[3] for r in two]},
                supervised=two[0][4], refusal=[r[5] for r in two], remat=two[0][6])


def _job(label):
    return next(j for j in JOBS if j["label"] == label)


@pytest.mark.parametrize("label", LABELS)
def test_sharded_step_equals_jax_gspmd(runs, label):
    """Each step's loss, ``ce``, global ``aux``, grad norm and every leaf's
    update against JAX's sharded step on the same mesh shape; ``aux`` is
    JAX's global load-balancing term (deepseek) and the updated state is
    ``gather_state`` of the port's blocks."""
    job = _job(label)
    RK.hold_to_jax(job, os.path.join(runs["jax_root"], label), runs["gspmd"][label][0])


@pytest.mark.parametrize("label", LABELS)
def test_replicated_leaves_stay_bit_equal_across_ranks(runs, label):
    """After each step every leaf whose block several ranks hold (over the
    batch axes, or over ``"model"`` beside the experts), the AdamW moments
    included, is bit-equal on all of them (``D.replicas_apart``)."""
    for rank, r in enumerate(runs["gspmd"][label]):
        for apart, checked in r["replicas"]:
            assert checked > 0 and apart == [], (rank, apart)


@pytest.mark.parametrize("label", ["ds_14", "ds_22"])
def test_per_shard_capacity_drops_tokens_on_every_rank(runs, label):
    """``C_loc`` binds: every rank drops dispatch choices in each step (the
    losses above agree with JAX's per-shard dispatch to 1e-7)."""
    assert all(r["dropped"] > 0 for r in runs["gspmd"][label])


@pytest.mark.parametrize("label", LABELS)
def test_rank_blocks_are_jax_device_shards(runs, label):
    """Each rank's block of every state leaf is the index JAX's
    ``state_shardings`` gives the device at its mesh position (a port
    layer's leaf against JAX's stacked leaf without its layer axis), and
    ``gather_state`` of the blocks of JAX's state is JAX's state bit for
    bit."""
    RK.check_shards(os.path.join(runs["jax_root"], label), runs["gspmd"][label])


@pytest.mark.parametrize("name", list(RK.FAMILY_MESHES))
def test_other_families_sharded_equal_the_one_device_step(runs, name):
    m, m1, new, one, start = runs["families"][name]
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert RK.rel(m[k], m1[k]) <= RK.TOL_REL, (k, m[k], m1[k])
    assert max(RK.update_gaps(new, one, start).values()) <= RK.TOL_UPDATE


@pytest.mark.parametrize("tile_rows", [0, 2])
def test_adaptive_records_equal_combine_records_of_solo_records(runs, tile_rows):
    """Each step's aggregated records (the same on both ranks) equal the
    host combiners (the port's and JAX's) of the ranks' solo records bit
    for bit, and both ranks' controllers hold the same swap triples after
    observing them."""
    ranks = runs["adaptive"][tile_rows]
    for i in range(len(ranks[0])):
        fleet = [r[i][0] for r in ranks]
        solo = [r[i][1] for r in ranks]
        for want in (t_combine(solo), j_combine(solo)):
            assert sorted(want) == sorted(fleet[0])
            for target, rec in want.items():
                for k, v in rec.items():
                    for f in fleet:
                        np.testing.assert_array_equal(f[target][k], v, err_msg=f"{target}/{k}")
                        assert f[target][k].dtype == v.dtype
        for k, v in ranks[0][i][2].items():
            np.testing.assert_array_equal(ranks[1][i][2][k], v)
    assert len(ranks[0][0][0]) == (2 if tile_rows == 0 else 4)


def test_remat_layer_recomputes_the_expert_all_to_all_off_the_step_thread(runs):
    """``remat="layer"`` with ``ep``, its backward (and so each layer's
    recomputed all-to-all and aux all-reduce) on a thread where the step's
    mesh context is not installed, as on the card: the same step as
    ``remat="none"``, bit for bit."""
    out, start = runs["remat"]
    (m, new), (m0, ref) = out["layer"], out["none"]
    assert m == m0
    assert sorted(new) == sorted(ref) == sorted(start)
    for p, v in ref.items():
        np.testing.assert_array_equal(new[p], v, err_msg=p)
    assert all(not np.array_equal(new[p], v) for p, v in start.items() if "experts" in p)


def test_run_supervised_restarts_the_sharded_step(runs):
    ref, log_ref, step_ref = runs["supervised"]["ref"]
    got, log, step = runs["supervised"]["chaos"]
    assert log_ref["restarts"] == 0 and log["restarts"] == 1
    assert step_ref == step == 6 and log["steps_run"] == 6
    for p, v in ref.items():
        np.testing.assert_allclose(got[p], v, rtol=TOL_RESTART, atol=1e-7)


def test_refusals(runs):
    """A ``"model"`` axis with tensor parallelism passes the check (item 8c
    is done: ``tests/test_torch_train_tp.py``); a microbatch that does not
    divide over the batch shards raises; a mesh without ``"model"`` needs
    ``dp_only``; the sharded flags are accepted without a mesh
    (``grad_compress`` read nowhere, as in JAX)."""
    for par in (ParallelConfig(), ParallelConfig(seq_shard=True, fsdp=True)):
        check_parallel(par, mesh=MeshShape(("data", "model"), (2, 2)))
    with pytest.raises(ValueError, match="model"):
        check_parallel(ParallelConfig(), mesh=MeshShape(("data",), (2,)))
    check_parallel(ParallelConfig(dp_only=True), mesh=MeshShape(("data", "model"), (2, 2)))
    check_parallel(ParallelConfig(), mesh=MeshShape(("pod", "data", "model"), (2, 2, 1)))
    for kw in (dict(fsdp=True), dict(seq_shard=True), dict(ep=True), dict(dp_only=True),
               dict(grad_compress="bf16")):
        check_parallel(ParallelConfig(**kw))
    with pytest.raises(ValueError, match="grad_compress"):
        check_parallel(ParallelConfig(grad_compress="int4"))
    assert all(msg and "does not divide over 2 batch shards" in msg for msg in runs["refusal"])

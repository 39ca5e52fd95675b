"""Tensor and sequence parallelism over ``"model"`` in the port's sharded
train step (``train/distributed.py``'s ``TensorParallel``), held to the JAX
package's own GSPMD step on the same meshes without ``dp_only``: JAX's
``make_train_step`` jitted under ``set_mesh_ctx`` on a directly built
``Mesh`` of 4 forced host devices (``tests/_torch_jax_gspmd.py``, a
subprocess), the port's step in spawned ``gloo`` worlds of 4 and 2 ranks
(``tests/_torch_train_mesh_ranks.py``).

Reduced configs at 2 layers, f32 compute, a global batch of 8 x 16 (row r
with its first r labels masked), each port step from JAX's state before
it.  Bounds (``PERF.md`` §2's train bounds, ``RK.TOL_REL`` and
``RK.TOL_UPDATE``): loss, ``ce``, ``aux`` and grad norm within 1e-4
relative, each leaf's update within 0.1 of JAX's.  Where JAX's sharded
step tips an int8 code against its own one-device step from the same state
(the reduced qwen2 through the SWAPPER projection does, Motivation of the
slice), the port is held to the one-device step and the flip is shown:
the port's K-split projection is exact, so its forward is the one-device
forward.  Layouts (``("data", "model")``):

* ``qwen2_default_22``: (2, 2), ``mxu``, JAX's default ``ParallelConfig()``
  (``fsdp``, ``seq_shard``, ``remat="layer"``, ``ep``) with ``grad_accum
  = 2``;
* ``qwen2_kernel_14``: (1, 4), ``kernel`` (the CUDA kernel's plain
  version here), ``seq_shard``;
* ``gemma3_14``: (1, 4), sliding windows, a tied vocab-parallel head, q
  and k/v split inside heads;
* ``ds_ep_22`` / ``ds_14``: deepseek-moe at ``moe_capacity = 1.0`` (each
  token shard's capacity drops choices), (2, 2) with ``ep`` (the rank's
  experts sliced from the replicated dispatch) and (1, 4) without it (the
  experts' ``ff`` split);
* ``ds_default_22``: the same deepseek-moe (``mxu``) at JAX's full default
  layout on (2, 2): ``fsdp``, ``seq_shard``, ``ep`` and ``remat="layer"``
  (token shards across both axes, the expert all-to-all recomputed in the
  backward);
* ``granite_14``: (1, 4) with ``ep`` + ``seq_shard`` (token shards across
  ``"model"``, the expert all-to-all);
* ``rg_22``, ``mamba_22``: the channel-parallel RG-LRU and the SSD parallel
  over heads, (2, 2);
* ``whisper_22``: (2, 2) with ``seq_shard`` on both stacks.

Against the port's own one-device step (held to JAX in
``tests/test_torch_train.py``): starcoder2, qwen1.5 and qwen2-vl on (1, 2),
and deepseek-moe with ``seq_shard`` and no ``ep`` (its experts' ``ff``
split over token shards that span ``"model"``) at a capacity that drops
nothing.
Beside them, on 2 and 4 ranks: the K-split SWAPPER projection bit for bit
against one rank (every backend, static and ``dyn``, route C, under
``seq_shard``'s reduce-scatter, with the records); the adaptive step,
whose aggregated records equal ``combine_records`` of each batch shard's
one-rank records; ``remat="layer"`` with the backward on another thread;
``run_supervised`` with a crash; the sequence that does not divide.
After every step of every job, each leaf whose block several ranks hold
(parameters and AdamW moments alike) is bit-equal on them
(``train.distributed.replicas_apart``), and that check finds one ulp moved
on one rank.
"""
import json
import os
import tempfile

import numpy as np
import pytest

import _torch_train_mesh_ranks as RK
from repro.runtime.telemetry import combine_records as j_combine
from repro_torch.launch.mesh import spawn
from repro_torch.runtime.telemetry import combine_records as t_combine

TOL_RESTART = 1e-5


def _par(**kw):
    """Every flag given, so JAX's and the port's ``ParallelConfig`` (whose
    defaults differ) read the same layout."""
    return dict(dict(fsdp=False, seq_shard=False, ep=False, remat="none"), **kw)


MOE = {"ax": "mxu", "moe_capacity": 1.0}
JOBS = [
    {"label": "qwen2_default_22", "arch": "qwen2-72b", "shape": [2, 2],
     "par": _par(fsdp=True, seq_shard=True, ep=True, remat="layer", grad_accum=2),
     "cfg": {"ax": "mxu"}, "steps": 1, "one": True},
    {"label": "qwen2_kernel_14", "arch": "qwen2-72b", "shape": [1, 4],
     "par": _par(seq_shard=True), "cfg": {"ax": "kernel"}, "steps": 1, "one": True},
    {"label": "gemma3_14", "arch": "gemma3-27b", "shape": [1, 4], "par": _par(), "steps": 1},
    {"label": "ds_ep_22", "arch": "deepseek-moe-16b", "shape": [2, 2], "par": _par(ep=True),
     "cfg": MOE, "steps": 1},
    {"label": "ds_14", "arch": "deepseek-moe-16b", "shape": [1, 4], "par": _par(fsdp=True),
     "cfg": MOE, "steps": 1, "one": True},
    {"label": "ds_default_22", "arch": "deepseek-moe-16b", "shape": [2, 2],
     "par": _par(fsdp=True, seq_shard=True, ep=True, remat="layer"), "cfg": MOE, "steps": 1},
    {"label": "granite_14", "arch": "granite-moe-1b-a400m", "shape": [1, 4],
     "par": _par(ep=True, seq_shard=True), "cfg": {"moe_capacity": 1.0}, "steps": 1},
    {"label": "rg_22", "arch": "recurrentgemma-2b", "shape": [2, 2], "par": _par(),
     "steps": 1},
    {"label": "mamba_22", "arch": "mamba2-370m", "shape": [2, 2], "par": _par(fsdp=True),
     "steps": 1},
    {"label": "whisper_22", "arch": "whisper-base", "shape": [2, 2],
     "par": _par(seq_shard=True), "steps": 1},
]
for _j in JOBS:
    _j["axes"] = ["data", "model"]
LABELS = [j["label"] for j in JOBS]


def _world(n, jobs):
    return spawn(RK.jobs_rank, n, args=(jobs,), device="cpu", timeout_s=RK.TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def runs():
    """JAX's sharded steps in two subprocesses (every other job each) while
    a 2-rank world runs the port-only checks, then a 4-rank world whose
    port-only checks run before it takes each JAX job as its files
    appear."""
    tmp = tempfile.mkdtemp(prefix="train_tp_")
    jax_root = os.path.join(tmp, "jax")
    procs = [RK.start_jax(jax_root, JOBS[i::2], tmp, f"jax{i}.log") for i in (0, 1)]
    try:
        two = _world(2, [("ksplit_rank", (2,)),
                         ("family_rank", (list(RK.FAMILY_TP_MESHES), "FAMILY_TP_MESHES")),
                         ("tp_remat_rank", ()),
                         ("tp_supervised_rank", (os.path.join(tmp, "ckpt"),)),
                         ("tp_refusal_rank", ())])
        four = _world(4, [("ksplit_rank", (4,)), ("tp_adaptive_rank", (0, False)),
                          ("tp_adaptive_rank", (2, True)), ("jax_rank", (jax_root, JOBS)),
                          ("replica_rank", ())])
        for proc, log in procs:
            assert proc.wait(timeout=RK.TIMEOUT) == 0, open(log).read()[-3000:]
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
    return dict(jax_root=jax_root, gspmd={lb: [r[3][lb] for r in four] for lb in LABELS},
                ksplit={2: two[0][0], 4: four[0][0]}, families=two[0][1],
                remat=two[0][2], supervised=two[0][3], refusal=[r[4] for r in two],
                adaptive={0: [r[1] for r in four], 2: [r[2] for r in four]},
                replica=[r[4] for r in four])


def _job(label):
    return next(j for j in JOBS if j["label"] == label)


@pytest.mark.parametrize("label", LABELS)
def test_tp_step_equals_jax_gspmd(runs, label):
    """Each step's metrics and every leaf's update against JAX's sharded
    step on the same mesh, or, where JAX's sharding tips a code, against
    JAX's one-device step (``RK.hold_to_jax``)."""
    RK.hold_to_jax(_job(label), os.path.join(runs["jax_root"], label),
                   runs["gspmd"][label][0])


@pytest.mark.parametrize("label", [j["label"] for j in JOBS if j.get("one")])
def test_jax_sharding_flips_a_code_where_the_port_does_not(runs, label):
    """On the reduced qwen2 through the SWAPPER projection JAX's GSPMD step
    and JAX's one-device step from the same state disagree past the bounds
    on the first step (an int8 code that JAX's sharded reductions round
    across); the port's step, whose K-split projection is exact, meets the
    bounds against the one-device step."""
    d = os.path.join(runs["jax_root"], label)
    job = _job(label)
    cfg = RK.config(job["arch"], job["cfg"])
    m, params, start = runs["gspmd"][label][0]["steps"][0]
    new = {p[len("params/"):]: v for p, v in params.items() if p.startswith("params/")}
    jm = json.load(open(os.path.join(d, "metrics.json")))[0]
    j1 = json.load(open(os.path.join(d, "one_metrics.json")))[0]
    one = RK.jax_params(os.path.join(d, "one"), 1, cfg)
    _, _, jax_ok = RK.within(jm, j1, RK.jax_params(d, 1, cfg), one, start)
    gaps, upd, ok = RK.within(m, j1, new, one, start)
    assert not jax_ok
    assert ok, (gaps, upd)


@pytest.mark.parametrize("label", LABELS)
def test_tp_rank_blocks_are_jax_device_shards(runs, label):
    RK.check_shards(os.path.join(runs["jax_root"], label), runs["gspmd"][label])


@pytest.mark.parametrize("label", LABELS)
def test_tp_replicated_leaves_stay_bit_equal_across_ranks(runs, label):
    """After each step every leaf whose block several ranks hold, the AdamW
    moments included, is bit-equal on all of them: the gradient buckets and
    the grad norm are plain all-reduces, whose ranks receive the same
    bits."""
    for rank, r in enumerate(runs["gspmd"][label]):
        for apart, checked in r["replicas"]:
            assert checked > 0 and apart == [], (rank, apart)


def test_replicas_apart_finds_one_ulp_on_one_rank(runs):
    """One element of two replicated leaves moved on rank 1 of (2, 2): the
    leaf held whole by every rank is reported on all four, the leaf sharded
    over ``"model"`` only on the ranks of rank 1's model block (1 and 3);
    before the move nothing is."""
    whole, on_model = runs["replica"][0][2]
    for rank, (clean, moved, _) in enumerate(runs["replica"]):
        assert clean[0] == [] and clean[1] > 0
        assert moved[1] == clean[1]
        assert sorted(moved[0]) == sorted([whole, on_model] if rank % 2 else [whole]), \
            (rank, moved[0])


@pytest.mark.parametrize("label", ["ds_ep_22", "ds_14", "granite_14", "ds_default_22"])
def test_tp_moe_capacity_drops_tokens_on_every_rank(runs, label):
    """Each token shard's ``C_loc`` binds on every rank (the steps above
    agree with JAX's per-shard dispatch)."""
    assert all(r["dropped"] > 0 for r in runs["gspmd"][label])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("label", [p[0] for p in RK.KSPLIT_POLICIES])
def test_k_split_projection_is_the_one_rank_projection(runs, n, seq, label):
    """Row-parallel (K split, the int32 partial sums all-reduced, or
    reduce-scattered over ``seq``) and column-parallel projections equal
    the one-rank projection bit for bit, static, with a triple and with a
    row-tile grid (the kernel's tile histogram summed over the K blocks);
    their adaptive records equal the one-rank records bit for bit; the
    straight-through gradients agree to f32 rounding; the weight cache's
    codes of a K block carry the whole K's column scales."""
    assert runs["ksplit"][n]["codes"]
    for mode in ("static", "triple", "grid"):
        r = runs["ksplit"][n][(seq, label, mode)]
        assert r["row"] and r["col"] and r["records"], (mode, r)
        assert r["n_records"] == {"static": 0, "triple": 1, "grid": 2}[mode]
        assert r["grad_gap"] < 1e-4, (mode, r)


@pytest.mark.parametrize("name", list(RK.FAMILY_TP_MESHES))
def test_other_families_tp_equal_the_one_device_step(runs, name):
    m, m1, new, one, start = runs["families"][name]
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert RK.rel(m[k], m1[k]) <= RK.TOL_REL, (k, m[k], m1[k])
    assert max(RK.update_gaps(new, one, start).values()) <= RK.TOL_UPDATE


@pytest.mark.parametrize("tile_rows", [0, 2])
def test_tp_adaptive_records_equal_combine_records_of_the_batch_shards(runs, tile_rows):
    """(2, 2) with tensor parallelism (``seq_shard`` in tile mode): every
    rank's aggregated records equal the host combiners (the port's and
    JAX's) of the two batch shards' one-rank records bit for bit, and every
    rank's controller holds the same swap triples."""
    ranks = runs["adaptive"][tile_rows]
    for i in range(len(ranks[0])):
        fleet = [r[i][0] for r in ranks]
        solo = [ranks[0][i][1], ranks[2][i][1]]          # batch shards 0 and 1
        assert RK.same_records(ranks[0][i][1], ranks[1][i][1])
        for want in (t_combine(solo), j_combine(solo)):
            for f in fleet:
                assert RK.same_records(want, f)
        for r in ranks[1:]:
            for k, v in ranks[0][i][2].items():
                np.testing.assert_array_equal(r[i][2][k], v)
    assert len(ranks[0][0][0]) == (2 if tile_rows == 0 else 4)


def test_tp_remat_layer_recomputes_the_collectives_off_the_step_thread(runs):
    """``remat="layer"`` under tensor and sequence parallelism with ``ep``,
    its backward on a thread where the step's mesh context is not
    installed: the same step as ``remat="none"``, bit for bit."""
    out, start = runs["remat"]
    (m, new), (m0, ref) = out["layer"], out["none"]
    assert m == m0
    assert sorted(new) == sorted(ref) == sorted(start)
    for p, v in ref.items():
        np.testing.assert_array_equal(new[p], v, err_msg=p)
    assert all(not np.array_equal(new[p], v) for p, v in start.items() if "experts" in p)


def test_tp_run_supervised_restarts_onto_the_tp_blocks(runs):
    ref, log_ref, step_ref = runs["supervised"]["ref"]
    got, log, step = runs["supervised"]["chaos"]
    assert log_ref["restarts"] == 0 and log["restarts"] == 1
    assert step_ref == step == 6 and log["steps_run"] == 6
    for p, v in ref.items():
        np.testing.assert_allclose(got[p], v, rtol=TOL_RESTART, atol=1e-7)


def test_tp_seq_shard_needs_a_dividing_sequence(runs):
    assert all(msg and "does not divide over 2 model ranks" in msg for msg in runs["refusal"])

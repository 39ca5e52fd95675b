"""The port's device meshes and what runs on them besides the serve
(``launch/mesh.py``, ``fleet/collect.py``'s mesh helpers, per-shard MoE
capacity in ``models/blocks.py``, ``train/checkpoint.py``'s
``restore(sharding_tree=)`` and ``gather_state``, the elastic
``run_supervised``), in real ``gloo`` worlds on the CPU.

* Spawned worlds (``launch.mesh.spawn``): the fleet mesh each rank sees
  (axis names, shape, its index, the backend), an aggregate of each
  telemetry field class, ``make_sharded_summarizer(mesh=)`` in tile mode
  equal to the host combiner (the port's and JAX's) of the ranks' own
  summaries; a rank that raises fails the world with its
  traceback, and a world past its timeout is killed.
* MoE on 2 ranks, reduced deepseek in f32 with JAX's own initial weights:
  under the mesh context each rank's ``moe_apply`` of its token shard
  equals the JAX package's ``_dispatch`` at ``C_loc`` on that shard's
  tokens, composed as ``moe_apply``'s distributed path composes it
  (routing, expert FFN, the local combine), within ``TOL = 1e-5`` (the
  tolerance of ``tests/test_torch_blocks.py``); with a binding capacity
  this differs from the global-capacity path on all the tokens.
* ``restore(sharding_tree=)`` of a one-process train state onto 2 ranks
  (``state_shardings`` with ``dp_only`` + ``fsdp``: each rank gets its
  block of every sharded leaf, the whole of the rest) and
  ``gather_state`` back, bit for bit; ``run_supervised`` resuming a
  one-process checkpoint on 2 ranks through a crash gives each rank its
  block of the one-process run, and its gathered checkpoints the whole.
* The train step's sharded settings still raise (ROADMAP item 8b).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_ranks as RK
import repro.configs as JC
from repro.runtime.telemetry import combine_records as j_combine
from repro.models import blocks as JB
from repro_torch import train
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch.mesh import spawn, tree_paths
from repro_torch.runtime.telemetry import combine_records as t_combine
from repro_torch.train.train_step import check_parallel

TOL = 1e-5
TIMEOUT = 180


def _world(fn, n, *args, timeout=TIMEOUT):
    return spawn(fn, n, args=args, device="cpu", timeout_s=timeout, threads=1)


def _equal_records(got, want):
    assert set(got) == set(want)
    for t in want:
        for k, v in want[t].items():
            assert got[t][k].dtype == v.dtype, (t, k)
            np.testing.assert_array_equal(got[t][k], v, err_msg=f"{t}.{k}")


def _moe_inputs():
    kw = dict(compute_dtype="float32", moe_capacity=1.0)
    jc = dataclasses.replace(JC.reduced(JC.ARCHS["deepseek-moe-16b"]), **kw)
    jp = JB.moe_init(jax.random.PRNGKey(0), jc, jnp.float32)
    # a router skewed towards expert 0: per-shard capacities bind
    jp["router"]["w"] = jp["router"]["w"].at[:, 0].add(0.3)
    x = np.random.default_rng(1).standard_normal((4, 16, jc.d_model)).astype(np.float32)
    return kw, jc, jp, x


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One 2-rank world for the mesh, MoE, restore and elastic checks: their
    inputs are made here first (module note)."""
    root = tmp_path_factory.mktemp("mesh")
    kw, jc, jp, x = _moe_inputs()
    # a one-process train state at step 7
    state = train.fresh_train_state(RK.qwen_cfg(), train.AdamWConfig(), device="cpu", seed=3)
    state["opt"]["step"] += 7
    train.save(str(root / "state"), 7, state, extra={"train_step": 7})
    # one process writes steps 2 and 4 of the toy run; the reference runs 8
    ckpt = str(root / "ck")
    train.run_supervised(RK.toy_state, RK.toy_step, RK.CountStream(), 4,
                         train.FaultConfig(ckpt_dir=ckpt, ckpt_every=2))
    ref, _ = train.run_supervised(RK.toy_state, RK.toy_step, RK.CountStream(), 8,
                                  train.FaultConfig(ckpt_dir=str(root / "ref"),
                                                    ckpt_every=100))
    res = _world(RK.jobs_rank, 2, [
        ("mesh_rank", ()),
        ("moe_rank", (jax.tree.map(np.asarray, jax.device_get(jp)), x, kw)),
        ("restore_rank", (str(root / "state"), 7)),
        ("elastic_rank", (ckpt, 8, 5))])
    return dict(mesh=[r[0] for r in res], moe=[r[1] for r in res],
                restore=[r[2] for r in res], elastic=[r[3] for r in res],
                inputs=dict(jc=jc, jp=jp, x=x, state=state, ckpt=ckpt, ref=ref))


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_sees_the_fleet_mesh_and_the_aggregates(n, world2):
    res = world2["mesh"] if n == 2 else _world(RK.mesh_rank, n)
    want = t_combine([r[7] for r in res])                   # the ranks' own summaries
    _equal_records(want, j_combine([r[7] for r in res]))
    for rank, (names, shape, index, size, backend, agg, fleet, _) in enumerate(res):
        assert names == ("data",) and shape == (n,) and index == rank and size == n
        assert backend == "gloo"
        assert agg["n"] == [n * (n + 1) // 2]                 # all-reduce SUM
        assert agg["err_max"] == [10 * (n - 1)]                # all-reduce MAX
        assert agg["a_smp"] == [[r] * 3 for r in range(n)]     # all-gather, rank order
        _equal_records(fleet, want)       # make_sharded_summarizer(mesh=), tile mode


def test_a_failing_rank_fails_the_world_and_a_hung_one_is_killed():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        _world(RK.fail_rank, 2, timeout=60)
    with pytest.raises(TimeoutError, match="did not finish"):
        _world(RK.sleep_rank, 2, 60.0, timeout=2)


# ---------------------------------------------------------------------------
# MoE capacity per token shard
# ---------------------------------------------------------------------------

def _jax_shard_moe(jp, x, jc):
    """JAX's distributed MoE on one token shard: ``_dispatch`` at ``C_loc``,
    the expert FFN, the local combine, plus the shared experts."""
    from repro.models.layers import mlp_apply

    Bl, S, D = x.shape
    E, k = jc.n_experts, jc.top_k
    flat = jnp.asarray(x.reshape(-1, D))
    T_loc = flat.shape[0]
    probs = jax.nn.softmax(flat @ jp["router"]["w"], axis=-1)
    topv, topi = jax.lax.top_k(probs, k)
    topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    C_loc = min(max(int(np.ceil(T_loc * k / E * jc.moe_capacity)), 8), T_loc)
    buf, slots, keeps = JB._dispatch(flat, topi, k, E, C_loc, jnp.float32)
    ex = jp["experts"]
    h = jnp.einsum("ecd,edf->ecf", buf, ex["in"]["w"])
    g = jnp.einsum("ecd,edf->ecf", buf, ex["gate"]["w"])
    y = jnp.einsum("ecf,efd->ecd", jax.nn.silu(g) * h, ex["out"]["w"]).reshape(E * C_loc, D)
    out = jnp.zeros((T_loc, D), jnp.float32)
    for j in range(k):
        idx = topi[:, j].astype(jnp.int32) * C_loc + slots[:, j]
        w = topv[:, j] * keeps[:, j].astype(jnp.float32)
        out = out + jnp.take(y, idx, axis=0) * w[:, None]
    if "shared" in jp:
        out = out + mlp_apply(jp["shared"], flat, "silu", jc.ax).reshape(T_loc, D)
    return np.asarray(out).reshape(Bl, S, D), C_loc, int((~np.asarray(keeps)).sum())


def test_moe_capacity_per_token_shard_equals_jax_dispatch_at_c_loc(world2):
    inp = world2["inputs"]
    jc, jp, x = inp["jc"], inp["jp"], inp["x"]
    drops = 0
    for rank, (shards, outside, y, y_global) in enumerate(world2["moe"]):
        assert shards == 2 and outside is None
        want, C_loc, dropped = _jax_shard_moe(jp, x[RK.block(rank, 2, 4)], jc)
        drops += dropped
        assert C_loc < min(max(int(np.ceil(64 * jc.top_k / jc.n_experts)), 8), 64)
        assert np.abs(y - want).max() <= TOL, np.abs(y - want).max()
        assert np.abs(y - y_global).max() > 1e-3     # not the global-capacity path
    assert drops > 0


# ---------------------------------------------------------------------------
# checkpoints onto a mesh, the elastic resume
# ---------------------------------------------------------------------------

def test_restore_onto_two_ranks_and_gather_back(world2):
    state = world2["inputs"]["state"]
    whole = {p: v.float().numpy() for p, v in zip(*tree_paths(state))}
    for rank, (local, back, n_sharded, extra) in enumerate(world2["restore"]):
        assert extra == {"train_step": 7} and n_sharded > 0
        split = 0
        for p, v in whole.items():
            np.testing.assert_array_equal(back[p], v, err_msg=p)
            if local[p].shape != v.shape:               # sharded over 'data'
                d = next(i for i, (a, b) in enumerate(zip(local[p].shape, v.shape)) if a != b)
                k = v.shape[d] // 2
                np.testing.assert_array_equal(
                    local[p], np.take(v, range(rank * k, (rank + 1) * k), axis=d))
                split += 1
            else:
                np.testing.assert_array_equal(local[p], v)
        assert split == n_sharded


def test_run_supervised_resumes_a_one_process_checkpoint_on_two_ranks(world2):
    """Steps 2 and 4 written by one process; the 2-rank run resumes at 4,
    crashes before step 5, resumes again and writes 6 and 8 gathered."""
    ckpt, ref = world2["inputs"]["ckpt"], world2["inputs"]["ref"]
    for rank, (state, log) in enumerate(world2["elastic"]):
        assert log["restarts"] == 1 and log["steps_run"] == 8
        np.testing.assert_array_equal(state["w"], ref["w"][RK.block(rank, 2, 8)].numpy())
        np.testing.assert_array_equal(state["b"], ref["b"].numpy())
    assert train.latest_step(ckpt) == 8
    saved, extra = train.restore(ckpt, 8, RK.toy_state(), device="cpu")
    assert extra["train_step"] == 8
    for k in ("w", "b"):
        np.testing.assert_array_equal(saved[k].numpy(), ref[k].numpy())


@pytest.mark.parametrize("flag", ["fsdp", "seq_shard", "ep", "dp_only", "grad_compress"])
def test_the_sharded_train_step_still_raises_item_8b(flag):
    par = ParallelConfig(**({flag: "bf16"} if flag == "grad_compress" else {flag: True}))
    with pytest.raises(NotImplementedError, match="item 8b"):
        check_parallel(par)
